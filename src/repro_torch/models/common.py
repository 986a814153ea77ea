"""Shared building blocks: norms, rotary embeddings, MLPs, initializers.

PyTorch port of ``repro/models/common.py`` (dense-family subset, with
the VLM's M-RoPE and the training loss's chunked cross-entropy).  The
per-layer math is plain functions on tensors with the weights passed in,
because PIPELOAD streams each layer's weights in and destroys them.
Weights keep the reference's ``(in, out)`` layout (``x @ W``).

Initialisers draw from an explicit ``numpy.random.Generator`` and return
numpy arrays: a checkpoint written from a seed is the same bytes on any
machine, with or without a GPU.  As in the reference, they draw fp32 and
cast to the config's dtype; numpy has no bfloat16, so a bfloat16 leaf is
the fp32 draw rounded to nearest even and kept as its 2-byte void bytes
(``checkpoint.quant.BF16``), which shards and ``from_jax_params`` take.

Every weight product goes through ``linear``: a plain weight is ``x @ w``;
a quantized one (``checkpoint/quant.QuantizedTensor``, from an int8/int4
shard) runs the dequantizing matmul kernel, so no fp32 copy of the weight
is built.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.checkpoint.quant import BF16, QuantizedTensor, narrow_bf16
from repro_torch.kernels import ops, ref

KERNEL = "cuda"   # impl value selecting the hand-written kernels


# ---------------------------------------------------------------------------
# Initialisation helpers.  Param trees are plain nested dicts of arrays.
# ---------------------------------------------------------------------------
def np_dtype(dtype) -> np.dtype:
    """The numpy form of a leaf dtype: bfloat16 as ``BF16``."""
    return BF16 if str(dtype) == "bfloat16" else np.dtype(dtype)


def cast(a: np.ndarray, dtype) -> np.ndarray:
    """An fp32 array in ``dtype``, as the reference's ``.astype(dtype)``
    (bfloat16: rounded to nearest even, as ``BF16`` bytes)."""
    if np_dtype(dtype) == BF16:
        return narrow_bf16(a)
    return a.astype(dtype, copy=False)


def ones(shape, dtype) -> np.ndarray:
    return cast(np.ones(shape, np.float32), dtype)


def zeros(shape, dtype) -> np.ndarray:
    return cast(np.zeros(shape, np.float32), dtype)


def dense_init(rng: np.random.Generator, in_dim: int, out_dim: int,
               dtype) -> np.ndarray:
    scale = np.float32(1.0 / math.sqrt(in_dim))
    w = rng.standard_normal((in_dim, out_dim), dtype=np.float32)
    w *= scale
    return cast(w, dtype)


def embed_init(rng: np.random.Generator, vocab: int, dim: int,
               dtype) -> np.ndarray:
    w = rng.standard_normal((vocab, dim), dtype=np.float32)
    w *= np.float32(0.02)
    return cast(w, dtype)


def mlp_init(rng: np.random.Generator, d_model: int, d_ff: int, dtype,
             gated: bool = True) -> dict:
    p = {"w_up": dense_init(rng, d_model, d_ff, dtype),
         "w_down": dense_init(rng, d_ff, d_model, dtype)}
    if gated:
        p["w_gate"] = dense_init(rng, d_model, d_ff, dtype)
    return p


# ---------------------------------------------------------------------------
# Linear layers
# ---------------------------------------------------------------------------
def linear(x: torch.Tensor, w, impl: Optional[str] = None) -> torch.Tensor:
    """``x (..., K) @ w (K, N)``.  A ``QuantizedTensor`` weight flattens x
    to (M, K) and takes ``ops.quant_matmul`` with ``impl=KERNEL`` (the
    kernel on the card, its plain version on the CPU) or the plain
    version with ``impl=None``, as the attention functions do."""
    if not isinstance(w, QuantizedTensor):
        return x @ w
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if impl == KERNEL:
        out = ops.quant_matmul(x2, w.q, w.scale, w.bits)
    else:
        out = ref.quant_matmul_ref(x2, w.q, w.scale, bits=w.bits)
    return out.reshape(tuple(x.shape[:-1]) + (out.shape[-1],))


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """Inverse frequencies for the rotary half of ``head_dim``."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to
    (..., seq)."""
    inv = rope_freqs(x.shape[-1], theta, x.device)         # (half,)
    ang = positions[..., None].float() * inv               # (..., seq, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                sections: Sequence[int], theta: float) -> torch.Tensor:
    """Multimodal rotary (Qwen2-VL).  positions3: (3, ..., seq) t/h/w
    ids.  The rotary half is split into ``sections`` (summing to
    head_dim // 2); each section takes its angle from its stream."""
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, half)
    inv = rope_freqs(x.shape[-1], theta, x.device)         # (half,)
    ang_all = positions3[..., None].float() * inv          # (3, ..., half)
    parts, start = [], 0
    for i, sec in enumerate(sections):
        parts.append(ang_all[i, ..., start:start + sec])
        start += sec
    ang = torch.cat(parts, dim=-1)                         # (..., seq, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU when gated, else GELU)
# ---------------------------------------------------------------------------
def mlp_apply(params: dict, x: torch.Tensor,
              impl: Optional[str] = None) -> torch.Tensor:
    if "w_gate" in params:
        gate = F.silu(linear(x, params["w_gate"], impl))
        return linear(gate * linear(x, params["w_up"], impl),
                      params["w_down"], impl)
    # jax.nn.gelu defaults to the tanh approximation
    return linear(F.gelu(linear(x, params["w_up"], impl), approximate="tanh"),
                  params["w_down"], impl)


# ---------------------------------------------------------------------------
# Chunked cross-entropy (never materialises (B, S, V) at once)
# ---------------------------------------------------------------------------
def _xent_chunk(h: torch.Tensor, lm_head: torch.Tensor,
                y: torch.Tensor) -> torch.Tensor:
    logits = (h @ lm_head).float()                         # (B, s/c, V)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y[..., None].long())[..., 0]
    return torch.sum(lse - gold)


def chunked_softmax_xent(hidden: torch.Tensor, lm_head: torch.Tensor,
                         labels: torch.Tensor,
                         n_chunks: int = 8) -> torch.Tensor:
    """hidden (B, S, D); lm_head (D, V); labels (B, S) -> mean token loss
    (fp32), over the reference's sequence chunks.  While autograd records,
    each chunk runs under ``torch.utils.checkpoint``: the backward
    recomputes the chunk's logits instead of keeping (B, S, V) alive, as
    the reference's ``jax.checkpoint`` does."""
    b, s, _ = hidden.shape
    while s % n_chunks:
        n_chunks //= 2
    c = s // n_chunks
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n_chunks):
        h, y = hidden[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        if torch.is_grad_enabled():
            part = checkpoint(_xent_chunk, h, lm_head, y, use_reentrant=False)
        else:
            part = _xent_chunk(h, lm_head, y)
        total = total + part
    return total / (b * s)
