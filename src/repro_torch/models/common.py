"""Shared building blocks: norms, rotary embeddings, MLPs, initializers.

PyTorch port of ``repro/models/common.py`` (dense-family subset).  The
per-layer math is plain functions on tensors with the weights passed in,
because PIPELOAD streams each layer's weights in and destroys them.
Weights keep the reference's ``(in, out)`` layout (``x @ W``).

Initialisers draw from an explicit ``numpy.random.Generator`` and return
numpy arrays: a checkpoint written from a seed is the same bytes on any
machine, with or without a GPU.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Initialisation helpers.  Param trees are plain nested dicts of arrays.
# ---------------------------------------------------------------------------
def dense_init(rng: np.random.Generator, in_dim: int, out_dim: int,
               dtype) -> np.ndarray:
    scale = np.float32(1.0 / math.sqrt(in_dim))
    w = rng.standard_normal((in_dim, out_dim), dtype=np.float32)
    w *= scale
    return w.astype(dtype, copy=False)


def embed_init(rng: np.random.Generator, vocab: int, dim: int,
               dtype) -> np.ndarray:
    w = rng.standard_normal((vocab, dim), dtype=np.float32)
    w *= np.float32(0.02)
    return w.astype(dtype, copy=False)


def mlp_init(rng: np.random.Generator, d_model: int, d_ff: int, dtype,
             gated: bool = True) -> dict:
    p = {"w_up": dense_init(rng, d_model, d_ff, dtype),
         "w_down": dense_init(rng, d_ff, d_model, dtype)}
    if gated:
        p["w_gate"] = dense_init(rng, d_model, d_ff, dtype)
    return p


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


# ---------------------------------------------------------------------------
# MLP (SwiGLU when gated, else GELU)
# ---------------------------------------------------------------------------
def mlp_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    if "w_gate" in params:
        gate = F.silu(x @ params["w_gate"])
        return (gate * (x @ params["w_up"])) @ params["w_down"]
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x @ params["w_up"], approximate="tanh") @ params["w_down"]
