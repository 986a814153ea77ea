"""Launcher for the hand-written CUDA flash-attention backward
(``csrc/flash_attention_bwd.cu``), the port of the recompute VJP the JAX
package trains through (``repro/models/attention.py::_flash_fn``'s
``f_bwd``, jnp and not a Pallas kernel).

``flash_attention_bwd(q, k, v, out, lse, d_out)`` takes what the forward
(``flash_attention_gqa(..., return_lse=True)``) saved: q (B, Sq, KV, G,
dqk), k (B, Sk, KV, dqk), v (B, Sk, KV, dv), out and d_out (B, Sq, KV, G,
dv), all of one type (fp32, fp16 or bf16), and lse (B, KV, G, Sq) fp32;
it returns (dq, dk, dv) in the inputs' type.  Two launches per call: dq
(and delta = rowsum(d_out * out), into a fp32 workspace), then dk / dv,
with GQA's sum over the G query heads done inside the second kernel's
blocks.  Masks and the (dqk, dv) pairs are the forward's
(``flash_attention.HEAD_DIMS``).  Every query row must see at least one
key (true of every causal or windowed training call); a call where a
windowed row sees none raises.

CUDA tensors only; ``kernels/ops.py`` dispatches by device and counts
launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.kernels.flash_decode import check_cuda

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    fn = build.library("flash_attention_bwd").repro_flash_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 10 + [_I] * 10 + [ctypes.c_float, _I, _P]
        fn.restype = _I
    return fn


def flash_attention_bwd(q, k, v, out, lse, d_out, *, causal: bool = True,
                        window: Optional[int] = None, q_offset: int = 0):
    """(dq, dk, dv) of the grouped prefill attention from its saved
    tensors."""
    tag = check_cuda("flash_attention_bwd", q, k, v, out, d_out)
    b, sq, kv, g, dqk = q.shape
    sk, dv = k.shape[1], v.shape[-1]
    if (k.shape != (b, sk, kv, dqk) or v.shape != (b, sk, kv, dv)
            or out.shape != (b, sq, kv, g, dv) or d_out.shape != out.shape):
        raise ValueError(f"flash_attention_bwd: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, out "
                         f"{tuple(out.shape)}, d_out {tuple(d_out.shape)} "
                         f"do not match")
    if (lse.device != q.device or lse.dtype != torch.float32
            or lse.shape != (b, kv, g, sq) or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse must be a contiguous "
                         f"float32 (B, KV, G, Sq) = {(b, kv, g, sq)} tensor "
                         f"on {q.device}, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")
    if (dqk, dv) not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: (q/k, v) head dims "
                         f"{(dqk, dv)} not in {HEAD_DIMS}")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention_bwd: window must be positive, "
                         f"got {window}")
    if sq and sk == 0:
        raise ValueError("flash_attention_bwd: no keys")
    if window is not None and q_offset + sq - window >= sk:
        raise ValueError(f"flash_attention_bwd: with window {window} a "
                         f"query row sees none of the {sk} keys")
    dq, dk, dvv = (torch.empty_like(t) for t in (q, k, v))
    if sq == 0:
        return dq, dk.zero_(), dvv.zero_()
    delta = torch.empty((b, kv, g, sq), device=q.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 d_out.data_ptr(), lse.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dvv.data_ptr(), delta.data_ptr(), b, sq, sk,
                 kv, g, dqk, dv, int(causal), int(window or 0),
                 int(q_offset), 1.0 / (dqk ** 0.5), tag, stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {err}")
    return dq, dk, dvv
