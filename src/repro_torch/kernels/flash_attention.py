"""Launcher for the hand-written CUDA flash-attention kernel
(``csrc/flash_attention.cu``), the port of the Pallas kernel in
``repro/kernels/flash_attention.py``.

The kernel takes the grouped layout of ``gqa_prefill`` — q (B, Sq, KV, G,
dh), k/v (B, Sk, KV, dh) — and skips key tiles that lie wholly above the
causal diagonal or outside the window.  ``flash_attention`` keeps the
reference's BH-flat signature as a thin view (one head per row).

CUDA tensors only; ``kernels/ops.py`` dispatches by device and counts
launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_decode import check_cuda_f32

HEAD_DIMS = (32, 64, 128)

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    fn = build.library("flash_attention").repro_flash_attention_f32
    if fn.argtypes is None:
        fn.argtypes = [_P] * 4 + [_I] * 9 + [ctypes.c_float, _P]
        fn.restype = _I
    return fn


def flash_attention_gqa(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, q_offset: int = 0):
    """q (B, Sq, KV, G, dh); k, v (B, Sk, KV, dh) -> (B, Sq, KV, G, dh)."""
    check_cuda_f32("flash_attention", q, k, v)
    b, sq, kv, g, dh = q.shape
    sk = k.shape[1]
    if k.shape != (b, sk, kv, dh) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k/v shapes {tuple(k.shape)}, "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {dh} not in "
                         f"{HEAD_DIMS}")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be positive, got "
                         f"{window}")
    out = torch.empty_like(q)
    if sq == 0:
        return out
    if sk == 0:
        raise ValueError("flash_attention: no keys")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, sq, sk, kv, g, dh, int(causal), int(window or 0),
                 int(q_offset), 1.0 / (dh ** 0.5), stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    return out


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None):
    """BH-flat view: q (BH, Sq, dh); k, v (BH, Sk, dh) -> (BH, Sq, dh)."""
    bh, sq, dh = q.shape
    sk = k.shape[1]
    out = flash_attention_gqa(q.view(bh, sq, 1, 1, dh),
                              k.view(bh, sk, 1, dh), v.view(bh, sk, 1, dh),
                              causal=causal, window=window)
    return out.view(bh, sq, dh)
