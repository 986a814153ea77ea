"""Launcher for the hand-written CUDA flash-attention kernel
(``csrc/flash_attention.cu``), the port of the Pallas kernel in
``repro/kernels/flash_attention.py``.

The kernel takes the grouped layout of ``gqa_prefill`` — q (B, Sq, KV, G,
dh), k/v (B, Sk, KV, dh) — and skips key tiles that lie wholly above the
causal diagonal or outside the window.  The v width may differ from the
q / k width at the pairs in ``HEAD_DIMS``: MLA's prefill heads are q / k
96 wide (64 nope + 32 rope) and v 64 wide, read as they are.  Its
products run on the tensor cores (3xTF32 for fp32 inputs); ``block_rows``
plans the query rows per block so the grid reaches the SMs.
``flash_attention`` keeps the reference's BH-flat signature as a thin
view (one head per row).  ``return_lse=True`` also returns each row's
natural log-sum-exp (B, KV, G, Sq) in fp32, the statistic the backward
(``kernels/flash_attention_bwd.py``) recomputes from.  Inputs
are fp32, fp16 or bf16 (one type for q, k and v, 16-byte aligned); the
output is in q's type.

CUDA tensors only; ``kernels/ops.py`` dispatches by device and counts
launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_decode import aligned16, check_cuda

# (q / k width, v width) pairs the kernel is built for
HEAD_DIMS = ((32, 32), (64, 64), (128, 128), (256, 256), (96, 64))
SMS = 132                  # the H100's SMs
# 64-row blocks fill the card once there are this many (128 of the 132
# SMs, one wave); below, 16-row blocks give four times the blocks
FILL_BLOCKS = 128

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    fn = build.library("flash_attention").repro_flash_attention
    if fn.argtypes is None:
        fn.argtypes = [_P] * 5 + [_I] * 11 + [ctypes.c_float, _I, _P]
        fn.restype = _I
    return fn


def block_rows(rows: int, columns: int) -> int:
    """Query rows per block for ``rows`` query rows in each of ``columns``
    (b, head) pairs: 64 (four warps of 16 rows) when those blocks reach
    ``FILL_BLOCKS``, else 16 (four warps that split each key tile), so a
    small prefill still spreads over the SMs."""
    return 64 if -(-rows // 64) * columns >= FILL_BLOCKS else 16


def flash_attention_gqa(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, q_offset: int = 0,
                        return_lse: bool = False):
    """q (B, Sq, KV, G, dqk); k (B, Sk, KV, dqk), v (B, Sk, KV, dv) ->
    (B, Sq, KV, G, dv), (dqk, dv) one of ``HEAD_DIMS``; with
    ``return_lse``, (out, lse (B, KV, G, Sq) fp32)."""
    tag = check_cuda("flash_attention", q, k, v)
    b, sq, kv, g, dh = q.shape
    sk, dv = k.shape[1], v.shape[-1]
    if k.shape != (b, sk, kv, dh) or v.shape != (b, sk, kv, dv):
        raise ValueError(f"flash_attention: k/v shapes {tuple(k.shape)}, "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if (dh, dv) not in HEAD_DIMS:
        raise ValueError(f"flash_attention: (q/k, v) head dims {(dh, dv)} "
                         f"not in {HEAD_DIMS}")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be positive, got "
                         f"{window}")
    if not aligned16(q, k, v):
        raise ValueError("flash_attention: q, k and v must be 16-byte "
                         "aligned")
    out = q.new_empty((b, sq, kv, g, dv))
    lse = (torch.empty((b, kv, g, sq), device=q.device, dtype=torch.float32)
           if return_lse else None)
    if sq == 0:
        return (out, lse) if return_lse else out
    if sk == 0:
        raise ValueError("flash_attention: no keys")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(), b, sq, sk, kv, g,
                 dh, dv, int(causal), int(window or 0), int(q_offset),
                 block_rows(sq, b * kv * g),
                 1.0 / (dh ** 0.5), tag, stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    return (out, lse) if return_lse else out


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None):
    """BH-flat view: q (BH, Sq, dh); k, v (BH, Sk, dh) -> (BH, Sq, dh)."""
    bh, sq, dh = q.shape
    sk = k.shape[1]
    out = flash_attention_gqa(q.view(bh, sq, 1, 1, dh),
                              k.view(bh, sk, 1, dh), v.view(bh, sk, 1, dh),
                              causal=causal, window=window)
    return out.view(bh, sq, dh)
