"""Launchers for the hand-written CUDA flash-decoding kernel
(``csrc/flash_decode.cu``), the port of the Pallas kernel in
``repro/kernels/flash_decode.py``.

The kernel takes the grouped layout directly — q (B, KV, G, dh), cache
(B, S, KV, dh), valid (B, S) — so a K/V tile is read once for all G query
heads.  ``flash_decode_partial``/``flash_decode`` keep the reference's
BH-flat signature as a thin view (B = BH rows, one head each), so the
unnormalised ``(o, m, l)`` contract stays testable.

These functions take CUDA tensors only; ``kernels/ops.py`` dispatches by
device and counts launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

TILE = 64          # keys per shared-memory tile (csrc kTile)
TARGET_BLOCKS = 2 * 132   # enough blocks to fill the H100's SMs twice

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = build.library("flash_decode")
    fn = lib.repro_flash_decode_f32
    if fn.argtypes is None:
        fn.argtypes = [_P] * 10 + [_I] * 7 + [ctypes.c_float, _P]
        fn.restype = _I
    return fn


def check_cuda_f32(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: only float32 is supported, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def splits(b: int, kv: int, s: int) -> Tuple[int, int]:
    """(n_split, chunk): split the sequence so B * KV * n_split blocks
    reach ``TARGET_BLOCKS``, each split a whole number of tiles."""
    n_tiles = -(-s // TILE)
    want = max(1, min(n_tiles, -(-TARGET_BLOCKS // (b * kv))))
    chunk = -(-n_tiles // want) * TILE
    return -(-s // chunk), chunk


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def flash_decode_gqa(q, k, v, valid, *, normalize: bool = True):
    """q (B, KV, G, dh); k, v (B, S, KV, dh); valid (B, S) bool.
    ``normalize`` -> (B, KV, G, dh); else unnormalised partials
    (o (B, KV, G, dh), m, l (B, KV, G))."""
    check_cuda_f32("flash_decode", q, k, v)
    b, kv, g, dh = q.shape
    s = k.shape[1]
    if k.shape != (b, s, kv, dh) or v.shape != k.shape:
        raise ValueError(f"flash_decode: cache shapes {tuple(k.shape)}, "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if valid.dtype != torch.bool or valid.shape != (b, s):
        raise ValueError(f"flash_decode: valid must be bool ({b}, {s}), got "
                         f"{valid.dtype} {tuple(valid.shape)}")
    if valid.device != q.device or not valid.is_contiguous():
        raise ValueError("flash_decode: valid must be contiguous on q's "
                         "device")
    if s == 0:
        raise ValueError("flash_decode: empty cache")
    n_split, chunk = splits(b, kv, s)
    out_o = torch.empty((b, kv, g, dh), device=q.device, dtype=torch.float32)
    out_m = out_l = None
    if not normalize:
        out_m = torch.empty((b, kv, g), device=q.device, dtype=torch.float32)
        out_l = torch.empty_like(out_m)
    part_o = part_m = part_l = None
    if n_split > 1:
        part_o = torch.empty((n_split, b, kv, g, dh), device=q.device,
                             dtype=torch.float32)
        part_m = torch.empty((n_split, b, kv, g), device=q.device,
                             dtype=torch.float32)
        part_l = torch.empty_like(part_m)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
                 _ptr(part_o), _ptr(part_m), _ptr(part_l), out_o.data_ptr(),
                 _ptr(out_m), _ptr(out_l), b, s, kv, g, dh, n_split, chunk,
                 1.0 / (dh ** 0.5), stream)
    if err:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{err}")
    return out_o if normalize else (out_o, out_m, out_l)


def flash_decode_partial(q, k, v, valid):
    """BH-flat view: q (BH, dh); k, v (BH, S, dh); valid (BH, S) ->
    unnormalised (o (BH, dh), m (BH, 1), l (BH, 1))."""
    bh, dh = q.shape
    o, m, l = flash_decode_gqa(q.view(bh, 1, 1, dh),
                               k.view(bh, k.shape[1], 1, dh),
                               v.view(bh, v.shape[1], 1, dh), valid,
                               normalize=False)
    return o.view(bh, dh), m.view(bh, 1), l.view(bh, 1)


def flash_decode(q, k, v, valid):
    """BH-flat normalised decode: (BH, dh)."""
    bh, dh = q.shape
    o = flash_decode_gqa(q.view(bh, 1, 1, dh), k.view(bh, k.shape[1], 1, dh),
                         v.view(bh, v.shape[1], 1, dh), valid)
    return o.view(bh, dh)
