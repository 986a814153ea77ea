"""Launcher for the hand-written CUDA streamed matmul
(``csrc/streamed_matmul.cu``), the port of the Pallas kernel
``repro/kernels/streamed_matmul.py::streamed_matmul``.

``streamed_matmul(x, w, block_m=, block_n=, block_k=)``: x (M, K) @ w
(K, N) -> (M, N) in x's dtype, fp32, fp16 or bf16 (x and w of one type),
accumulated in fp32.  The tiles keep the reference's contract: each is
clamped to its dimension and must divide it, else ``ValueError``
(``check_tiles``, which ``kernels/ops.py`` applies on the CPU too).  On
the card they select the kernel's variant (``cta_tile``): (block_m,
block_n) is each block's output region, as it is the TPU grid's output
tile, walked in a compiled register tile, and block_k sets the K rows per
shared-memory stage.

CUDA tensors only; ``kernels/ops.py`` dispatches by device and counts
launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_decode import check_cuda

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    fn = build.library("streamed_matmul").repro_streamed_matmul
    if fn.argtypes is None:
        fn.argtypes = [_P] * 3 + [_I] * 9 + [_P]
        fn.restype = _I
    return fn


def check_tiles(m: int, k: int, n: int, block_m: int, block_n: int,
                block_k: int) -> Tuple[int, int, int]:
    """The tiles clamped to the shape, ``(bm, bn, bk)``; raises
    ``ValueError`` unless each divides its dimension (the reference
    asserts the same)."""
    if min(m, k, n) <= 0:
        raise ValueError(f"streamed_matmul: empty shape (M, K, N) = "
                         f"{(m, k, n)}")
    bm, bn, bk = min(block_m, m), min(block_n, n), min(block_k, k)
    if min(bm, bn, bk) <= 0 or m % bm or n % bn or k % bk:
        raise ValueError(f"streamed_matmul: tiles {(bm, bn, bk)} do not "
                         f"divide (M, N, K) = {(m, n, k)}")
    return bm, bn, bk


def cta_tile(bm: int, bn: int, bk: int) -> Tuple[int, int, int, int, int]:
    """The launch a (clamped) tile selects, ``(bm, bn, tile_m, tile_n,
    kc)``: blocks own bm x bn output regions, walked in the compiled
    tile_m x tile_n register tile (each edge 64 when the region's is at
    most 64, else 128), with kc = 8, 16 or 32 K rows per stage for block_k
    up to 128, up to 256, or more (csrc/mm_tiles.cuh).  Distinct
    candidates of ``autotune._tile_candidates`` are distinct launches: the
    region is the tile itself, and two fitted block_k of one shape never
    fall in one kc band (a fit of 256 that is at most 128 is the fit of
    128, and likewise for 512 and 256)."""
    edge = lambda b: 64 if b <= 64 else 128  # noqa: E731
    kc = 8 if bk <= 128 else 16 if bk <= 256 else 32
    return bm, bn, edge(bm), edge(bn), kc


def streamed_matmul(x: torch.Tensor, w: torch.Tensor, *, block_m: int = 256,
                    block_n: int = 256, block_k: int = 512) -> torch.Tensor:
    """x (M, K) @ w (K, N) -> (M, N) in x's dtype."""
    tag = check_cuda("streamed_matmul", x, w)
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"streamed_matmul: shapes {tuple(x.shape)} and "
                         f"{tuple(w.shape)} do not chain")
    m, k = x.shape
    n = w.shape[1]
    tiles = cta_tile(*check_tiles(m, k, n, block_m, block_n, block_k))
    out = torch.empty((m, n), device=x.device, dtype=x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib()(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n,
                 *tiles, tag, stream)
    if err:
        raise RuntimeError(f"streamed_matmul kernel launch failed: CUDA "
                           f"error {err}")
    return out
