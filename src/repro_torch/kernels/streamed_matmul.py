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
tile, walked in a compiled tile, and block_k sets the K rows per
shared-memory stage.  When the output's regions would leave the SMs
under-filled, K is split across blocks (``tile_k_splits``) and the splits'
fp32 partial sums are added in split order inside the same launch.

CUDA tensors only; ``kernels/ops.py`` dispatches by device and counts
launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_decode import _ptr, check_cuda

SMS = 132                     # the H100's SMs: the K split fills them
MAX_SPLITS = 8
MAX_PART_BYTES = 16 * 2**20   # fp32 partial sums of one call, at most
N_COUNTERS = 1024             # split regions (fewer than SMS) per stream

_P, _I = ctypes.c_void_p, ctypes.c_int
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def _lib():
    fn = build.library("streamed_matmul").repro_streamed_matmul
    if fn.argtypes is None:
        fn.argtypes = [_P] * 5 + [_I] * 11 + [_P]
        fn.restype = _I
    return fn


def counters(device: torch.device, stream: int) -> torch.Tensor:
    """``N_COUNTERS`` zeroed int32 on ``device`` for K-split launches on
    ``stream``: each split launch leaves them zeroed, and launches on one
    stream run in order, so one buffer per stream serves every call."""
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None:
        buf = _COUNTERS[key] = torch.zeros(N_COUNTERS, dtype=torch.int32,
                                           device=device)
    return buf


@functools.lru_cache(maxsize=4096)
def tile_k_splits(m: int, k: int, n: int, rm: int, rn: int, kc: int
                  ) -> Tuple[int, int]:
    """(splits, k_per_split) for the tiled body: blocks own rm x rn output
    regions with 2 * kc K rows per stage.  When the regions alone leave
    some of the ``SMS`` idle, K is split so that regions x splits reaches
    ``SMS`` with the fewest splits where K has the stages for it, else
    the most it allows: each split a whole number of stages (so an even
    number of logical rows, as int4 needs), at most ``MAX_SPLITS`` of
    them and ``MAX_PART_BYTES`` of fp32 partial sums.  Else one split
    over all of K."""
    ks = 2 * kc
    stages = -(-k // ks)
    regions = -(-m // rm) * -(-n // rn)
    cap = min(MAX_SPLITS, MAX_PART_BYTES // (4 * m * n), stages)
    if regions >= SMS or cap < 2:
        return 1, stages * ks
    want = -(-SMS // regions)
    for target in range(want, cap + 1):   # the fewest splits that fill
        per = -(-stages // target)        # stages per split
        if -(-stages // per) >= want:
            return -(-stages // per), per * ks
    per = -(-stages // cap)               # K too short: as many as allowed
    return -(-stages // per), per * ks


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
    tile_m x tile_n tile (each edge 64 when the region's is at most 64,
    else 128), with kc = 8, 16 or 32, the band of block_k up to 128, up to
    256, or more; a stage holds 2 * kc K rows (csrc/mm_tiles.cuh).  Distinct
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
    splits, per = tile_k_splits(m, k, n, tiles[0], tiles[1], tiles[4])
    out = torch.empty((m, n), device=x.device, dtype=x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    part = cnt = None
    if splits > 1:    # splits x M x N x 4 bytes, within MAX_PART_BYTES
        part = torch.empty((splits, m, n), device=x.device,
                           dtype=torch.float32)
        cnt = counters(x.device, stream)
    err = _lib()(x.data_ptr(), w.data_ptr(), out.data_ptr(), _ptr(part),
                 _ptr(cnt), m, k, n, *tiles, splits, per, tag, stream)
    if err:
        raise RuntimeError(f"streamed_matmul kernel launch failed: CUDA "
                           f"error {err}")
    return out
