"""Launcher for the hand-written CUDA dequantizing matmul
(``csrc/quant_matmul.cu``), the port of the Pallas kernel
``repro/kernels/streamed_matmul.py::quantized_matmul``.

``quant_matmul(x, w_q, scale, bits, tiles)``: x (M, K) @ (w_q dequantized,
times the per-column ``scale``) -> (M, N) in x's dtype; x fp32, fp16 or
bf16, ``scale`` fp32.  ``w_q`` is int8 (K, N) for ``bits=8`` or uint8
nibble-packed (ceil(K/2), N) for ``bits=4``.  For M <= ``SKINNY_M``
(decode) the kernel reads each weight byte once and the K rows are split
across blocks until the card is full; larger M runs the shared-memory
tiled body of ``csrc/mm_tiles.cuh``, whose variant ``tiles`` = (block_m,
block_n, block_k) selects as for ``streamed_matmul`` (``None``: 64 x 64
regions and register tiles, 32-row stages).

CUDA tensors only; ``kernels/ops.py`` dispatches by device and counts
launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_decode import DTYPES, _ptr
from repro_torch.kernels.streamed_matmul import cta_tile

SKINNY_M = 4              # csrc kSkinnyM: rows of x one skinny launch serves
LANES_K = 64              # csrc kLanesK: threads across K in a skinny block
BLOCK_N = 64              # csrc kBlockN: columns per skinny block
TARGET_BLOCKS = 2 * 132   # enough blocks to fill the H100's SMs twice
DEFAULT_CTA = (64, 64, 64, 64, 32)   # no tiles: region, tile, K stage

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    fn = build.library("quant_matmul").repro_quant_matmul
    if fn.argtypes is None:
        fn.argtypes = [_P] * 5 + [_I] * 13 + [_P]
        fn.restype = _I
    return fn


def stored_rows(k: int, bits: int) -> int:
    """Rows of ``w_q`` for K logical rows."""
    return k if bits == 8 else (k + 1) // 2


def k_splits(n: int, rows: int) -> Tuple[int, int]:
    """(splits, rows_per_split) for a skinny launch: split the stored rows
    so ceil(N / BLOCK_N) * splits blocks reach ``TARGET_BLOCKS``, each
    split a whole number of ``LANES_K`` rows (at least one row per
    thread)."""
    n_blocks = -(-n // BLOCK_N)
    want = max(1, -(-TARGET_BLOCKS // n_blocks))
    per = -(-rows // want)
    per = -(-per // LANES_K) * LANES_K
    return -(-rows // per), per


def quant_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                 bits: int = 8,
                 tiles: Optional[Tuple[int, int, int]] = None
                 ) -> torch.Tensor:
    """x (M, K) @ dequant(w_q, scale) (K, N) -> (M, N) in x's dtype."""
    for name, t in (("x", x), ("w_q", w_q), ("scale", scale)):
        if t.device.type != "cuda":
            raise ValueError(f"quant_matmul: {name} must be a CUDA tensor, "
                             f"got {t.device}")
        if t.device != x.device:
            raise ValueError("quant_matmul: inputs on different devices")
        if not t.is_contiguous():
            raise ValueError(f"quant_matmul: {name} must be contiguous")
    if bits not in (8, 4):
        raise ValueError(f"quant_matmul: bits must be 8 or 4, got {bits}")
    if x.dtype not in DTYPES or scale.dtype != torch.float32:
        raise TypeError(f"quant_matmul: x must be float32, float16 or "
                        f"bfloat16 and scale float32, got {x.dtype}, "
                        f"{scale.dtype}")
    want = torch.int8 if bits == 8 else torch.uint8
    if w_q.dtype != want:
        raise TypeError(f"quant_matmul: {bits}-bit weights must be {want}, "
                        f"got {w_q.dtype}")
    if x.ndim != 2 or w_q.ndim != 2:
        raise ValueError(f"quant_matmul: x and w_q must be 2-D, got "
                         f"{tuple(x.shape)}, {tuple(w_q.shape)}")
    m, k = x.shape
    rows, n = w_q.shape
    if rows != stored_rows(k, bits) or tuple(scale.shape) != (n,):
        raise ValueError(f"quant_matmul: x {tuple(x.shape)}, w_q "
                         f"{tuple(w_q.shape)} and scale "
                         f"{tuple(scale.shape)} do not match for {bits} "
                         f"bits")
    out = torch.empty((m, n), device=x.device, dtype=x.dtype)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    splits, per = 1, rows
    part = None
    if m <= SKINNY_M:
        splits, per = k_splits(n, rows)
        if splits > 1:
            part = torch.empty((splits, m, n), device=x.device,
                               dtype=torch.float32)
    vec = n % 16 == 0 and w_q.data_ptr() % 16 == 0
    cta = DEFAULT_CTA if tiles is None else cta_tile(
        *(min(t, d) for t, d in zip(tiles, (m, n, k))))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib()(x.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                 out.data_ptr(), _ptr(part), m, k, n, bits, splits, per,
                 int(vec), *cta, DTYPES[x.dtype], stream)
    if err:
        raise RuntimeError(f"quant_matmul kernel launch failed: CUDA error "
                           f"{err}")
    return out
