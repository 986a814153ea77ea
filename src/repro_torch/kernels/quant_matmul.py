"""Launcher for the hand-written CUDA dequantizing matmul
(``csrc/quant_matmul.cu``), the port of the Pallas kernel
``repro/kernels/streamed_matmul.py::quantized_matmul``.

``quant_matmul(x, w_q, scale, bits, tiles)``: x (M, K) @ (w_q dequantized,
times the per-column ``scale``) -> (M, N) in x's dtype; x fp32, fp16 or
bf16, ``scale`` fp32.  ``w_q`` is int8 (K, N) for ``bits=8`` or uint8
nibble-packed (ceil(K/2), N) for ``bits=4``.  One launch per call:

* M <= ``SKINNY_M`` (decode): the kernel reads each weight byte once on
  the CUDA cores, and the K rows are split across blocks until the card
  is full (``k_splits``); the last split of each column tile adds the
  splits' partial sums in split order.
* Larger M: the tensor-core tile body of ``csrc/mm_tiles.cuh`` (fp32 x as
  three exact bf16 passes, fp16 / bf16 x as one), whose variant ``tiles``
  = (block_m, block_n, block_k) selects as for ``streamed_matmul``
  (``None``: ``DEFAULT_CTA``, 64 x 64 regions and tiles, 64-row stages),
  with K split as ``streamed_matmul.tile_k_splits`` plans it.

The workspace of a split call is ``torch.empty((splits, M, N), float32)``:
256 KiB at the decode shapes (16 x 4 x 1024 x 4 B), 4 MiB at most at the
prefill shapes (2 x 128 x 4096 x 4 B), never above 16 MiB
(``streamed_matmul.MAX_PART_BYTES``).

``quant_matmul_batched(x, w_q, scale, bits, n, trans)`` runs H heads in
one launch (MLA's absorbed decode products): x (M, H, K) -> (M, H, N),
head h on a K x N slice of one quantized weight, the columns [h N, (h + 1)
N) of w_q (K, H N) with their scales, or with ``trans`` the transpose of
the columns [h K, (h + 1) K) of w_q (N, H K), its scales along K.

CUDA tensors only; ``kernels/ops.py`` dispatches by device and counts
launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_decode import DTYPES, _ptr
from repro_torch.kernels.streamed_matmul import (counters, cta_tile,
                                                 tile_k_splits)

SKINNY_M = 4              # csrc kSkinnyM: rows of x one skinny launch serves
LANES_K = 64              # csrc kLanesK: threads across K in a skinny block
BLOCK_N = 64              # csrc kBlockN: columns per skinny block
TARGET_BLOCKS = 2 * 132   # enough blocks to fill the H100's SMs twice
DEFAULT_CTA = (64, 64, 64, 64, 32)   # no tiles: region, tile, K band

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    fn = build.library("quant_matmul").repro_quant_matmul
    if fn.argtypes is None:
        fn.argtypes = [_P] * 6 + [_I] * 13 + [_P]
        fn.restype = _I
    return fn


def stored_rows(k: int, bits: int) -> int:
    """Rows of ``w_q`` for K logical rows."""
    return k if bits == 8 else (k + 1) // 2


@functools.lru_cache(maxsize=4096)
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


@functools.lru_cache(maxsize=4096)
def _plan(m: int, k: int, n: int, bits: int,
          tiles: Optional[Tuple[int, int, int]]):
    """(splits, per_split, cta) of one call's launch."""
    cta = DEFAULT_CTA if tiles is None else cta_tile(
        *(min(t, d) for t, d in zip(tiles, (m, n, k))))
    if m <= SKINNY_M:
        return k_splits(n, stored_rows(k, bits)) + (cta,)
    return tile_k_splits(m, k, n, cta[0], cta[1], cta[4]) + (cta,)


def quant_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                 bits: int = 8,
                 tiles: Optional[Tuple[int, int, int]] = None
                 ) -> torch.Tensor:
    """x (M, K) @ dequant(w_q, scale) (K, N) -> (M, N) in x's dtype."""
    idx = x.get_device()     # -1 on the CPU
    if idx < 0 or w_q.get_device() != idx or scale.get_device() != idx:
        raise ValueError(f"quant_matmul: x, w_q and scale must be on one "
                         f"CUDA device, got {x.device}, {w_q.device}, "
                         f"{scale.device}")
    if not (x.is_contiguous() and w_q.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError("quant_matmul: x, w_q and scale must be "
                         "contiguous")
    if bits not in (8, 4):
        raise ValueError(f"quant_matmul: bits must be 8 or 4, got {bits}")
    tag = DTYPES.get(x.dtype)
    if tag is None or scale.dtype != torch.float32:
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
    out = x.new_empty((m, n))
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    splits, per, cta = _plan(m, k, n, bits, tiles)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    part = cnt = None
    if splits > 1:    # splits x M x N x 4 bytes of fp32 partial sums
        part = torch.empty((splits, m, n), device=x.device,
                           dtype=torch.float32)
        cnt = counters(x.device, stream)
    w_ptr = w_q.data_ptr()
    err = _lib()(x.data_ptr(), w_ptr, scale.data_ptr(), out.data_ptr(),
                 _ptr(part), _ptr(cnt), m, k, n, bits, splits, per,
                 int(n % 16 == 0 and w_ptr % 16 == 0), *cta, tag, stream)
    if err:
        raise RuntimeError(f"quant_matmul kernel launch failed: CUDA error "
                           f"{err}")
    return out


def _batched_lib():
    fn = build.library("quant_matmul").repro_quant_matmul_batched
    if fn.argtypes is None:
        fn.argtypes = [_P] * 4 + [_I] * 8 + [_P]
        fn.restype = _I
    return fn


def batched_dims(x_shape, w_shape, n: int, bits: int, trans: bool):
    """(M, H, K) of x and the weight's stored rows / row stride checked
    against the batched layout; raises ``ValueError`` on a mismatch."""
    m, h, k = x_shape
    rows, ld = w_shape
    want_rows = stored_rows(n if trans else k, bits)
    want_ld = h * (k if trans else n)
    if rows != want_rows or ld != want_ld:
        raise ValueError(f"quant_matmul_batched: w_q {tuple(w_shape)} does "
                         f"not hold {h} heads of K={k} x N={n} "
                         f"({'transposed, ' if trans else ''}{bits} bits: "
                         f"want ({want_rows}, {want_ld}))")
    return m, h, k


def quant_matmul_batched(x: torch.Tensor, w_q: torch.Tensor,
                         scale: torch.Tensor, bits: int, n: int,
                         trans: bool = False) -> torch.Tensor:
    """x (M, H, K) @ per-head slices of dequant(w_q, scale) -> (M, H, N)
    in x's dtype (see the module docstring)."""
    idx = x.get_device()     # -1 on the CPU
    if idx < 0 or w_q.get_device() != idx or scale.get_device() != idx:
        raise ValueError(f"quant_matmul_batched: x, w_q and scale must be "
                         f"on one CUDA device, got {x.device}, "
                         f"{w_q.device}, {scale.device}")
    if not (x.is_contiguous() and w_q.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError("quant_matmul_batched: x, w_q and scale must be "
                         "contiguous")
    if bits not in (8, 4):
        raise ValueError(f"quant_matmul_batched: bits must be 8 or 4, got "
                         f"{bits}")
    tag = DTYPES.get(x.dtype)
    if tag is None or scale.dtype != torch.float32:
        raise TypeError(f"quant_matmul_batched: x must be float32, float16 "
                        f"or bfloat16 and scale float32, got {x.dtype}, "
                        f"{scale.dtype}")
    if w_q.dtype != (torch.int8 if bits == 8 else torch.uint8):
        raise TypeError(f"quant_matmul_batched: {bits}-bit weights must be "
                        f"int8 / uint8, got {w_q.dtype}")
    if x.ndim != 3 or w_q.ndim != 2:
        raise ValueError(f"quant_matmul_batched: x must be 3-D and w_q 2-D, "
                         f"got {tuple(x.shape)}, {tuple(w_q.shape)}")
    m, h, k = batched_dims(x.shape, w_q.shape, n, bits, trans)
    if scale.numel() != w_q.shape[1]:
        raise ValueError(f"quant_matmul_batched: scale {tuple(scale.shape)} "
                         f"against {w_q.shape[1]} columns")
    out = x.new_empty((m, h, n))
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _batched_lib()(x.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                         out.data_ptr(), m, h, k, n, w_q.shape[1], bits,
                         int(trans), tag, stream)
    if err:
        raise RuntimeError(f"quant_matmul_batched kernel launch failed: "
                           f"CUDA error {err}")
    return out
