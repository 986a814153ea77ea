"""Launchers for the hand-written CUDA paged-attention kernels
(``csrc/paged_decode.cu``), the port of the Pallas kernels in
``repro/kernels/paged_decode.py``.

Both read the scheduler's ``(P, page, KV, dh)`` pools in place through
``(B, NB)`` int32 block tables and ``(B,)`` int32 lengths:

  * ``paged_flash_decode``: q (B, KV, G, dh) -> (B, KV, G, dh); row ``b``
    attends slots ``[0, lengths[b])``.
  * ``paged_flash_verify``: q (B, W, KV, G, dh) -> (B, W, KV, G, dh); query
    ``w`` of row ``b`` attends slots ``<= lengths[b] - W + w``.

Pools and q are fp32, fp16 or bf16 (one type), computed in fp32; the
output is in the pools' type.

Preconditions the kernels cannot check without a device sync: table
entries lie in ``[0, P)``, ``lengths[b] >= 1`` (decode) and
``lengths[b] >= W`` (verify).

CUDA tensors only; ``kernels/ops.py`` dispatches by device and counts
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import HEAD_DIMS, block_rows
from repro_torch.kernels.flash_decode import (_ptr, aligned16, check_cuda,
                                              splits, workspace)

_P, _I = ctypes.c_void_p, ctypes.c_int


def _fn(name: str, n_ptr: int, n_int: int):
    fn = getattr(build.library("paged_decode"), name)
    if fn.argtypes is None:
        fn.argtypes = [_P] * n_ptr + [_I] * n_int + [ctypes.c_float, _I,
                                                      _P]
        fn.restype = _I
    return fn


def _check(name: str, q, k_pages, v_pages, tables, lengths, kv: int,
           dh: int):
    """Raise on what the kernels do not take; returns (page, NB, dtype
    tag)."""
    tag = check_cuda(name, q, k_pages, v_pages)
    _, page, kv_p, dh_p = k_pages.shape
    if v_pages.shape != k_pages.shape or (kv_p, dh_p) != (kv, dh):
        raise ValueError(f"{name}: pool shapes {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if dh % 4:
        raise ValueError(f"{name}: head_dim {dh} is not a multiple of 4")
    for t in (k_pages, v_pages):
        if t.data_ptr() % (4 * t.element_size()):
            raise ValueError(f"{name}: pools must be aligned to 4 elements")
    b = q.shape[0]
    if tables.ndim != 2 or tables.shape[1] == 0:
        raise ValueError(f"{name}: tables must be (B, NB) with NB > 0, got "
                         f"{tuple(tables.shape)}")
    for label, t, shape in (("tables", tables, (b, tables.shape[1])),
                            ("lengths", lengths, (b,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {label} must be int32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous on q's "
                             f"device")
    return page, tables.shape[1], tag


def paged_flash_decode(q, k_pages, v_pages, tables, lengths):
    """q (B, KV, G, dh); pools (P, page, KV, dh); tables (B, NB) int32;
    lengths (B,) int32 -> (B, KV, G, dh).  One launch: the slot range is
    split as ``flash_decode.splits`` plans it, the splits merged in the
    same launch."""
    b, kv, g, dh = q.shape
    page, nb, tag = _check("paged_flash_decode", q, k_pages, v_pages,
                           tables, lengths, kv, dh)
    n_split, chunk = splits(b, kv, g, nb * page, dh)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    work, cnt = workspace(q.device, stream, b, kv, g, dh, n_split)
    out = torch.empty((b, kv, g, dh), device=q.device, dtype=v_pages.dtype)
    vec = (dh * q.element_size()) % 16 == 0 and aligned16(q, k_pages,
                                                          v_pages)
    err = _fn("repro_paged_decode", 8, 9)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), _ptr(work),
        _ptr(cnt), b, kv, g, dh, page, nb, n_split, chunk, int(vec),
        1.0 / (dh ** 0.5), tag, stream)
    if err:
        raise RuntimeError(f"paged_flash_decode kernel launch failed: CUDA "
                           f"error {err}")
    return out


def paged_flash_verify(q, k_pages, v_pages, tables, lengths):
    """q (B, W, KV, G, dh); pools, tables, lengths as for decode ->
    (B, W, KV, G, dh)."""
    b, w, kv, g, dh = q.shape
    page, nb, tag = _check("paged_flash_verify", q, k_pages, v_pages,
                           tables, lengths, kv, dh)
    if (dh, dh) not in HEAD_DIMS:
        raise ValueError(f"paged_flash_verify: head_dim {dh} not in "
                         f"{tuple(d for d, v in HEAD_DIMS if d == v)}")
    if not aligned16(q, k_pages, v_pages):
        raise ValueError("paged_flash_verify: q and the pools must be "
                         "16-byte aligned")
    out = torch.empty_like(q)
    if w == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn("repro_paged_verify", 6, 8)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, w, kv, g,
        dh, page, nb, block_rows(w * g, b * kv), 1.0 / (dh ** 0.5), tag,
        stream)
    if err:
        raise RuntimeError(f"paged_flash_verify kernel launch failed: CUDA "
                           f"error {err}")
    return out
