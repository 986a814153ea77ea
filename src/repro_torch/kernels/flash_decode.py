"""Launchers for the hand-written CUDA flash-decoding kernel
(``csrc/flash_decode.cu``), the port of the Pallas kernel in
``repro/kernels/flash_decode.py``.

The kernel takes the grouped layout directly — q (B, KV, G, dh), cache
(B, S, KV, dh), valid (B, S) — so a K/V row is read once for up to 8 query
heads.  ``flash_decode_partial``/``flash_decode`` keep the reference's
BH-flat signature as a thin view (B = BH rows, one head each), so the
unnormalised ``(o, m, l)`` contract stays testable.

Every call is one launch: the sequence is split across blocks
(``splits``), and the last block of each (b, kv head) merges the splits'
fp32 partials, kept in a workspace cached per (device, stream)
(``workspace``), in split order.

``flash_decode_latent`` is the same kernel body on MLA's latent cache:
q (B, 1, G, 288) against the latent rows c (B, S, 256) and the rope rows kr
(B, S, 32), key row ``[c, kr]`` and value row ``c``, read in place (no
concatenated copy), one launch per call, normalised (B, 1, G, 256) or, with
``normalize=False``, the fp32 partials (o, m, l) over the slots given (a
model rank's slice of a sequence-sharded latent cache).

Inputs are fp32, fp16 or bf16 (one type for q, k and v), head_dim up to
256; the kernel computes in fp32 and returns the normalised output in the
cache's type and the partials in fp32, as the reference does.  These
functions take CUDA tensors only; ``kernels/ops.py`` dispatches by device
and counts launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build

WARPS = 4                 # warps per block (csrc attn::kDecWarps)
WARP_TILE = 8             # a split gives each warp a multiple of these keys
GROUP = 8                 # q heads per block when G > 1 (attn::kDecGroup)
MAX_DH = 256              # head_dim the kernel takes (attn::kDecMaxDH)
MAX_SPLITS = 64           # splits of one call (attn::kDecMaxSplits)
TARGET_BLOCKS = 2 * 132   # enough blocks to fill the H100's SMs twice
MAX_WORK_BYTES = 16 * 2**20   # fp32 split partials of one call, at most
# MLA's latent cache widths the latent layout is built for (c, kr)
# (attn::LatentLanes::DC, DR)
LATENT_DIMS = (256, 32)

# storage types the kernels take, and their tags (csrc elem::DType)
DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

_P, _I = ctypes.c_void_p, ctypes.c_int
_WORK: Dict[Tuple[str, Optional[int], int],
            Tuple[torch.Tensor, torch.Tensor]] = {}


def _lib():
    fn = build.library("flash_decode").repro_flash_decode
    if fn.argtypes is None:
        fn.argtypes = [_P] * 9 + [_I] * 8 + [ctypes.c_float, _I, _P]
        fn.restype = _I
    return fn


def _lib_latent():
    fn = build.library("flash_decode").repro_flash_decode_latent
    if fn.argtypes is None:
        fn.argtypes = [_P] * 9 + [_I] * 5 + [ctypes.c_float, _I, _P]
        fn.restype = _I
    return fn


def check_cuda(name: str, *tensors: torch.Tensor) -> int:
    """Raise unless every tensor is contiguous on a CUDA device and of one
    type in ``DTYPES``; returns that type's tag.  Any other type raises
    ``TypeError``: there is no fallback."""
    dtype = tensors[0].dtype
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if t.dtype not in DTYPES:
            raise TypeError(f"{name}: only float32, float16 and bfloat16 "
                            f"are supported, got {t.dtype}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: inputs must share one dtype, got "
                            f"{dtype} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return DTYPES[dtype]


def aligned16(*tensors: torch.Tensor) -> bool:
    """Whether every tensor's data starts on a 16-byte boundary."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def head_groups(g: int) -> int:
    """Blocks per (b, kv head) along the query heads: one for G = 1, else
    one per ``GROUP`` heads."""
    return 1 if g == 1 else -(-g // GROUP)


@functools.lru_cache(maxsize=4096)
def splits(b: int, kv: int, g: int, s: int, dh: int) -> Tuple[int, int]:
    """(n_split, chunk): the slot range [0, s) cut into n_split splits of
    ``chunk`` slots, each a whole number of warp tiles (``WARPS`` x
    ``WARP_TILE`` slots, so each warp walks chunk / WARPS of them).  The
    fewest splits that bring B x KV x head groups x n_split blocks to
    ``TARGET_BLOCKS``, where s has the tiles for it, with at most
    ``MAX_SPLITS`` splits and their fp32 partials within
    ``MAX_WORK_BYTES``; else the most those allow."""
    unit = WARPS * WARP_TILE
    n_units = max(1, -(-s // unit))
    cap = max(1, min(MAX_SPLITS,
                     MAX_WORK_BYTES // work_bytes(b, kv, g, dh)))
    want = max(1, min(n_units, cap,
                      -(-TARGET_BLOCKS // (b * kv * head_groups(g)))))
    for per in range(-(-n_units // want), 0, -1):   # units per split
        n_split = -(-n_units // per)
        if n_split >= want:
            break
    if n_split > cap:
        per = -(-n_units // cap)
        n_split = -(-n_units // per)
    return n_split, per * unit


def work_bytes(b: int, kv: int, g: int, dh: int, n_split: int = 1) -> int:
    """Bytes of the fp32 (o, m, l) partials of n_split splits."""
    return 4 * n_split * b * kv * g * (dh + 2)


def workspace(device: torch.device, stream: int, b: int, kv: int, g: int,
              dh: int, n_split: int
              ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The fp32 split partials and the zeroed int32 counters (one per
    block column: b, kv head, head group) a launch of ``n_split`` > 1
    splits needs on ``device`` (one split needs neither: (None, None)),
    cached per (device, stream).  Launches on one stream run in order and
    each leaves its counters zeroed, so one workspace per stream serves
    every call; it grows only when a larger shape first appears."""
    if n_split == 1:
        return None, None
    floats = work_bytes(b, kv, g, dh, n_split) // 4
    counters = b * kv * head_groups(g)
    key = (device.type, device.index, stream)
    work, cnt = _WORK.get(key, (None, None))
    if work is None or work.numel() < floats:
        work = torch.empty(floats, dtype=torch.float32, device=device)
    if cnt is None or cnt.numel() < counters:
        cnt = torch.zeros(counters, dtype=torch.int32, device=device)
    _WORK[key] = (work, cnt)
    return work, cnt


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_valid(valid, q, b: int, s: int) -> None:
    if valid.dtype != torch.bool or valid.shape != (b, s):
        raise ValueError(f"flash_decode: valid must be bool ({b}, {s}), got "
                         f"{valid.dtype} {tuple(valid.shape)}")
    if valid.device != q.device or not valid.is_contiguous():
        raise ValueError("flash_decode: valid must be contiguous on q's "
                         "device")


def flash_decode_gqa(q, k, v, valid, *, normalize: bool = True):
    """q (B, KV, G, dh); k, v (B, S, KV, dh); valid (B, S) bool.
    ``normalize`` -> (B, KV, G, dh) in the cache's dtype; else fp32
    unnormalised partials (o (B, KV, G, dh), m, l (B, KV, G))."""
    tag = check_cuda("flash_decode", q, k, v)
    b, kv, g, dh = q.shape
    s = k.shape[1]
    if k.shape != (b, s, kv, dh) or v.shape != k.shape:
        raise ValueError(f"flash_decode: cache shapes {tuple(k.shape)}, "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    _check_valid(valid, q, b, s)
    if s == 0:
        raise ValueError("flash_decode: empty cache")
    if dh > MAX_DH:
        raise ValueError(f"flash_decode: head_dim {dh} above {MAX_DH}")
    n_split, chunk = splits(b, kv, g, s, dh)
    rows = b * kv * g
    stream = torch.cuda.current_stream(q.device).cuda_stream
    work, cnt = workspace(q.device, stream, b, kv, g, dh, n_split)
    if normalize:
        out = torch.empty((b, kv, g, dh), device=q.device, dtype=v.dtype)
        o, m, l = out, None, None
    else:   # one buffer: o, then m, then l
        out = torch.empty(rows * (dh + 2), device=q.device,
                          dtype=torch.float32)
        o = out[:rows * dh].view(b, kv, g, dh)
        m = out[rows * dh:rows * (dh + 1)].view(b, kv, g)
        l = out[rows * (dh + 1):].view(b, kv, g)
    vec = (dh * q.element_size()) % 16 == 0 and aligned16(q, k, v)
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
                 o.data_ptr(), _ptr(m), _ptr(l), _ptr(work), _ptr(cnt), b,
                 s, kv, g, dh, n_split, chunk, int(vec), 1.0 / (dh ** 0.5),
                 tag, stream)
    if err:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{err}")
    return o if normalize else (o, m, l)


def flash_decode_latent(q, c, kr, valid, *, normalize: bool = True):
    """MLA's absorbed decode over the latent cache: q (B, 1, G, dc + dr);
    c (B, S, dc); kr (B, S, dr); valid (B, S) bool, (dc, dr) =
    ``LATENT_DIMS``, the scores scaled by 1 / sqrt(dc + dr).
    ``normalize`` -> (B, 1, G, dc) in the cache's dtype; else fp32
    unnormalised partials (o (B, 1, G, dc), m, l (B, 1, G))."""
    tag = check_cuda("flash_decode", q, c, kr)
    b, one, g, dq = q.shape
    s = c.shape[1]
    dc, dr = LATENT_DIMS
    if (one != 1 or dq != dc + dr or c.shape != (b, s, dc)
            or kr.shape != (b, s, dr)):
        raise ValueError(f"flash_decode: latent shapes q {tuple(q.shape)}, "
                         f"c {tuple(c.shape)}, kr {tuple(kr.shape)} are not "
                         f"(B, 1, G, {dc + dr}), (B, S, {dc}), (B, S, {dr})")
    _check_valid(valid, q, b, s)
    if s == 0:
        raise ValueError("flash_decode: empty cache")
    if not aligned16(q, c, kr):
        raise ValueError("flash_decode: q, c and kr must be 16-byte aligned")
    n_split, chunk = splits(b, 1, g, s, dc)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    work, cnt = workspace(q.device, stream, b, 1, g, dc, n_split)
    if normalize:
        o = torch.empty((b, 1, g, dc), device=q.device, dtype=c.dtype)
        m = l = None
    else:   # one buffer: o, then m, then l
        out = torch.empty(b * g * (dc + 2), device=q.device,
                          dtype=torch.float32)
        o = out[:b * g * dc].view(b, 1, g, dc)
        m = out[b * g * dc:b * g * (dc + 1)].view(b, 1, g)
        l = out[b * g * (dc + 1):].view(b, 1, g)
    err = _lib_latent()(q.data_ptr(), c.data_ptr(), kr.data_ptr(),
                        valid.data_ptr(), o.data_ptr(), _ptr(m), _ptr(l),
                        _ptr(work), _ptr(cnt), b, s, g, n_split, chunk,
                        1.0 / (dq ** 0.5), tag, stream)
    if err:
        raise RuntimeError(f"flash_decode latent kernel launch failed: CUDA "
                           f"error {err}")
    return o if normalize else (o, m, l)


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
