"""Per-channel symmetric weight quantization for PIPELOAD shards, PyTorch
port of ``repro/checkpoint/quant.py``.

The on-disk form is the reference's, byte for byte, so each package reads
the other's int8/int4 shards:

  * **scheme** — symmetric per-output-channel scaling: a 2-D float weight
    ``W (K, N)`` becomes ``q = clip(round(W / scale), -qmax, qmax)`` with
    ``scale (N,) = max|W[:, j]| / qmax`` (int8: qmax=127, int4: qmax=7).
    1-D params (norms, biases) stay in the checkpoint dtype.
  * **int4 packing** — two values per byte along the K axis (row ``2i``
    in the low nibble, ``2i+1`` in the high nibble; odd K is padded with
    a zero row).
  * **npz keys** — a quantized array at flat key ``k`` is stored as
    ``k.__q__`` / ``k.__scale__`` / ``k.__meta__`` / ``k.__dtype__``.

Quantizing is numpy (the checkpoint writer needs no device); the
in-memory form is ``QuantizedTensor``, whose integer payload and scales
are torch tensors.  The engine keeps that form resident on the device:
every linear layer multiplies by it through the quantized matmul kernel
(``models/common.linear``) and the embedding gathers rows of it
(``take_rows``), so no fp32 copy of a quantized weight is built on the
card.

bfloat16 leaves: numpy has no bfloat16.  The JAX package's bf16 leaves are
``ml_dtypes.bfloat16`` arrays, which ``np.savez`` writes as a 2-byte void
(header ``'<V2'``) and ``np.load`` reads back as ``'|V2'``.  The port keeps
such a leaf as that void view on the numpy side (``BF16``) and as
``torch.bfloat16`` on the tensor side, the same bytes either way; it
quantizes one from its values widened to fp32, as the reference's
quantizer does with any float.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

# quant name -> (bits, qmax)
QUANT_SCHEMES: Dict[str, Tuple[int, int]] = {"int8": (8, 127), "int4": (4, 7)}
SCHEME = "symmetric-per-channel"

_Q, _SCALE, _META, _DTYPE = "__q__", "__scale__", "__meta__", "__dtype__"


# the numpy form of a bfloat16 leaf (2-byte void, bytes as bfloat16)
BF16 = np.dtype("V2")


def is_bf16(a) -> bool:
    """A numpy bfloat16 leaf: the 2-byte void of a loaded shard, or an
    ``ml_dtypes.bfloat16`` array (kind ``'V'``, 2 bytes, as well)."""
    dt = getattr(a, "dtype", None)
    return isinstance(dt, np.dtype) and dt.kind == "V" and dt.itemsize == 2


def widen_bf16(a: np.ndarray) -> np.ndarray:
    """bfloat16 bytes -> the exact float32 values."""
    u = np.ascontiguousarray(a).view(np.uint16).astype(np.uint32)
    return (u << 16).view(np.float32)


def bf16_to_torch(a: np.ndarray) -> torch.Tensor:
    """A numpy bfloat16 leaf -> ``torch.bfloat16`` over the same bytes."""
    return torch.from_numpy(
        np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)


def bf16_to_numpy(t: torch.Tensor) -> np.ndarray:
    """``torch.bfloat16`` -> the 2-byte void array over the same bytes."""
    return t.detach().cpu().contiguous().view(torch.int16).numpy().view(BF16)


def qmax_for(bits: int) -> int:
    return 127 if bits == 8 else 7


class QuantizedTensor:
    """Integer weight + per-channel scales.

    ``q`` is int8 ``(K, N)`` for 8-bit, or uint8 nibble-packed
    ``(ceil(K/2), N)`` for 4-bit; ``scale`` is float32 ``(N,)``; ``shape``
    is the original (unpacked) shape and ``dtype`` the original float
    dtype's name.  ``pin_memory``/``to``/``record_stream`` act on both
    tensors, so the engine moves it like any other leaf."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, bits: int,
                 shape: Tuple[int, ...], dtype: str):
        self.q = q
        self.scale = scale
        self.bits = int(bits)
        self.shape = tuple(int(s) for s in shape)
        self.dtype = str(dtype)

    @property
    def nbytes(self) -> int:
        """Resident bytes of payload + scales."""
        return int(self.q.numel() * self.q.element_size()
                   + self.scale.numel() * self.scale.element_size())

    def _like(self, q, scale) -> "QuantizedTensor":
        return QuantizedTensor(q, scale, self.bits, self.shape, self.dtype)

    def pin_memory(self) -> "QuantizedTensor":
        return self._like(self.q.pin_memory(), self.scale.pin_memory())

    def to(self, device, non_blocking: bool = False) -> "QuantizedTensor":
        return self._like(self.q.to(device, non_blocking=non_blocking),
                          self.scale.to(device, non_blocking=non_blocking))

    def record_stream(self, stream) -> None:
        self.q.record_stream(stream)
        self.scale.record_stream(stream)

    def unpacked(self) -> torch.Tensor:
        """Integer values at the original shape (int8 even for 4-bit)."""
        if self.bits == 4:
            return unpack_int4(self.q, self.shape[0])
        return self.q

    def dequantize(self) -> torch.Tensor:
        """The full float weight.  Tests and the plain versions use it;
        the serving path never does."""
        return (self.unpacked().float() * self.scale).to(
            getattr(torch, self.dtype))

    def take_rows(self, idx: torch.Tensor) -> torch.Tensor:
        """Dequantized gather of rows (the embedding lookup): only the
        gathered rows are widened and scaled.  For 4-bit, row ``r`` is the
        low (even ``r``) or high (odd ``r``) nibble of packed row
        ``r // 2``; the values equal ``dequantize()[idx]``."""
        if self.bits == 8:
            vals = self.q[idx]
        else:
            packed = self.q[idx // 2]
            nib = torch.where((idx % 2 == 1)[..., None], packed >> 4,
                              packed & 0xF).to(torch.int8)
            vals = torch.where(nib > 7, nib - 16, nib)
        return (vals.float() * self.scale).to(getattr(torch, self.dtype))

    def __repr__(self):
        return (f"QuantizedTensor(int{self.bits}, shape={self.shape}, "
                f"dtype={self.dtype}, device={self.q.device})")


def is_quantized(leaf) -> bool:
    return isinstance(leaf, QuantizedTensor)


def as_tensor(leaf):
    """A shard leaf as the engine holds it: numpy arrays become torch
    tensors (sharing memory); QuantizedTensors and tensors (bfloat16
    leaves) pass through."""
    if is_quantized(leaf) or isinstance(leaf, torch.Tensor):
        return leaf
    return torch.from_numpy(leaf)


# ---------------------------------------------------------------------------
# int4 nibble packing (axis 0, row 2i low nibble / row 2i+1 high nibble)
# ---------------------------------------------------------------------------
def pack_int4(q: np.ndarray) -> np.ndarray:
    """(K, N) int values in [-8, 7] -> (ceil(K/2), N) uint8."""
    k = q.shape[0]
    if k % 2:
        q = np.concatenate([q, np.zeros((1,) + q.shape[1:], q.dtype)])
    lo = (q[0::2] & 0xF).astype(np.uint8)
    hi = (q[1::2] & 0xF).astype(np.uint8)
    return lo | (hi << 4)


def unpack_int4(packed: torch.Tensor, rows: int) -> torch.Tensor:
    """Inverse of ``pack_int4``: (ceil(K/2), N) uint8 -> (rows, N) int8,
    sign-extended."""
    p = packed.to(torch.uint8)
    lo = (p & 0xF).to(torch.int8)
    hi = ((p >> 4) & 0xF).to(torch.int8)
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    full = torch.stack([lo, hi], dim=1).reshape((-1,) + tuple(p.shape[1:]))
    return full[:rows]


# ---------------------------------------------------------------------------
# Quantize arrays (numpy)
# ---------------------------------------------------------------------------
def quantizable(a: np.ndarray, key: Optional[str] = None) -> bool:
    """Only the 2-D float matmul weights carry the bytes worth shrinking.
    MoE routers stay at checkpoint dtype even though they are 2-D: a
    rounding flip changes the top-k expert set discretely."""
    if key is not None and key.split(".")[-1] == "router":
        return False
    a = np.asarray(a)
    return a.ndim == 2 and (np.issubdtype(a.dtype, np.floating)
                            or is_bf16(a))


def quantize_array(a, quant: str) -> QuantizedTensor:
    """Per-channel symmetric quantization of a 2-D array, in numpy; the
    payload and scales are bit-equal to the reference's."""
    bits, qmax = QUANT_SCHEMES[quant]
    a = np.asarray(a)
    if is_bf16(a):
        dtype, a32 = "bfloat16", widen_bf16(a)
    else:
        dtype, a32 = str(a.dtype), a.astype(np.float32)
    amax = np.abs(a32).max(axis=0)
    scale = np.where(amax > 0, amax / qmax, 1.0).astype(np.float32)
    q = np.clip(np.rint(a32 / scale), -qmax, qmax).astype(np.int8)
    payload = pack_int4(q) if bits == 4 else q
    return QuantizedTensor(torch.from_numpy(payload),
                           torch.from_numpy(scale), bits, a32.shape, dtype)


def dequant_tree(tree):
    """Map QuantizedTensor leaves of a nested dict back to float tensors;
    other leaves pass through untouched."""
    if isinstance(tree, dict):
        return {k: dequant_tree(v) for k, v in tree.items()}
    return tree.dequantize() if is_quantized(tree) else tree


# ---------------------------------------------------------------------------
# npz (de)serialisation of flat {dotted_key: array} shard dicts
# ---------------------------------------------------------------------------
def quantize_flat(flat: Dict[str, np.ndarray],
                  quant: Optional[str]) -> Dict[str, np.ndarray]:
    """Replace every quantizable array in a flat shard dict with its
    ``__q__/__scale__/__meta__/__dtype__`` quadruple."""
    if quant is None:
        return dict(flat)
    out: Dict[str, np.ndarray] = {}
    for key, arr in flat.items():
        if quantizable(arr, key):
            qt = quantize_array(arr, quant)
            out[f"{key}.{_Q}"] = qt.q.numpy()
            out[f"{key}.{_SCALE}"] = qt.scale.numpy()
            out[f"{key}.{_META}"] = np.array([qt.bits, *qt.shape], np.int64)
            out[f"{key}.{_DTYPE}"] = np.str_(qt.dtype)
        else:
            out[key] = arr
    return out


def restore_tree(tree):
    """Fold ``{__q__, __scale__, __meta__, __dtype__}`` dicts (produced by
    unflattening a quantized npz) back into QuantizedTensor leaves, whose
    tensors share the arrays' memory."""
    if not isinstance(tree, dict):
        return tree
    if _Q in tree:
        meta = np.asarray(tree[_META])
        return QuantizedTensor(torch.from_numpy(tree[_Q]),
                               torch.from_numpy(tree[_SCALE]), int(meta[0]),
                               tuple(int(s) for s in meta[1:]),
                               str(tree[_DTYPE]))
    return {k: restore_tree(v) for k, v in tree.items()}
