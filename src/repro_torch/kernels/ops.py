"""Public kernel wrappers: dispatch by device and count launches.

A tensor on the CPU goes to the kernel's plain PyTorch version
(``kernels/ref.py``); a tensor on a CUDA device launches the hand-written
kernel, which raises on anything it does not take.  There is no fallback
from one to the other.  ``LAUNCHES`` counts kernel launches per kernel and
nothing else (the plain versions do not count), so a run can show that
its main path went through the kernels.

Signatures follow ``repro/kernels/ops.py``; the ``*_gqa`` forms take the
grouped layouts the model code uses.  ``set_tuned`` installs autotune
selections (``kernels/autotune.py``) as process-wide defaults: the tiles
of ``matmul`` / ``quant_matmul`` and the route of ``paged_decode``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_gqa)
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd
from repro_torch.kernels.flash_decode import (flash_decode,
                                              flash_decode_gqa,
                                              flash_decode_latent,
                                              flash_decode_partial)
from repro_torch.kernels.paged_decode import (paged_flash_decode,
                                              paged_flash_verify)
from repro_torch.kernels.quant_matmul import batched_dims
from repro_torch.kernels.quant_matmul import quant_matmul as _quant_matmul
from repro_torch.kernels.quant_matmul import quant_matmul_batched
from repro_torch.kernels.streamed_matmul import (check_tiles,
                                                 streamed_matmul)

LAUNCHES = {"flash_decode": 0, "flash_attention": 0,
            "flash_attention_bwd": 0, "paged_flash_decode": 0,
            "paged_flash_verify": 0, "quantized_matmul": 0,
            "streamed_matmul": 0}

# ---- autotuned defaults (kernels/autotune.py) ----------------------------
# ``set_tuned`` installs per-device selections; the wrappers resolve their
# default tiles from here, falling back to the built-ins whenever a tuned
# tile does not divide the call's shape, as the reference does.
_DEFAULT_TILES = {"block_m": 256, "block_n": 256, "block_k": 512}
_TUNED: dict = {"matmul": None, "quant_matmul": None, "paged_impl": None}
# paged decode routes: the block-table kernel, or the pages gathered to a
# dense cache and the flash-decoding kernel
PAGED_IMPLS = ("paged", "gather")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def set_tuned(*, matmul=None, quant_matmul=None,
              paged_impl: Optional[str] = None) -> None:
    """Install autotune selections as process-wide wrapper defaults (pass
    nothing to clear)."""
    if paged_impl is not None and paged_impl not in PAGED_IMPLS:
        raise ValueError(f"unknown paged impl {paged_impl!r}; choose one of "
                         f"{PAGED_IMPLS}")
    _TUNED["matmul"] = dict(matmul) if matmul else None
    _TUNED["quant_matmul"] = dict(quant_matmul) if quant_matmul else None
    _TUNED["paged_impl"] = paged_impl


def tuned_paged_impl() -> Optional[str]:
    """The autotuned paged-decode route ("paged" / "gather"), or None when
    untuned; ``paged_decode`` follows it when no route is passed."""
    return _TUNED["paged_impl"]


def _divides(tile: dict, m: int, k: int, n: int) -> bool:
    bm = min(tile["block_m"], m)
    bn = min(tile["block_n"], n)
    bk = min(tile["block_k"], k)
    return (min(bm, bn, bk) > 0 and m % bm == 0 and n % bn == 0
            and k % bk == 0)


def _resolve_tiles(kernel: str, m: int, k: int, n: int, block_m, block_n,
                   block_k) -> dict:
    """An explicit tile wins; else the tuned entry when it divides the
    shape, else the built-in defaults (as a whole)."""
    tuned = _TUNED[kernel]
    base = (tuned if tuned is not None and _divides(tuned, m, k, n)
            else _DEFAULT_TILES)
    return {"block_m": block_m if block_m is not None else base["block_m"],
            "block_n": block_n if block_n is not None else base["block_n"],
            "block_k": block_k if block_k is not None else base["block_k"]}


def _on_cuda(*tensors: torch.Tensor) -> bool:
    if all(t.is_cuda for t in tensors):
        return True
    if all(t.is_cpu for t in tensors):
        return False
    kinds = {t.device.type for t in tensors}
    raise ValueError(f"kernel inputs must all be on the CPU or all on one "
                     f"CUDA device, got {sorted(kinds)}")


def decode(q, k, v, valid):
    """BH-flat normalised decode (``ops.decode``)."""
    if not _on_cuda(q, k, v, valid):
        return ref.decode_ref(q, k, v, valid)
    out = flash_decode(q, k, v, valid)
    LAUNCHES["flash_decode"] += 1
    return out


def decode_partial(q, k, v, valid):
    """BH-flat unnormalised ``(o, m, l)`` (``ops.decode_partial``)."""
    if not _on_cuda(q, k, v, valid):
        return ref.decode_partial_ref(q, k, v, valid)
    out = flash_decode_partial(q, k, v, valid)
    LAUNCHES["flash_decode"] += 1
    return out


def decode_gqa(q, k, v, valid):
    """Grouped decode: q (B, KV, G, dh), cache (B, S, KV, dh), valid
    (B, S) -> (B, KV, G, dh)."""
    if not _on_cuda(q, k, v, valid):
        return ref.decode_gqa_ref(q, k, v, valid)
    out = flash_decode_gqa(q, k, v, valid)
    LAUNCHES["flash_decode"] += 1
    return out


def decode_gqa_partial(q, k, v, valid):
    """Grouped unnormalised partials: q (B, KV, G, dh), cache (B, S, KV,
    dh), valid (B, S) -> fp32 (o (B, KV, G, dh), m, l (B, KV, G)), the
    reference's ``_decode_partial`` on a slice of a sequence-sharded
    cache (``models/attention.py``'s decode under a mesh merges them)."""
    if not _on_cuda(q, k, v, valid):
        return ref.decode_gqa_partial_ref(q, k, v, valid)
    out = flash_decode_gqa(q, k, v, valid, normalize=False)
    LAUNCHES["flash_decode"] += 1
    return out


def decode_latent(q, c, kr, valid):
    """MLA's absorbed decode over the latent cache: q (B, 1, G, dc + dr),
    c (B, S, dc), kr (B, S, dr), valid (B, S) -> (B, 1, G, dc); key rows
    ``[c, kr]``, value rows ``c``.  Counted under ``flash_decode``, the
    TPU function it stands in for."""
    if not _on_cuda(q, c, kr, valid):
        return ref.decode_latent_ref(q, c, kr, valid)
    out = flash_decode_latent(q, c, kr, valid)
    LAUNCHES["flash_decode"] += 1
    return out


def decode_latent_partial(q, c, kr, valid):
    """``decode_latent``'s unnormalised fp32 partials over the slots given:
    (o (B, 1, G, dc), m, l (B, 1, G)), the reference's ``_decode_partial``
    on ``concat(c, kr)``; MLA's decode under a mesh merges the model
    ranks' partials of their cache slices.  Counted under
    ``flash_decode``."""
    if not _on_cuda(q, c, kr, valid):
        return ref.decode_latent_partial_ref(q, c, kr, valid)
    out = flash_decode_latent(q, c, kr, valid, normalize=False)
    LAUNCHES["flash_decode"] += 1
    return out


def attention(q, k, v, *, causal: bool = True,
              window: Optional[int] = None):
    """BH-flat causal attention (``ops.attention``)."""
    if not _on_cuda(q, k, v):
        return ref.attention_ref(q, k, v, causal=causal, window=window)
    out = flash_attention(q, k, v, causal=causal, window=window)
    LAUNCHES["flash_attention"] += 1
    return out


def attention_gqa(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None, q_offset: int = 0):
    """Grouped prefill attention: q (B, Sq, KV, G, dqk), k (B, Sk, KV,
    dqk), v (B, Sk, KV, dv) -> (B, Sq, KV, G, dv)."""
    if not _on_cuda(q, k, v):
        return ref.attention_gqa_ref(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    out = flash_attention_gqa(q, k, v, causal=causal, window=window,
                              q_offset=q_offset)
    LAUNCHES["flash_attention"] += 1
    return out


def attention_gqa_lse(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None, q_offset: int = 0):
    """``attention_gqa`` that also returns each row's log-sum-exp (B, KV,
    G, Sq) fp32, the statistic the backward saves (counted under
    ``flash_attention``)."""
    if not _on_cuda(q, k, v):
        return ref.attention_gqa_lse_ref(q, k, v, causal=causal,
                                         window=window, q_offset=q_offset)
    out = flash_attention_gqa(q, k, v, causal=causal, window=window,
                              q_offset=q_offset, return_lse=True)
    LAUNCHES["flash_attention"] += 1
    return out


def attention_gqa_bwd(q, k, v, out, lse, d_out, *, causal: bool = True,
                      window: Optional[int] = None, q_offset: int = 0):
    """(dq, dk, dv) of ``attention_gqa`` from the saved (q, k, v, out,
    lse) and the cotangent: the backward kernel on the card (one count per
    call, three launches), ``ref.attention_gqa_bwd_ref`` on the CPU."""
    if not _on_cuda(q, k, v, out, lse, d_out):
        return ref.attention_gqa_bwd_ref(q, k, v, out, lse, d_out,
                                         causal=causal, window=window,
                                         q_offset=q_offset)
    grads = flash_attention_bwd(q, k, v, out, lse, d_out, causal=causal,
                                window=window, q_offset=q_offset)
    LAUNCHES["flash_attention_bwd"] += 1
    return grads


def paged_decode(q, k_pages, v_pages, tables, lengths,
                 impl: Optional[str] = None):
    """Paged decode through per-row block tables, over the scheduler's
    (P, page, KV, dh) pools (``ops.paged_decode``): q (B, KV, G, dh),
    tables (B, NB) int32 (short rows padded with page 0), lengths (B,)
    int32 live slots -> (B, KV, G, dh).  ``impl`` (default: the tuned
    route, else "paged"): "paged" reads the pools in place through the
    tables; "gather" gathers each row's pages to a dense (B, NB * page,
    KV, dh) cache with a valid mask from ``lengths`` and runs flash
    decoding on it."""
    impl = impl or tuned_paged_impl() or "paged"
    if impl not in PAGED_IMPLS:
        raise ValueError(f"unknown paged impl {impl!r}; choose one of "
                         f"{PAGED_IMPLS}")
    if impl == "gather":
        b, nb = tables.shape
        shape = (b, nb * k_pages.shape[1]) + tuple(k_pages.shape[2:])
        k = k_pages[tables.long()].reshape(shape)
        v = v_pages[tables.long()].reshape(shape)
        valid = (torch.arange(shape[1], device=q.device)[None, :]
                 < lengths[:, None])
        return decode_gqa(q, k, v, valid)
    if not _on_cuda(q, k_pages, v_pages, tables, lengths):
        return ref.paged_decode_ref(q, k_pages, v_pages, tables, lengths)
    out = paged_flash_decode(q, k_pages, v_pages, tables, lengths)
    LAUNCHES["paged_flash_decode"] += 1
    return out


def paged_verify(q, k_pages, v_pages, tables, lengths):
    """Stacked W-query paged attention (``ops.paged_verify``): q (B, W, KV,
    G, dh); query i of row b attends slots ``<= lengths[b] - W + i``."""
    if not _on_cuda(q, k_pages, v_pages, tables, lengths):
        return ref.paged_verify_ref(q, k_pages, v_pages, tables, lengths)
    out = paged_flash_verify(q, k_pages, v_pages, tables, lengths)
    LAUNCHES["paged_flash_verify"] += 1
    return out


def matmul(x, w, *, block_m: Optional[int] = None,
           block_n: Optional[int] = None, block_k: Optional[int] = None):
    """x (M, K) @ w (K, N) -> (M, N) in x's dtype (``ops.matmul``).  The
    tiles resolve as the reference's do and must divide the shape on
    either device, else ``ValueError``."""
    m, k = x.shape
    n = w.shape[1]
    tiles = _resolve_tiles("matmul", m, k, n, block_m, block_n, block_k)
    check_tiles(m, k, n, **tiles)
    if not _on_cuda(x, w):
        return ref.matmul_ref(x, w)
    out = streamed_matmul(x, w, **tiles)
    LAUNCHES["streamed_matmul"] += 1
    return out


def quant_matmul(x, w_q, scale, bits: int = 8, *,
                 block_m: Optional[int] = None,
                 block_n: Optional[int] = None,
                 block_k: Optional[int] = None):
    """x (M, K) @ (w_q dequantized, times ``scale`` per column) -> (M, N)
    in x's dtype (``ops.quant_matmul``): w_q int8 (K, N) for ``bits=8``,
    nibble-packed uint8 (ceil(K/2), N) for ``bits=4``; scale f32 (N,).

    Tiles resolve as the reference's do (for int4 an odd ``block_k``
    falls back to the default).  Unlike ``matmul``, the kernel takes any
    shape: the serving path runs it on every linear, the vocabulary head's
    ragged width included, which the reference never does.  So only tiles
    the caller passes are held to the divisibility contract; without
    them, a tuned entry that divides the shape picks the kernel's variant
    and anything else takes its own (``quant_matmul.DEFAULT_CTA``).
    Untuned and without tiles (the serving path), no tile is resolved:
    the call goes straight to the kernel's launcher, which checks its
    inputs once."""
    explicit = (block_m, block_n, block_k) != (None, None, None)
    tuned = _TUNED["quant_matmul"]
    tiles = None
    if explicit or tuned is not None:
        m, k = x.shape
        n = w_q.shape[1]
        t = _resolve_tiles("quant_matmul", m, k, n, block_m, block_n,
                           block_k)
        if bits == 4 and min(t["block_k"], k) % 2:
            t["block_k"] = _DEFAULT_TILES["block_k"]
        if explicit:
            bk = check_tiles(m, k, n, **t)[2]
            if bits == 4 and bk % 2:
                raise ValueError(f"quant_matmul: int4 needs an even "
                                 f"block_k, got {bk}")
        if explicit or _divides(tuned, m, k, n):
            tiles = (t["block_m"], t["block_n"], t["block_k"])
    if not _on_cuda(x, w_q, scale):
        return ref.quant_matmul_ref(x, w_q, scale, bits=bits)
    out = _quant_matmul(x, w_q, scale, bits, tiles)
    LAUNCHES["quantized_matmul"] += 1
    return out


def quant_matmul_heads(x, w_q, scale, bits: int, n: int,
                       trans: bool = False):
    """H heads in one call: x (M, H, K) @ per-head slices of the quantized
    weight -> (M, H, N) in x's dtype (``quant_matmul.quant_matmul_batched``;
    ``trans`` for a weight whose per-head block is (N, K) with its scales
    along K).  One launch for all heads, counted under
    ``quantized_matmul``."""
    batched_dims(x.shape, w_q.shape, n, bits, trans)
    if not _on_cuda(x, w_q, scale):
        return ref.quant_matmul_batched_ref(x, w_q, scale, n, bits=bits,
                                            trans=trans)
    out = quant_matmul_batched(x, w_q, scale, bits, n, trans)
    LAUNCHES["quantized_matmul"] += 1
    return out
