"""Public kernel wrappers: dispatch by device and count launches.

A tensor on the CPU goes to the kernel's plain PyTorch version
(``kernels/ref.py``); a tensor on a CUDA device launches the hand-written
kernel, which raises on anything it does not take.  There is no fallback
from one to the other.  ``LAUNCHES`` counts kernel launches per kernel and
nothing else (the plain versions do not count), so a run can show that
its main path went through the kernels.

Signatures follow ``repro/kernels/ops.py``; the ``*_gqa`` forms take the
grouped layouts the model code uses.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_gqa)
from repro_torch.kernels.flash_decode import (flash_decode,
                                              flash_decode_gqa,
                                              flash_decode_partial)
from repro_torch.kernels.paged_decode import (paged_flash_decode,
                                              paged_flash_verify)

LAUNCHES = {"flash_decode": 0, "flash_attention": 0,
            "paged_flash_decode": 0, "paged_flash_verify": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cuda(*tensors: torch.Tensor) -> bool:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
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
    """Grouped prefill attention: q (B, Sq, KV, G, dh), k/v (B, Sk, KV,
    dh) -> (B, Sq, KV, G, dh)."""
    if not _on_cuda(q, k, v):
        return ref.attention_gqa_ref(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    out = flash_attention_gqa(q, k, v, causal=causal, window=window,
                              q_offset=q_offset)
    LAUNCHES["flash_attention"] += 1
    return out


def paged_decode(q, k_pages, v_pages, tables, lengths):
    """Paged decode through per-row block tables, over the scheduler's
    (P, page, KV, dh) pools in place (``ops.paged_decode``): q (B, KV, G,
    dh), tables (B, NB) int32 (short rows padded with page 0), lengths
    (B,) int32 live slots -> (B, KV, G, dh)."""
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
