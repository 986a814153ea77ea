"""Plain PyTorch versions of the hand-written CUDA kernels.

They mirror ``repro/kernels/ref.py`` (the JAX package's jnp oracles) and
``repro/models/attention.py``'s jnp decode partials, op for op: the CPU
path runs them, the tests hold them against the JAX package, and the
chip smoke test holds each CUDA kernel against them on the card.  Masked
scores take the reference's ``-1e30`` (not ``-inf``), so a row with no
valid key degrades the same way in both packages.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Flash decoding: one query token against a KV cache
# ---------------------------------------------------------------------------
def decode_partial_ref(q, k, v, valid):
    """BH-flat partials.  q: (BH, dh); k, v: (BH, S, dh); valid: (BH, S)
    -> unnormalised (o (BH, dh) f32, m (BH, 1), l (BH, 1))."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bd,bsd->bs", q.float() * scale, k.float())
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bs,bsd->bd", p, v.float())
    return o, m, l


def decode_ref(q, k, v, valid):
    """BH-flat normalised decode: (BH, dh) in v's dtype."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bd,bsd->bs", q.float() * scale, k.float())
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bs,bsd->bd", p, v.float()).to(v.dtype)


def decode_gqa_partial_ref(q, k, v, valid):
    """Grouped partials (``attention._decode_partial``).  q: (B, KV, G, dh);
    k, v: (B, S, KV, dh); valid: (B, S) -> (o (B, KV, G, dh), m, l (B, KV,
    G)), unnormalised, in f32."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bkgd,bskd->bkgs", q.float() * scale, k.float())
    s = s + torch.where(valid, 0.0, NEG_INF)[:, None, None, :]
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return o, m, l


def combine_partials(o, m, l):
    """Merge partials stacked on axis 0 (``attention._combine_partials``)
    -> the normalised output."""
    m_star = m.amax(0)
    w = torch.exp(m - m_star[None])
    l_star = (l * w).sum(0)
    o_star = (o * w[..., None]).sum(0)
    return o_star / torch.clamp(l_star, min=1e-30)[..., None]


def decode_gqa_ref(q, k, v, valid):
    """Grouped normalised decode: (B, KV, G, dh) in v's dtype."""
    o, m, l = decode_gqa_partial_ref(q, k, v, valid)
    return combine_partials(o[None], m[None], l[None]).to(v.dtype)


# ---------------------------------------------------------------------------
# Causal (optionally windowed) prefill attention
# ---------------------------------------------------------------------------
def _mask(sq: int, sk: int, causal: bool, window: Optional[int],
          q_offset: int, device):
    q_ids = q_offset + torch.arange(sq, device=device)[:, None]
    k_ids = torch.arange(sk, device=device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        ok &= k_ids <= q_ids
    if window is not None:
        ok &= k_ids > q_ids - window
    return ok


def attention_ref(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None):
    """BH-flat.  q: (BH, Sq, dh); k, v: (BH, Sk, dh) -> (BH, Sq, dh)."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqd,bkd->bqk", q.float() * scale, k.float())
    ok = _mask(q.shape[1], k.shape[1], causal, window, 0, q.device)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def attention_gqa_ref(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None, q_offset: int = 0):
    """Grouped layout of ``gqa_prefill``.  q: (B, Sq, KV, G, dh); k, v:
    (B, Sk, KV, dh) -> (B, Sq, KV, G, dh) in v's dtype."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqkgd,bpkd->bkgqp", q.float() * scale, k.float())
    ok = _mask(q.shape[1], k.shape[1], causal, window, q_offset, q.device)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqp,bpkd->bqkgd", p, v.float())
    return out.to(v.dtype)
