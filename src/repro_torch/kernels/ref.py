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
# Streamed matmul
# ---------------------------------------------------------------------------
def matmul_ref(x, w):
    """x (M, K) @ w (K, N) in fp32 -> (M, N) in x's dtype."""
    return (x.float() @ w.float()).to(x.dtype)


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
    """Grouped normalised decode: (B, KV, G, dv) in v's dtype (k and q may
    be wider than v)."""
    o, m, l = decode_gqa_partial_ref(q, k, v, valid)
    return combine_partials(o[None], m[None], l[None]).to(v.dtype)


def decode_latent_partial_ref(q, c, kr, valid):
    """The unnormalised partials of ``decode_latent_ref``: q (B, 1, G,
    dc + dr); c (B, S, dc); kr (B, S, dr); valid (B, S) -> fp32 (o (B, 1,
    G, dc), m, l (B, 1, G)), ``_decode_partial`` on key rows ``concat(c,
    kr)`` and value rows ``c``."""
    return decode_gqa_partial_ref(q, torch.cat([c, kr], -1)[:, :, None],
                                  c[:, :, None], valid)


def decode_latent_ref(q, c, kr, valid):
    """MLA's absorbed decode as the reference's ``mla_decode`` computes it:
    one virtual KV head with key rows ``concat(c, kr)`` and value rows
    ``c``, through ``_decode_partial`` / ``_combine_partials``.  q (B, 1,
    G, dc + dr); c (B, S, dc); kr (B, S, dr); valid (B, S) -> (B, 1, G, dc)
    in c's dtype."""
    k = torch.cat([c, kr], -1)[:, :, None]
    return decode_gqa_ref(q, k, c[:, :, None], valid)


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
    """Grouped layout of ``gqa_prefill`` / ``mla_prefill``.  q: (B, Sq, KV,
    G, dqk); k: (B, Sk, KV, dqk); v: (B, Sk, KV, dv) -> (B, Sq, KV, G, dv)
    in v's dtype (``chunked_attention``'s dhq / dhv)."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqkgd,bpkd->bkgqp", q.float() * scale, k.float())
    ok = _mask(q.shape[1], k.shape[1], causal, window, q_offset, q.device)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqp,bpkd->bqkgd", p, v.float())
    return out.to(v.dtype)


def attention_gqa_lse_ref(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None, q_offset: int = 0):
    """``attention_gqa_ref`` with the statistic the backward saves: (out
    (B, Sq, KV, G, dv) in v's dtype, lse (B, KV, G, Sq) fp32, the natural
    log-sum-exp ``m + log(max(l, 1e-30))`` of each row's masked scores),
    as ``_flash_fn``'s forward pass returns them."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqkgd,bpkd->bkgqp", q.float() * scale, k.float())
    ok = _mask(q.shape[1], k.shape[1], causal, window, q_offset, q.device)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = torch.clamp(p.sum(-1), min=1e-30)
    out = torch.einsum("bkgqp,bpkd->bqkgd", p / l[..., None], v.float())
    return out.to(v.dtype), m + torch.log(l)


def attention_gqa_bwd_ref(q, k, v, out, lse, d_out, *, causal: bool = True,
                          window: Optional[int] = None, q_offset: int = 0):
    """(dq, dk, dv) of ``attention_gqa_ref`` from the saved (q, k, v, out,
    lse) and the cotangent ``d_out``, step by step as the reference's
    recompute VJP (``_flash_fn``'s ``f_bwd``) computes them, over the
    whole sequence at once: ``qs = q * scale`` (in q's dtype); ``delta =
    rowsum(d_out * out)``; ``P = exp(qs k^T + bias - lse)`` with the
    additive ``-1e30`` mask bias; ``dP = d_out v^T``; ``dS = P (dP -
    delta)``; ``dq = dS k * scale``, ``dk = dS^T qs``, ``dv = P^T d_out``
    (GQA's G query heads summed into dk and dv), each in its input's
    dtype."""
    scale = torch.tensor(1.0 / (q.shape[-1] ** 0.5), dtype=q.dtype)
    qs = q * scale.to(q.device)
    delta = torch.einsum("bqkgd,bqkgd->bkgq", d_out.float(), out.float())
    d_out = d_out.to(v.dtype)
    s = torch.einsum("bqkgd,bpkd->bkgqp", qs.float(), k.float())
    ok = _mask(q.shape[1], k.shape[1], causal, window, q_offset, q.device)
    s = s + torch.where(ok, 0.0, NEG_INF)
    p = torch.exp(s - lse[..., None])                     # (B,KV,G,Sq,Sk)
    dp = torch.einsum("bqkgd,bpkd->bkgqp", d_out.float(), v.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bkgqp,bpkd->bqkgd", ds.to(k.dtype).float(),
                      k.float()) * scale.float().item()
    dv = torch.einsum("bkgqp,bqkgd->bpkd", p.to(q.dtype).float(),
                      d_out.float())
    dk = torch.einsum("bkgqp,bqkgd->bpkd", ds.to(q.dtype).float(),
                      qs.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Paged decode / stacked-query verify through block tables
# ---------------------------------------------------------------------------
def _gather_pages(pages, tables):
    """(P, page, KV, dh) pool rows of each table -> the logically
    contiguous cache (B, NB * page, KV, dh)."""
    b, nb = tables.shape
    return pages[tables.long()].reshape((b, nb * pages.shape[1])
                                        + tuple(pages.shape[2:]))


def paged_decode_ref(q, k_pages, v_pages, tables, lengths):
    """Densify the block-table gather, then the masked grouped softmax.
    q: (B, KV, G, dh); pools: (P, page, KV, dh); tables: (B, NB) page ids;
    lengths: (B,) live slots per row -> (B, KV, G, dh) in v's dtype."""
    k = _gather_pages(k_pages, tables)
    v = _gather_pages(v_pages, tables)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bkgd,bskd->bkgs", q.float() * scale, k.float())
    valid = (torch.arange(k.shape[1], device=q.device)[None, :]
             < lengths.to(q.device)[:, None])
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bskd->bkgd", p, v.float()).to(v_pages.dtype)


def paged_verify_ref(q, k_pages, v_pages, tables, lengths):
    """W stacked queries per row: q (B, W, KV, G, dh); query ``i`` sits at
    slot ``lengths[b] - W + i`` and attends slots up to it.  W=1 is
    ``paged_decode_ref``.  -> (B, W, KV, G, dh) in v's dtype."""
    w = q.shape[1]
    k = _gather_pages(k_pages, tables)
    v = _gather_pages(v_pages, tables)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bwkgd,bskd->bwkgs", q.float() * scale, k.float())
    qpos = (lengths.to(q.device)[:, None] - w
            + torch.arange(w, device=q.device)[None, :])           # (B, W)
    valid = (torch.arange(k.shape[1], device=q.device)[None, None, :]
             <= qpos[:, :, None])
    s = torch.where(valid[:, :, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bwkgs,bskd->bwkgd", p, v.float()).to(v_pages.dtype)


# ---------------------------------------------------------------------------
# Dequantizing matmul over int8 / int4 per-channel-scaled weights
# ---------------------------------------------------------------------------
def dequant_ref(w_q, scale, *, bits: int = 8):
    """Per-channel dequantization matching ``checkpoint/quant.py``: int8
    (K, N) values, or int4 nibble-packed uint8 (K/2, N) with row 2i in the
    low nibble and 2i+1 in the high nibble, sign-extended.  Kept apart
    from ``quant.unpack_int4`` on purpose: an independent copy of the
    layout to hold the kernel against."""
    if bits == 8:
        q = w_q.float()
    else:
        p = w_q.to(torch.uint8)
        lo = (p & 0xF).to(torch.int8)
        hi = ((p >> 4) & 0xF).to(torch.int8)
        lo = torch.where(lo > 7, lo - 16, lo)
        hi = torch.where(hi > 7, hi - 16, hi)
        q = torch.stack([lo, hi], dim=1).reshape(
            (2 * p.shape[0],) + tuple(p.shape[1:])).float()
    return q * scale[None, :].float()


def quant_matmul_ref(x, w_q, scale, *, bits: int = 8):
    """x (M, K) @ dequant_ref(w_q, scale) -> (M, N) in x's dtype, in f32;
    an odd K (int4) drops the padding row."""
    w = dequant_ref(w_q, scale, bits=bits)
    return (x.float() @ w[:x.shape[-1]]).to(x.dtype)


def quant_matmul_batched_ref(x, w_q, scale, n: int, *, bits: int = 8,
                             trans: bool = False):
    """H heads of x (M, H, K) against per-head slices of
    ``dequant_ref(w_q, scale)``, in f32 -> (M, H, N) in x's dtype: the
    columns [h N, (h + 1) N) of the (K, H N) weight, or with ``trans`` the
    transpose of the columns [h K, (h + 1) K) of the (N, H K) weight, as
    the reference's ``mla_decode`` multiplies its dequantized ``w_uv`` and
    ``w_uk``."""
    _, h, k = x.shape
    if trans:
        w = dequant_ref(w_q, scale, bits=bits)[:n].reshape(n, h, k)
        out = torch.einsum("mhk,nhk->mhn", x.float(), w)
    else:
        w = dequant_ref(w_q, scale, bits=bits)[:k].reshape(k, h, n)
        out = torch.einsum("mhk,khn->mhn", x.float(), w)
    return out.to(x.dtype)
