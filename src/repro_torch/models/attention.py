"""GQA attention (full / sliding-window): prefill, single-token decode,
and paged decode / stacked verify against page pools.

PyTorch port of the GQA part of ``repro/models/attention.py``.  Prefill
attention runs the hand-written flash-attention kernel, decode the
flash-decoding kernel and paged attention the paged decode / verify
kernels, all through ``kernels.ops`` (which takes their plain PyTorch
versions for CPU tensors); ``attn_impl=None`` asks for the plain versions
explicitly on any device.

Decode keeps the ragged ``(B,)`` position vector on the device through
the cache write and the valid mask: the only host round trip in a decode
round is the scheduler's token readback.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import ops, ref
from repro_torch.models import common
from repro_torch.models.config import ModelConfig

KERNEL = "cuda"   # attn_impl value selecting the hand-written kernels


# ===========================================================================
# Parameter initialisation
# ===========================================================================
def gqa_init(rng, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.dtype
    p = {"w_q": common.dense_init(rng, d, h * dh, dt),
         "w_k": common.dense_init(rng, d, kv * dh, dt),
         "w_v": common.dense_init(rng, d, kv * dh, dt),
         "w_o": common.dense_init(rng, h * dh, d, dt)}
    if cfg.qkv_bias:
        p["b_q"] = np.zeros((h * dh,), dt)
        p["b_k"] = np.zeros((kv * dh,), dt)
        p["b_v"] = np.zeros((kv * dh,), dt)
    return p


def check_gqa(cfg: ModelConfig) -> None:
    if cfg.attention != "gqa":
        raise NotImplementedError(
            f"{cfg.attention} attention ({cfg.name}) is not yet ported in "
            f"repro_torch")


# ===========================================================================
# Flash decoding: one query token against the cache
# ===========================================================================
def flash_decode(q, k_cache, v_cache, valid, impl: Optional[str] = None):
    """q: (B,KV,G,dh); caches: (B,S,KV,dh); valid: (B,S) -> (B,KV,G,dh).

    ``impl=KERNEL`` runs the flash-decoding kernel (its plain version for
    CPU tensors); ``None`` runs the plain partials and their combine (the
    reference's ``_decode_partial``/``_combine_partials``, which live in
    ``kernels/ref.py``)."""
    if impl == KERNEL:
        return ops.decode_gqa(q, k_cache, v_cache, valid)
    return ref.decode_gqa_ref(q, k_cache, v_cache, valid)


def cache_update(cache, new, pos):
    """Write ``new`` (B, KV, dh) into ``cache`` (B, S, KV, dh) at ``pos``,
    a scalar (one slot for the whole batch) or a device (B,) vector of
    RAGGED per-row slots.

    Unlike the reference, which returns a new array, this writes IN PLACE
    and returns ``cache``: the layer's cache buffer is allocated once at
    ``total_len`` and each decode step fills one slot."""
    if isinstance(pos, int) or (torch.is_tensor(pos) and pos.ndim == 0):
        cache[:, pos] = new.to(cache.dtype)
        return cache
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, pos] = new.to(cache.dtype)
    return cache


# ===========================================================================
# GQA block: prefill + decode
# ===========================================================================
def _project_qkv(params, x, cfg: ModelConfig):
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ params["w_q"]
    k = x @ params["w_k"]
    v = x @ params["w_v"]
    if cfg.qkv_bias:
        q, k, v = q + params["b_q"], k + params["b_k"], v + params["b_v"]
    return (q.reshape(b, s, h, dh), k.reshape(b, s, kv, dh),
            v.reshape(b, s, kv, dh))


def prefill_attention(q, k, v, *, causal: bool, window: Optional[int],
                      impl: Optional[str]):
    """q: (B,Sq,KV,G,dh), k/v: (B,Sk,KV,dh) -> (B,Sq,KV,G,dh)."""
    if impl == KERNEL:
        return ops.attention_gqa(q, k, v, causal=causal, window=window)
    return ref.attention_gqa_ref(q, k, v, causal=causal, window=window)


def gqa_prefill(params, x, cfg: ModelConfig, positions, *, causal=True,
                make_cache=True, attn_impl: Optional[str] = None):
    """x: (B,S,D) -> (out (B,S,D), cache | None)."""
    b, s, _ = x.shape
    kv, g, dh = cfg.n_kv_heads, cfg.q_heads_per_kv, cfg.head_dim
    q, k, v = _project_qkv(params, x, cfg)
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)
    qg = q.reshape(b, s, kv, g, dh)
    out = prefill_attention(qg.contiguous(), k.contiguous(), v.contiguous(),
                            causal=causal, window=cfg.sliding_window,
                            impl=attn_impl)
    out = out.reshape(b, s, kv * g * dh) @ params["w_o"]
    cache = {"k": k, "v": v} if make_cache else None
    return out, cache


def decode_valid(cfg: ModelConfig, pos_b: torch.Tensor, s_cache: int):
    """(B, S) bool mask of the cache slots the new token attends."""
    idx = torch.arange(s_cache, device=pos_b.device)[None, :]
    if cfg.sliding_window is not None and cfg.sliding_window < s_cache:
        # full-length cache, windowed mask (writes are positional)
        return (idx <= pos_b) & (idx > pos_b - cfg.sliding_window)
    if cfg.sliding_window is not None:
        # ring cache at window size: every written slot is a valid key
        return idx < torch.clamp(pos_b + 1, max=s_cache)
    return idx <= pos_b


def gqa_decode(params, x, cfg: ModelConfig, cache, pos, *,
               attn_impl: Optional[str] = None):
    """x: (B,1,D); cache{k,v}: (B,S,KV,dh); pos: int or RAGGED (B,) device
    vector of per-row cache positions -> (out, cache)."""
    b = x.shape[0]
    kv, g, dh = cfg.n_kv_heads, cfg.q_heads_per_kv, cfg.head_dim
    if torch.is_tensor(pos) and pos.ndim:
        pos_b = pos.reshape(b, 1)
    else:
        pos_b = torch.full((b, 1), int(pos), dtype=torch.long,
                           device=x.device)
    q, k, v = _project_qkv(params, x, cfg)
    q = common.apply_rope(q, pos_b, cfg.rope_theta)
    k = common.apply_rope(k, pos_b, cfg.rope_theta)
    s_cache = cache["k"].shape[1]
    write_idx = pos % s_cache                       # ring buffer for windows
    k_cache = cache_update(cache["k"], k[:, 0], write_idx)
    v_cache = cache_update(cache["v"], v[:, 0], write_idx)
    valid = decode_valid(cfg, pos_b, s_cache).expand(b, s_cache).contiguous()
    qh = q.reshape(b, kv, g, dh).contiguous()
    out = flash_decode(qh, k_cache, v_cache, valid, impl=attn_impl)
    out = out.reshape(b, 1, kv * g * dh) @ params["w_o"]
    return out, {"k": k_cache, "v": v_cache}



# ===========================================================================
# Paged decode / stacked verify against (P, page, KV, dh) page pools
# ===========================================================================
def _gather_cache(pool, tables):
    """The rows' pages as the logically contiguous cache (B, NB*page, ...)."""
    b, nb = tables.shape
    return pool[tables].reshape((b, nb * pool.shape[1])
                                + tuple(pool.shape[2:]))


def gqa_decode_paged(params, x, cfg: ModelConfig, pools, tables, pos, *,
                     attn_impl: Optional[str] = None):
    """GQA decode against the PAGED cache: pools{k,v}: (P, page, KV, dh);
    tables: (B, NB) int32 block tables on the device (short rows padded
    with page 0); pos: (B,) device vector of ragged positions.

    The new token's K/V is written IN PLACE into its page
    (``tables[b, pos // page]``, slot ``pos % page``; the scheduler
    copy-on-writes shared pages at the round boundary, so that page is
    private).  ``attn_impl=KERNEL`` runs the paged decode kernel through
    ``ops.paged_decode``; ``None`` gathers the row's pages into the
    logically contiguous cache and runs the plain decode over it.  Full
    causal attention only."""
    b = x.shape[0]
    kv, g, dh = cfg.n_kv_heads, cfg.q_heads_per_kv, cfg.head_dim
    page, nb = pools["k"].shape[1], tables.shape[1]
    posv = pos.reshape(b)
    pos_b = posv.reshape(b, 1)
    q, k, v = _project_qkv(params, x, cfg)
    q = common.apply_rope(q, pos_b, cfg.rope_theta)
    k = common.apply_rope(k, pos_b, cfg.rope_theta)
    pids = tables[torch.arange(b, device=x.device), posv // page]
    pools["k"][pids, posv % page] = k[:, 0].to(pools["k"].dtype)
    pools["v"][pids, posv % page] = v[:, 0].to(pools["v"].dtype)
    qh = q.reshape(b, kv, g, dh).contiguous()
    if attn_impl == KERNEL:
        out = ops.paged_decode(qh, pools["k"], pools["v"], tables,
                               (posv + 1).to(torch.int32))
    else:
        valid = torch.arange(nb * page, device=x.device)[None, :] <= pos_b
        out = flash_decode(qh, _gather_cache(pools["k"], tables),
                           _gather_cache(pools["v"], tables),
                           valid.contiguous(), impl=None)
    out = out.reshape(b, 1, kv * g * dh) @ params["w_o"]
    return out, pools


def gqa_verify_paged(params, x, cfg: ModelConfig, pools, tables, pos, *,
                     attn_impl: Optional[str] = None):
    """Stacked W-token GQA decode against the PAGED cache (speculative
    verify, and chunked prefill at W = the chunk width).

    ``x``: (B, W, D), W consecutive tokens per row; ``pos``: (B,) cache
    slot of the FIRST stacked token.  All W tokens' K/V are written into
    their pages in place first, then query i attends causally up to its
    own slot ``pos + i``.  ``attn_impl=KERNEL`` runs the paged verify
    kernel; ``None`` flattens (B, W) into the batch and runs the plain
    decode over the gathered cache, as the reference's jnp path does."""
    b, w, _ = x.shape
    kv, g, dh = cfg.n_kv_heads, cfg.q_heads_per_kv, cfg.head_dim
    page, nb = pools["k"].shape[1], tables.shape[1]
    posv = pos.reshape(b)
    positions = posv[:, None] + torch.arange(w, device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, cfg)
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)
    rows = torch.arange(b, device=x.device)[:, None]
    pids = tables[rows, positions // page]                      # (B, W)
    pools["k"][pids, positions % page] = k.to(pools["k"].dtype)
    pools["v"][pids, positions % page] = v.to(pools["v"].dtype)
    qh = q.reshape(b, w, kv, g, dh).contiguous()
    if attn_impl == KERNEL:
        out = ops.paged_verify(qh, pools["k"], pools["v"], tables,
                               (posv + w).to(torch.int32))
    else:
        s_tot = nb * page
        kc = _gather_cache(pools["k"], tables)
        vc = _gather_cache(pools["v"], tables)
        valid = (torch.arange(s_tot, device=x.device)[None, None, :]
                 <= positions[:, :, None])                      # (B, W, S)
        kf = kc[:, None].expand(b, w, s_tot, kv, dh).reshape(
            b * w, s_tot, kv, dh)
        vf = vc[:, None].expand(b, w, s_tot, kv, dh).reshape(
            b * w, s_tot, kv, dh)
        out = flash_decode(qh.reshape(b * w, kv, g, dh), kf, vf,
                           valid.reshape(b * w, s_tot), impl=None)
        out = out.reshape(b, w, kv, g, dh)
    out = out.reshape(b, w, kv * g * dh) @ params["w_o"]
    return out, pools
