"""GQA attention (full / sliding-window): prefill, single-token decode,
and paged decode / stacked verify against page pools; and MLA
(multi-head latent attention, MiniCPM3 / DeepSeek style): prefill and
the absorbed-matrix decode over the latent cache.

PyTorch port of the GQA and MLA parts of ``repro/models/attention.py``.
Prefill attention runs the hand-written flash-attention kernel (MLA's at
q / k 96 and v 64), decode the flash-decoding kernel (MLA's on its
latent cache) and paged attention the paged decode / verify kernels, all
through ``kernels.ops`` (which takes their plain PyTorch
versions for CPU tensors); ``attn_impl=None`` asks for the plain versions
explicitly on any device.  The projections go through ``common.linear``
with the same ``attn_impl``, which runs the quantized matmul kernel for an
int8/int4 weight; MLA's ``W_uk`` absorption and ``W_uv`` un-absorption
are ``torch.einsum`` on float weights, as the reference computes them
outside Pallas, and on int8/int4 weights one batched quantized matmul
launch each for all heads (``ops.quant_matmul_heads``), so no dequantized
copy of either weight is built.

Training: when autograd records, prefill attention runs
``flash_attention_train``, the port of the reference's custom-VJP flash
attention (``_flash_fn``): the forward saves (q, k, v, out, lse) and the
backward recomputes from them, on the card through the hand-written
backward kernel (``ops.attention_gqa_bwd``).  ``gqa_mrope_prefill`` and
``gqa_decode``'s ``mrope_positions3`` take the VLM's 3-section M-RoPE
positions.

Decode keeps the ragged ``(B,)`` position vector on the device through
the cache write and the valid mask: the only host round trip in a decode
round is the scheduler's token readback.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.checkpoint.quant import QuantizedTensor
from repro_torch.kernels import ops, ref
from repro_torch.models import common
from repro_torch.models.config import ModelConfig

KERNEL = common.KERNEL   # attn_impl value selecting the hand-written kernels


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
        p["b_q"] = common.zeros((h * dh,), dt)
        p["b_k"] = common.zeros((kv * dh,), dt)
        p["b_v"] = common.zeros((kv * dh,), dt)
    return p


def mla_init(rng, cfg: ModelConfig) -> dict:
    d, h, dt = cfg.d_model, cfg.n_heads, cfg.dtype
    dq, dc = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.v_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    return {"w_dq": common.dense_init(rng, d, dq, dt),
            "q_norm": common.ones((dq,), dt),
            "w_uq_nope": common.dense_init(rng, dq, h * dn, dt),
            "w_uq_rope": common.dense_init(rng, dq, h * dr, dt),
            "w_dkv": common.dense_init(rng, d, dc, dt),
            "kv_norm": common.ones((dc,), dt),
            "w_kr": common.dense_init(rng, d, dr, dt),
            "w_uk": common.dense_init(rng, dc, h * dn, dt),
            "w_uv": common.dense_init(rng, dc, h * dv, dt),
            "w_o": common.dense_init(rng, h * dv, d, dt)}


def attn_init(rng, cfg: ModelConfig) -> dict:
    return mla_init(rng, cfg) if cfg.attention == "mla" else gqa_init(rng,
                                                                      cfg)


ATTENTIONS = ("gqa", "mla")


def check_attention(cfg: ModelConfig) -> None:
    if cfg.attention not in ATTENTIONS:
        raise NotImplementedError(
            f"{cfg.attention} attention ({cfg.name}) is not yet ported in "
            f"repro_torch")


def empty_cache(cfg: ModelConfig, batch: int, seq: int, dtype=None,
                device="cpu") -> dict:
    """One layer's zeroed cache: GQA {k, v} (batch, seq, KV, dh), MLA
    {c (batch, seq, kv_lora_rank), kr (batch, seq, rope_head_dim)}
    (``gqa_empty_cache`` / ``mla_empty_cache``).  A page pool is the same
    layout with (pages, page size) leading."""
    dt = dtype or cfg.torch_dtype
    if cfg.attention == "mla":
        dims = {"c": (cfg.kv_lora_rank,), "kr": (cfg.rope_head_dim,)}
    else:
        dims = dict.fromkeys(("k", "v"), (cfg.n_kv_heads, cfg.head_dim))
    return {k: torch.zeros((batch, seq) + d, dtype=dt, device=device)
            for k, d in dims.items()}


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
    """Write ``new`` (B, ...) into ``cache`` (B, S, ...) at ``pos``, a
    scalar (one slot for the whole batch) or a device (B,) vector of
    RAGGED per-row slots: GQA's (B, KV, dh) rows, or MLA's (B, F) latent
    and rope rows (the reference's ``_cache_update_2d``).

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
def _project_qkv(params, x, cfg: ModelConfig, impl: Optional[str] = None):
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = common.linear(x, params["w_q"], impl)
    k = common.linear(x, params["w_k"], impl)
    v = common.linear(x, params["w_v"], impl)
    if cfg.qkv_bias:
        q, k, v = q + params["b_q"], k + params["b_k"], v + params["b_v"]
    return (q.reshape(b, s, h, dh), k.reshape(b, s, kv, dh),
            v.reshape(b, s, kv, dh))


class _FlashAttention(torch.autograd.Function):
    """Prefill attention whose backward recomputes from the saved
    (q, k, v, out, lse): the hand-written kernels (``kernel=True``; their
    plain versions for CPU tensors) or the plain versions on any device."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, kernel):
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        fwd = ops.attention_gqa_lse if kernel else ref.attention_gqa_lse_ref
        out, lse = fwd(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw, ctx.kernel = kw, kernel
        return out

    @staticmethod
    def backward(ctx, d_out):
        bwd = (ops.attention_gqa_bwd if ctx.kernel
               else ref.attention_gqa_bwd_ref)
        dq, dk, dv = bwd(*ctx.saved_tensors, d_out.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention_train(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None, q_offset: int = 0,
                          impl: Optional[str] = None):
    """Differentiable prefill attention (the reference's ``_flash_fn``):
    q (B,Sq,KV,G,dqk), k (B,Sk,KV,dqk), v (B,Sk,KV,dv) -> (B,Sq,KV,G,dv)."""
    return _FlashAttention.apply(q, k, v, causal, window, q_offset,
                                 impl == KERNEL)


def prefill_attention(q, k, v, *, causal: bool, window: Optional[int],
                      impl: Optional[str]):
    """q: (B,Sq,KV,G,dh), k/v: (B,Sk,KV,dh) -> (B,Sq,KV,G,dh).  Through
    ``flash_attention_train`` when autograd records q, k or v."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return flash_attention_train(q, k, v, causal=causal, window=window,
                                     impl=impl)
    if impl == KERNEL:
        return ops.attention_gqa(q, k, v, causal=causal, window=window)
    return ref.attention_gqa_ref(q, k, v, causal=causal, window=window)


def gqa_prefill(params, x, cfg: ModelConfig, positions, *, causal=True,
                make_cache=True, attn_impl: Optional[str] = None):
    """x: (B,S,D) -> (out (B,S,D), cache | None)."""
    b, s, _ = x.shape
    kv, g, dh = cfg.n_kv_heads, cfg.q_heads_per_kv, cfg.head_dim
    q, k, v = _project_qkv(params, x, cfg, attn_impl)
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)
    qg = q.reshape(b, s, kv, g, dh)
    out = prefill_attention(qg.contiguous(), k.contiguous(), v.contiguous(),
                            causal=causal, window=cfg.sliding_window,
                            impl=attn_impl)
    out = common.linear(out.reshape(b, s, kv * g * dh), params["w_o"],
                        attn_impl)
    cache = {"k": k, "v": v} if make_cache else None
    return out, cache


def gqa_mrope_prefill(params, x, cfg: ModelConfig, positions3, *,
                      make_cache=True, attn_impl: Optional[str] = None):
    """Qwen2-VL style prefill with 3-section M-RoPE positions (3, B, S):
    ``gqa_prefill`` with ``common.apply_mrope`` in place of RoPE."""
    b, s, _ = x.shape
    kv, g, dh = cfg.n_kv_heads, cfg.q_heads_per_kv, cfg.head_dim
    q, k, v = _project_qkv(params, x, cfg, attn_impl)
    q = common.apply_mrope(q, positions3, cfg.mrope_sections, cfg.rope_theta)
    k = common.apply_mrope(k, positions3, cfg.mrope_sections, cfg.rope_theta)
    qg = q.reshape(b, s, kv, g, dh)
    out = prefill_attention(qg.contiguous(), k.contiguous(), v.contiguous(),
                            causal=True, window=cfg.sliding_window,
                            impl=attn_impl)
    out = common.linear(out.reshape(b, s, kv * g * dh), params["w_o"],
                        attn_impl)
    cache = {"k": k, "v": v} if make_cache else None
    return out, cache


def _pos_column(pos, b: int, device) -> torch.Tensor:
    """``pos`` (an int or a ragged (B,) device vector) as a (B, 1) long
    column."""
    if torch.is_tensor(pos) and pos.ndim:
        return pos.reshape(b, 1)
    return torch.full((b, 1), int(pos), dtype=torch.long, device=device)


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
               mrope_positions3=None, attn_impl: Optional[str] = None):
    """x: (B,1,D); cache{k,v}: (B,S,KV,dh); pos: int or RAGGED (B,) device
    vector of per-row cache positions -> (out, cache).  A VLM's text token
    takes its (3, B, 1) M-RoPE ids as ``mrope_positions3``."""
    b = x.shape[0]
    kv, g, dh = cfg.n_kv_heads, cfg.q_heads_per_kv, cfg.head_dim
    pos_b = _pos_column(pos, b, x.device)
    q, k, v = _project_qkv(params, x, cfg, attn_impl)
    if mrope_positions3 is not None:
        q = common.apply_mrope(q, mrope_positions3, cfg.mrope_sections,
                               cfg.rope_theta)
        k = common.apply_mrope(k, mrope_positions3, cfg.mrope_sections,
                               cfg.rope_theta)
    else:
        q = common.apply_rope(q, pos_b, cfg.rope_theta)
        k = common.apply_rope(k, pos_b, cfg.rope_theta)
    s_cache = cache["k"].shape[1]
    write_idx = pos % s_cache                       # ring buffer for windows
    k_cache = cache_update(cache["k"], k[:, 0], write_idx)
    v_cache = cache_update(cache["v"], v[:, 0], write_idx)
    valid = decode_valid(cfg, pos_b, s_cache).expand(b, s_cache).contiguous()
    qh = q.reshape(b, kv, g, dh).contiguous()
    out = flash_decode(qh, k_cache, v_cache, valid, impl=attn_impl)
    out = common.linear(out.reshape(b, 1, kv * g * dh), params["w_o"],
                        attn_impl)
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
    q, k, v = _project_qkv(params, x, cfg, attn_impl)
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
    out = common.linear(out.reshape(b, 1, kv * g * dh), params["w_o"],
                        attn_impl)
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
    q, k, v = _project_qkv(params, x, cfg, attn_impl)
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
    out = common.linear(out.reshape(b, w, kv * g * dh), params["w_o"],
                        attn_impl)
    return out, pools


# ===========================================================================
# MLA (multi-head latent attention): prefill + absorbed-matrix decode
# ===========================================================================
def mla_prefill(params, x, cfg: ModelConfig, positions, *, make_cache=True,
                attn_impl: Optional[str] = None):
    """x: (B,S,D) -> (out (B,S,D), cache {c (B,S,dc), kr (B,S,dr)} | None).
    Per-head q / k of width dn + dr (the rope half shared by every head's
    key) against v of width dv: one causal ``prefill_attention`` over
    n_heads KV heads of one query each, scaled by 1/sqrt(dn + dr)."""
    b, s, _ = x.shape
    h, dn, dr, dv = (cfg.n_heads, cfg.v_head_dim, cfg.rope_head_dim,
                     cfg.v_head_dim)
    qc = common.rms_norm(common.linear(x, params["w_dq"], attn_impl),
                         params["q_norm"], cfg.norm_eps)
    q_nope = common.linear(qc, params["w_uq_nope"], attn_impl).reshape(
        b, s, h, dn)
    q_rope = common.apply_rope(common.linear(
        qc, params["w_uq_rope"], attn_impl).reshape(b, s, h, dr), positions,
        cfg.rope_theta)
    c = common.rms_norm(common.linear(x, params["w_dkv"], attn_impl),
                        params["kv_norm"], cfg.norm_eps)
    k_rope = common.apply_rope(common.linear(
        x, params["w_kr"], attn_impl).reshape(b, s, 1, dr), positions,
        cfg.rope_theta)
    k_nope = common.linear(c, params["w_uk"], attn_impl).reshape(b, s, h, dn)
    v = common.linear(c, params["w_uv"], attn_impl).reshape(b, s, h, dv)
    q_full = torch.cat([q_nope, q_rope], -1)               # (B,S,H,dn+dr)
    k_full = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], -1)
    out = prefill_attention(q_full.reshape(b, s, h, 1, dn + dr), k_full,
                            v.contiguous(), causal=True, window=None,
                            impl=attn_impl)
    out = common.linear(out.reshape(b, s, h * dv), params["w_o"], attn_impl)
    cache = {"c": c, "kr": k_rope[:, :, 0]} if make_cache else None
    return out, cache


def latent_decode(q, c_cache, kr_cache, valid, impl: Optional[str] = None):
    """q (B, 1, G, dc + dr) against the latent cache -> (B, 1, G, dc).
    ``impl=KERNEL`` runs the flash-decoding kernel's latent layout (its
    plain version for CPU tensors); ``None`` the plain version, the
    reference's jnp decode over ``concat(c, kr)``."""
    if impl == KERNEL:
        return ops.decode_latent(q, c_cache, kr_cache, valid)
    return ref.decode_latent_ref(q, c_cache, kr_cache, valid)


def absorb_heads(x, w, n: int, *, trans: bool,
                 impl: Optional[str] = None):
    """MLA decode's per-head products with one (K, H N) or, ``trans``,
    (N, H K) weight: x (B, H, K) -> (B, H, N).  Without ``trans`` head h
    multiplies the columns [h N, (h + 1) N) (W_uv); with it, the transpose
    of the columns [h K, (h + 1) K) (W_uk).  A float weight is the
    reference's einsum; an int8/int4 one runs the batched quantized matmul
    (one launch for all heads, ``impl=KERNEL``) or its plain version."""
    b, h, k = x.shape
    if not isinstance(w, QuantizedTensor):
        if trans:
            return torch.einsum("bhk,nhk->bhn", x, w.reshape(n, h, k))
        return torch.einsum("bhk,khn->bhn", x, w.reshape(k, h, n))
    if impl == KERNEL:
        return ops.quant_matmul_heads(x.contiguous(), w.q, w.scale, w.bits,
                                      n, trans)
    return ref.quant_matmul_batched_ref(x, w.q, w.scale, n, bits=w.bits,
                                        trans=trans)


def mla_decode(params, x, cfg: ModelConfig, cache, pos, *,
               attn_impl: Optional[str] = None):
    """Absorbed-matrix MLA decode over the latent cache: x (B,1,D); cache
    {c (B,S,dc), kr (B,S,dr)}, written IN PLACE at ``pos`` (an int or a
    RAGGED (B,) device vector) -> (out, cache).  The latent cache is one
    virtual KV head of width dc + dr attended by all n_heads queries;
    W_uk is absorbed into the query and W_uv into the output, so decode
    never expands per-head K/V."""
    b = x.shape[0]
    h, dn, dr = cfg.n_heads, cfg.v_head_dim, cfg.rope_head_dim
    dc, dv = cfg.kv_lora_rank, cfg.v_head_dim
    pos_b = _pos_column(pos, b, x.device)
    qc = common.rms_norm(common.linear(x, params["w_dq"], attn_impl),
                         params["q_norm"], cfg.norm_eps)
    q_nope = common.linear(qc, params["w_uq_nope"], attn_impl).reshape(
        b, 1, h, dn)
    q_rope = common.apply_rope(common.linear(
        qc, params["w_uq_rope"], attn_impl).reshape(b, 1, h, dr), pos_b,
        cfg.rope_theta)
    # absorb W_uk: q_abs[h] = q_nope[h] @ W_uk[h].T, into the latent space
    q_abs = absorb_heads(q_nope[:, 0], params["w_uk"], dc, trans=True,
                         impl=attn_impl)                       # (B,H,dc)
    q_eff = torch.cat([q_abs, q_rope[:, 0]], -1)               # (B,H,dc+dr)
    c_new = common.rms_norm(common.linear(x, params["w_dkv"], attn_impl),
                            params["kv_norm"], cfg.norm_eps)[:, 0]
    kr_new = common.apply_rope(common.linear(
        x, params["w_kr"], attn_impl).reshape(b, 1, 1, dr), pos_b,
        cfg.rope_theta)[:, 0, 0]
    c_cache = cache_update(cache["c"], c_new, pos)
    kr_cache = cache_update(cache["kr"], kr_new, pos)
    s_cache = c_cache.shape[1]
    valid = decode_valid(cfg, pos_b, s_cache).expand(b, s_cache).contiguous()
    o_lat = latent_decode(q_eff[:, None].contiguous(), c_cache, kr_cache,
                          valid, impl=attn_impl)               # (B,1,H,dc)
    # un-absorb W_uv: out[h] = o_lat[h] @ W_uv[h]
    out = absorb_heads(o_lat[:, 0], params["w_uv"], dv, trans=False,
                       impl=attn_impl).reshape(b, 1, h * dv)
    out = common.linear(out, params["w_o"], attn_impl)
    return out, {"c": c_cache, "kr": kr_cache}
