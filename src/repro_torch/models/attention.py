"""GQA attention (full / sliding-window): prefill, single-token decode,
and paged decode / stacked verify against page pools; cross attention
(encoder-decoder); and MLA (multi-head latent attention, MiniCPM3 /
DeepSeek style): prefill and the absorbed-matrix decode over the latent
cache.

PyTorch port of the GQA, cross-attention and MLA parts of
``repro/models/attention.py``.
Prefill attention runs the hand-written flash-attention kernel (MLA's at
q / k 96 and v 64; cross attention's non-causal at Sq != Sk, where the
reference runs its jnp ``chunked_attention``), decode the flash-decoding
kernel (MLA's on its latent cache; a cross decode over every slot of the
encoder's cache) and paged attention the paged decode / verify kernels,
all through ``kernels.ops`` (which takes their plain PyTorch
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

from repro_torch import sharding as sh
from repro_torch.checkpoint.quant import QuantizedTensor
from repro_torch.kernels import ops, ref
from repro_torch.models import common
from repro_torch.models.config import ModelConfig

KERNEL = common.KERNEL   # attn_impl value selecting the hand-written kernels


# ===========================================================================
# Parameter initialisation
# ===========================================================================
def gqa_init(rng, cfg: ModelConfig, d_model: Optional[int] = None) -> dict:
    """GQA projections from ``d_model`` (default the config's; Zamba2's
    shared block attends at twice it)."""
    d = d_model or cfg.d_model
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
                make_cache=True, attn_impl: Optional[str] = None, ctx=None):
    """x: (B,S,D) -> (out (B,S,D), cache | None).  Under a ``ctx``, see
    ``_prefill_heads``."""
    def rotate(t):
        return common.apply_rope(t, positions, cfg.rope_theta)
    return _prefill_heads(params, x, cfg, rotate, causal, make_cache,
                          attn_impl, ctx)


def gqa_mrope_prefill(params, x, cfg: ModelConfig, positions3, *,
                      make_cache=True, attn_impl: Optional[str] = None,
                      ctx=None):
    """Qwen2-VL style prefill with 3-section M-RoPE positions (3, B, S):
    ``gqa_prefill`` with ``common.apply_mrope`` in place of RoPE."""
    def rotate(t):
        return common.apply_mrope(t, positions3, cfg.mrope_sections,
                                  cfg.rope_theta)
    return _prefill_heads(params, x, cfg, rotate, True, make_cache,
                          attn_impl, ctx)


def _prefill_heads(params, x, cfg: ModelConfig, rotate, causal: bool,
                   make_cache: bool, impl: Optional[str], ctx):
    """GQA prefill with ``rotate`` applied to q and k.  Under a ``ctx``
    whose model axis holds whole KV heads per rank (``_local_heads``),
    each rank attends over its own heads and one all-reduce joins the
    row-split output projection (Megatron); otherwise the split
    projections are gathered and every rank attends over all heads.  The
    cache holds every head (gathered over the model axis)."""
    b, s, _ = x.shape
    dh = cfg.head_dim
    local = _local_heads(params, cfg, ctx)
    q, k, v = _project_qkv_ctx(params, x, cfg, ctx, impl, local)
    q, k = rotate(q), rotate(k)
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, q.shape[2] // kv, dh)
    out = prefill_attention(qg.contiguous(), k.contiguous(), v.contiguous(),
                            causal=causal, window=cfg.sliding_window,
                            impl=impl)
    out = _out_proj(params["w_o"], out.reshape(b, s, -1), ctx, local, impl)
    cache = None
    if make_cache:
        if local:
            k = sh.all_gather(ctx, k, ctx.model_axis, 2)
            v = sh.all_gather(ctx, v, ctx.model_axis, 2)
        cache = {"k": k, "v": v}
    return out, cache


def _local_heads(params, cfg: ModelConfig, ctx) -> bool:
    """Whether each model rank holds whole heads: w_q / w_k / w_v
    column-split and w_o row-split (``param_pspecs``) with the KV heads
    divisible by the model axis."""
    if ctx is None or ctx.model_size == 1 or cfg.n_kv_heads % ctx.model_size:
        return False
    m, dh = ctx.model_size, cfg.head_dim
    hd, kvd = cfg.n_heads * dh, cfg.n_kv_heads * dh
    return (params["w_q"].shape[-1] * m == hd
            and params["w_k"].shape[-1] * m == kvd
            and params["w_v"].shape[-1] * m == kvd
            and params["w_o"].shape[0] * m == hd)


def _project_qkv_ctx(params, x, cfg: ModelConfig, ctx, impl, local: bool):
    """q, k, v (B, S, heads, dh) under a ctx: this rank's heads when
    ``local``, else every head, a column-split projection's parts gathered
    over the model axis (a replicated one computed whole)."""
    if ctx is None:
        return _project_qkv(params, x, cfg, impl)
    xf = sh.copy_to_model(ctx, x)
    return tuple(_project_ctx(params, x, xf, name, heads, cfg, ctx, impl,
                              local)
                 for name, heads in (("q", cfg.n_heads),
                                     ("k", cfg.n_kv_heads),
                                     ("v", cfg.n_kv_heads)))


def _project_ctx(params, x, xf, name: str, heads: int, cfg: ModelConfig,
                 ctx, impl, local: bool):
    """One of ``_project_qkv_ctx``'s projections (``name`` "q", "k" or
    "v" of ``heads`` heads) of ``x`` (B, S, D) under a ctx; ``xf`` is
    ``copy_to_model(x)``, the input of a column-split weight."""
    b, s, _ = x.shape
    dh = cfg.head_dim
    w = params["w_" + name]
    split = ctx.model_size > 1 and w.shape[-1] != heads * dh
    y = common.linear(xf if split else x, w, impl)
    if cfg.qkv_bias:
        y = y + params["b_" + name]
    if split and not local:
        y = sh.gather_from_model(ctx, y, -1)
    return y.reshape(b, s, -1, dh)


def _out_proj(w_o, o, ctx, local: bool, impl):
    """The output projection of the heads ``o`` (..., heads * dh): this
    rank's heads on its rows of w_o (``local``), or every head's output,
    of which a row-split w_o takes this rank's part; the partial products
    summed over the model axis."""
    if local:
        return sh.reduce_from_model(ctx, common.linear(o, w_o, impl))
    if ctx is not None and w_o.shape[0] != o.shape[-1]:
        part = common.linear(sh.scatter_to_model(ctx, o, -1), w_o, impl)
        return sh.reduce_from_model(ctx, part)
    return common.linear(o, w_o, impl)


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
               mrope_positions3=None, attn_impl: Optional[str] = None,
               ctx=None):
    """x: (B,1,D); cache{k,v}: (B,S,KV,dh); pos: int or RAGGED (B,) device
    vector of per-row cache positions -> (out, cache).  A VLM's text token
    takes its (3, B, 1) M-RoPE ids as ``mrope_positions3``.  Under a
    ``ctx`` see ``_decode_sharded``."""
    if ctx is not None:
        return _decode_sharded(params, x, cfg, cache, pos, mrope_positions3,
                               attn_impl, ctx)
    b = x.shape[0]
    kv, g, dh = cfg.n_kv_heads, cfg.q_heads_per_kv, cfg.head_dim
    pos_b = _pos_column(pos, b, x.device)
    q, k, v = _project_qkv(params, x, cfg, attn_impl)
    q, k = _rotate_decode(cfg, q, k, pos_b, mrope_positions3)
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


def _rotate_decode(cfg: ModelConfig, q, k, pos_b, mrope_positions3):
    if mrope_positions3 is not None:
        return (common.apply_mrope(q, mrope_positions3, cfg.mrope_sections,
                                   cfg.rope_theta),
                common.apply_mrope(k, mrope_positions3, cfg.mrope_sections,
                                   cfg.rope_theta))
    return (common.apply_rope(q, pos_b, cfg.rope_theta),
            common.apply_rope(k, pos_b, cfg.rope_theta))


def decode_partial(q, k_cache, v_cache, valid, impl: Optional[str] = None):
    """Unnormalised fp32 partials (o, m, l) over a cache slice: the
    flash-decoding kernel's (``impl=KERNEL``; its plain version for CPU
    tensors) or the reference's ``_decode_partial``."""
    if impl == KERNEL:
        return ops.decode_gqa_partial(q, k_cache, v_cache, valid)
    return ref.decode_gqa_partial_ref(q, k_cache, v_cache, valid)


def _decode_sharded(params, x, cfg: ModelConfig, cache, pos, mrope3, impl,
                    ctx):
    """One token per row against a cache whose sequence is split over the
    model axis (``api.shard_cache``: slots [r S_loc, (r + 1) S_loc) on
    model rank r, every head).  q, k and v are gathered over the heads;
    the rank that owns ``pos`` writes the new row (a masked write, as the
    reference's ``cache_update`` under a mesh); each rank takes the
    flash-decoding partials of its slice, merged by the max of m and the
    sums of l w and o w over the model axis (``flash_decode`` under a
    mesh).  ``pos`` is one slot for every row: ragged positions raise, as
    in the reference."""
    if torch.is_tensor(pos) and pos.ndim:
        raise NotImplementedError(
            "ragged per-row cache positions are single-device only "
            "(the seq-sharded serving cache keeps one slot per step)")
    pos = int(pos)
    b = x.shape[0]
    kv, g, dh = cfg.n_kv_heads, cfg.q_heads_per_kv, cfg.head_dim
    pos_b = _pos_column(pos, b, x.device)
    q, k, v = _project_qkv_ctx(params, x, cfg, ctx, impl, local=False)
    q, k = _rotate_decode(cfg, q, k, pos_b, mrope3)
    s_loc = cache["k"].shape[1]
    start, valid = _seq_slice(cfg, ctx, pos_b, s_loc)
    slot = pos % (s_loc * ctx.model_size) - start
    if 0 <= slot < s_loc:
        cache_update(cache["k"], k[:, 0], slot)
        cache_update(cache["v"], v[:, 0], slot)
    out = merge_partials(ctx, *decode_partial(
        q.reshape(b, kv, g, dh).contiguous(), cache["k"], cache["v"], valid,
        impl))
    out = out.to(cache["v"].dtype).reshape(b, 1, kv * g * dh)
    return _out_proj(params["w_o"], out, ctx, False, impl), cache


def merge_partials(ctx, o, m, l):
    """The normalised attention output from each model rank's fp32
    partials (o (..., d), m, l (...)) over its slice of the keys: the max
    of m, then one all-reduce of o w and l w (w = exp(m - max)), as the
    reference's ``flash_decode`` under a mesh merges them."""
    m_star = sh.pmax(ctx, m, ctx.model_axis)
    w = torch.exp(m - m_star)
    ol = sh.all_reduce(ctx, torch.cat([o * w[..., None], (l * w)[..., None]],
                                      -1), ctx.model_axis)
    return ol[..., :-1] / torch.clamp(ol[..., -1], min=1e-30)[..., None]


def _seq_slice(cfg: ModelConfig, ctx, pos_b, s_loc: int):
    """(this model rank's first slot, its (B, s_loc) valid mask) of a
    decode cache whose sequence is split over the model axis."""
    start = ctx.model_rank * s_loc
    valid = decode_valid(cfg, pos_b, s_loc * ctx.model_size)
    valid = valid.expand(pos_b.shape[0], -1)
    return start, valid[:, start:start + s_loc].contiguous()


# ===========================================================================
# Cross attention (encoder-decoder)
# ===========================================================================
def cross_attn_prefill_kv(params, enc_out, cfg: ModelConfig,
                          attn_impl: Optional[str] = None, ctx=None) -> dict:
    """The static cross-attention cache {k, v} (B, S_enc, KV, dh) from the
    encoder's output (no rotary: cross attention carries no positions).
    Under a ``ctx`` whose model ranks hold whole heads (``_local_heads``)
    this rank's heads, else every head (``gather_heads`` makes the
    cache's every head of it)."""
    if ctx is not None:
        local = _local_heads(params, cfg, ctx)
        xf = sh.copy_to_model(ctx, enc_out)
        return {n: _project_ctx(params, enc_out, xf, n, cfg.n_kv_heads, cfg,
                                ctx, attn_impl, local) for n in ("k", "v")}
    b, s, _ = enc_out.shape
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    k = common.linear(enc_out, params["w_k"], attn_impl).reshape(b, s, kv, dh)
    v = common.linear(enc_out, params["w_v"], attn_impl).reshape(b, s, kv, dh)
    if cfg.qkv_bias:
        k = k + params["b_k"].reshape(kv, dh)
        v = v + params["b_v"].reshape(kv, dh)
    return {"k": k, "v": v}


def gather_heads(ctx, cache: dict, cfg: ModelConfig) -> dict:
    """A cache {k, v} (B, S, heads, dh) with every KV head: one that holds
    this rank's heads is gathered over the model axis."""
    if ctx is None or cache["k"].shape[2] == cfg.n_kv_heads:
        return cache
    return {n: sh.all_gather(ctx, t, ctx.model_axis, 2)
            for n, t in cache.items()}


def cross_seq_sharded(cfg: ModelConfig, ctx) -> bool:
    """Whether the decode's cross cache is split by sequence over the model
    axis: when the encoder's ``enc_seq_len`` divides it, else it stays
    whole (the reference's ``cache_pspecs``)."""
    return (ctx is not None and ctx.model_size > 1
            and cfg.enc_seq_len % ctx.model_size == 0)


def cross_attn_apply(params, x, kv_cache, cfg: ModelConfig,
                     attn_impl: Optional[str] = None, ctx=None):
    """x: (B, Sq, D) attends, non-causally, over the encoder's {k, v}
    (B, Sk, KV, dh).  One query token (decode) is a flash decode with every
    slot of the cross cache valid, the zero rows an ``empty_cache`` leaves
    past the frames included, as in the reference; more is non-causal
    prefill attention at Sq != Sk (the reference runs its jnp
    ``chunked_attention`` here; the port its flash-attention kernel).

    Under a ``ctx`` the prefill attends over the heads
    ``cross_attn_prefill_kv`` gave (this rank's, or every head), its
    output through the row-parallel ``w_o``.  The decode takes every
    head's query against the cross cache as ``api.shard_cache`` lays it
    out: split by sequence (``cross_seq_sharded``), each rank's
    flash-decoding partials over its slots merged over the model axis,
    else whole."""
    b, sq, _ = x.shape
    kv, g, dh = cfg.n_kv_heads, cfg.q_heads_per_kv, cfg.head_dim
    k, v = kv_cache["k"], kv_cache["v"]
    if ctx is not None:
        local = sq > 1 and _local_heads(params, cfg, ctx)
        q = _project_ctx(params, x, sh.copy_to_model(ctx, x), "q",
                         cfg.n_heads, cfg, ctx, attn_impl, local)
    else:
        local = False
        q = common.linear(x, params["w_q"], attn_impl).reshape(
            b, sq, cfg.n_heads, dh)
        if cfg.qkv_bias:
            q = q + params["b_q"].reshape(cfg.n_heads, dh)
    kvh = k.shape[2]
    if sq == 1:
        valid = torch.ones((b, k.shape[1]), dtype=torch.bool, device=x.device)
        qh = q.reshape(b, kv, g, dh).contiguous()
        if cross_seq_sharded(cfg, ctx):
            if k.shape[1] * ctx.model_size != cfg.enc_seq_len:
                raise ValueError(
                    f"cross cache of {k.shape[1]} slots on each of "
                    f"{ctx.model_size} model ranks, expected enc_seq_len "
                    f"{cfg.enc_seq_len} split over them (api.shard_cache)")
            out = merge_partials(ctx, *decode_partial(
                qh, k.contiguous(), v.contiguous(), valid, attn_impl))
            out = out.to(v.dtype)
        else:
            out = flash_decode(qh, k.contiguous(), v.contiguous(), valid,
                               impl=attn_impl)
    else:
        out = prefill_attention(
            q.reshape(b, sq, kvh, q.shape[2] // kvh, dh).contiguous(),
            k.contiguous(), v.contiguous(), causal=False, window=None,
            impl=attn_impl)
    out = out.reshape(b, sq, -1)
    if ctx is not None:
        return _out_proj(params["w_o"], out, ctx, local, attn_impl)
    return common.linear(out, params["w_o"], attn_impl)


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
# MLA's head-split weights (``param_pspecs``): the up-projections
# column-split on heads, ``w_o`` row-split; w_dq, w_dkv, w_kr and the norms
# whole.  name -> (the dim the model axis splits, the head width)
_MLA_SPLIT = {"w_uq_nope": (1, "v_head_dim"), "w_uq_rope": (1, "rope_head_dim"),
              "w_uk": (1, "v_head_dim"), "w_uv": (1, "v_head_dim"),
              "w_o": (0, "v_head_dim")}


def _mla_params(params, cfg: ModelConfig, ctx):
    """(params, local) of MLA under a ``ctx``: each model rank on its heads
    (``local``) when every weight of ``_MLA_SPLIT`` holds this rank's
    whole heads, else every weight whole (a split one gathered over the
    model axis; its gradient is this rank's part of the replicated one)."""
    if ctx is None or ctx.model_size == 1:
        return params, False
    m, h = ctx.model_size, cfg.n_heads
    split = {n: params[n].shape[d] != h * getattr(cfg, width)
             for n, (d, width) in _MLA_SPLIT.items()}
    if all(split.values()) and h % m == 0:
        return params, True
    whole = dict(params)
    for n, (d, _) in _MLA_SPLIT.items():
        if split[n]:
            whole[n] = sh.gather_from_model(ctx, params[n], d)
    return whole, False


def _mla_queries(p, x, cfg: ModelConfig, positions, impl, split_in):
    """(q_nope (B,S,h,dn), q_rope (B,S,h,dr), rotated) of the heads ``p``'s
    up-projections hold; ``split_in`` passes their input
    (``copy_to_model`` on a rank's heads)."""
    b, s, _ = x.shape
    qc = split_in(common.rms_norm(common.linear(x, p["w_dq"], impl),
                                  p["q_norm"], cfg.norm_eps))
    q_nope = common.linear(qc, p["w_uq_nope"], impl).reshape(
        b, s, -1, cfg.v_head_dim)
    q_rope = common.apply_rope(common.linear(qc, p["w_uq_rope"], impl).reshape(
        b, s, -1, cfg.rope_head_dim), positions, cfg.rope_theta)
    return q_nope, q_rope


def _mla_latent(p, x, cfg: ModelConfig, positions, impl):
    """(c (B,S,dc), k_rope (B,S,1,dr) rotated): the latent and rope rows
    the cache keeps."""
    b, s, _ = x.shape
    c = common.rms_norm(common.linear(x, p["w_dkv"], impl), p["kv_norm"],
                        cfg.norm_eps)
    k_rope = common.apply_rope(common.linear(x, p["w_kr"], impl).reshape(
        b, s, 1, cfg.rope_head_dim), positions, cfg.rope_theta)
    return c, k_rope


def mla_prefill(params, x, cfg: ModelConfig, positions, *, make_cache=True,
                attn_impl: Optional[str] = None, ctx=None):
    """x: (B,S,D) -> (out (B,S,D), cache {c (B,S,dc), kr (B,S,dr)} | None).
    Per-head q / k of width dn + dr (the rope half shared by every head's
    key) against v of width dv: one causal ``prefill_attention`` over
    n_heads KV heads of one query each, scaled by 1/sqrt(dn + dr).  Under
    a ``ctx`` (``_mla_params``) each model rank attends over its heads and
    one all-reduce joins the row-split ``w_o``; the latent cache is whole
    on every rank."""
    b, s, _ = x.shape
    dn, dr, dv = cfg.v_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    p, local = _mla_params(params, cfg, ctx)

    def split_in(t):
        return sh.copy_to_model(ctx, t) if local else t
    q_nope, q_rope = _mla_queries(p, x, cfg, positions, attn_impl, split_in)
    c, k_rope = _mla_latent(p, x, cfg, positions, attn_impl)
    h = q_nope.shape[2]
    c_in = split_in(c)
    k_nope = common.linear(c_in, p["w_uk"], attn_impl).reshape(b, s, h, dn)
    v = common.linear(c_in, p["w_uv"], attn_impl).reshape(b, s, h, dv)
    q_full = torch.cat([q_nope, q_rope], -1)               # (B,S,h,dn+dr)
    k_full = torch.cat([k_nope, split_in(k_rope).expand(b, s, h, dr)], -1)
    out = prefill_attention(q_full.reshape(b, s, h, 1, dn + dr), k_full,
                            v.contiguous(), causal=True, window=None,
                            impl=attn_impl)
    out = common.linear(out.reshape(b, s, h * dv), p["w_o"], attn_impl)
    if local:
        out = sh.reduce_from_model(ctx, out)
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


def latent_partial(q, c_cache, kr_cache, valid,
                   impl: Optional[str] = None):
    """``latent_decode``'s unnormalised fp32 partials (o (B,1,G,dc), m, l
    (B,1,G)) over a slice of the latent cache: the flash-decoding kernel's
    (``impl=KERNEL``; its plain version for CPU tensors) or the plain
    version."""
    if impl == KERNEL:
        return ops.decode_latent_partial(q, c_cache, kr_cache, valid)
    return ref.decode_latent_partial_ref(q, c_cache, kr_cache, valid)


def mla_decode(params, x, cfg: ModelConfig, cache, pos, *,
               attn_impl: Optional[str] = None, ctx=None):
    """Absorbed-matrix MLA decode over the latent cache: x (B,1,D); cache
    {c (B,S,dc), kr (B,S,dr)}, written IN PLACE at ``pos`` (an int or a
    RAGGED (B,) device vector) -> (out, cache).  The latent cache is one
    virtual KV head of width dc + dr attended by all n_heads queries;
    W_uk is absorbed into the query and W_uv into the output, so decode
    never expands per-head K/V.

    Under a ``ctx`` the cache's sequence is split over the model axis
    (``api.shard_cache``) and every rank needs every head's query: each
    absorbs ``W_uk`` on its heads (``_mla_params``), the absorbed queries
    are gathered over the model axis, each rank takes the latent partials
    of its slots (the rank that owns ``pos`` writes the new row), the
    partials are merged as GQA's (``merge_partials``), and each rank
    un-absorbs ``W_uv`` on its heads before the row-split ``w_o``.  ``pos``
    is then one slot for every row."""
    b = x.shape[0]
    dc, dv = cfg.kv_lora_rank, cfg.v_head_dim
    if ctx is not None and torch.is_tensor(pos) and pos.ndim:
        raise NotImplementedError(
            "ragged per-row cache positions are single-device only "
            "(the seq-sharded serving cache keeps one slot per step)")
    pos_b = _pos_column(pos, b, x.device)
    p, local = _mla_params(params, cfg, ctx)
    q_nope, q_rope = _mla_queries(p, x, cfg, pos_b, attn_impl,
                                  lambda t: t)
    # absorb W_uk: q_abs[h] = q_nope[h] @ W_uk[h].T, into the latent space
    q_abs = absorb_heads(q_nope[:, 0], p["w_uk"], dc, trans=True,
                         impl=attn_impl)                       # (B,h,dc)
    q_eff = torch.cat([q_abs, q_rope[:, 0]], -1)               # (B,h,dc+dr)
    c_new, kr_new = _mla_latent(p, x, cfg, pos_b, attn_impl)
    c_new, kr_new = c_new[:, 0], kr_new[:, 0, 0]
    if ctx is None:
        c_cache = cache_update(cache["c"], c_new, pos)
        kr_cache = cache_update(cache["kr"], kr_new, pos)
        s_cache = c_cache.shape[1]
        valid = decode_valid(cfg, pos_b, s_cache).expand(b, s_cache)
        o_lat = latent_decode(q_eff[:, None].contiguous(), c_cache, kr_cache,
                              valid.contiguous(), impl=attn_impl)
    else:
        c_cache, kr_cache = cache["c"], cache["kr"]
        if local:
            q_eff = sh.gather_from_model(ctx, q_eff, 1)        # (B,H,dc+dr)
        s_loc = c_cache.shape[1]
        start, valid = _seq_slice(cfg, ctx, pos_b, s_loc)
        slot = int(pos) % (s_loc * ctx.model_size) - start
        if 0 <= slot < s_loc:
            cache_update(c_cache, c_new, slot)
            cache_update(kr_cache, kr_new, slot)
        o_lat = merge_partials(ctx, *latent_partial(
            q_eff[:, None].contiguous(), c_cache, kr_cache, valid,
            attn_impl)).to(c_cache.dtype)                      # (B,1,H,dc)
        if local:
            o_lat = sh.local_slice(ctx, o_lat, ctx.model_axis, 2)
    # un-absorb W_uv: out[h] = o_lat[h] @ W_uv[h]
    out = absorb_heads(o_lat[:, 0], p["w_uv"], dv, trans=False,
                       impl=attn_impl)
    out = common.linear(out.reshape(b, 1, -1), p["w_o"], attn_impl)
    if local:
        out = sh.reduce_from_model(ctx, out)
    return out, {"c": c_cache, "kr": kr_cache}
