"""Recurrent-family LMs: xLSTM (mLSTM/sLSTM stack) and Zamba2 hybrid
(Mamba2 backbone + weight-tied shared attention block).

PyTorch port of ``repro/models/recurrent_lm.py``.

xLSTM layout (7:1): ``num_layers`` splits into super-blocks of
(slstm_every - 1) mLSTM layers followed by one sLSTM layer; the stacked
leaves are ``mlstm`` (n_sb, m_per, ...) and ``slstm`` (n_sb, ...), walked
super-block by super-block (outer) and mLSTM layer by layer (inner).
With ``cfg.remat`` the loss path checkpoints both levels, as the
reference nests ``jax.checkpoint``: the super-block backward replays its
mLSTM layers one at a time.  xLSTM runs no attention and so no kernel.

Zamba2 layout: groups of ``shared_attn_every`` Mamba2 layers (full
groups, then a remainder group), after each full group of which the
single *shared* (weight-tied) attention+MLP block runs on
``concat(hidden, original_embedding)`` (2*D -> attention -> D), per
arXiv:2411.15242.  Each application site has its own KV cache, a ring of
``min(seq, sliding_window)`` slots under a window.  The shared site's
prefill attention runs the flash-attention kernel (its backward while
training), its decode the flash-decoding kernel, as ``models/attention``
chooses by ``attn_impl``; with ``cfg.remat`` every Mamba2 layer of the
loss path, and each shared site, runs under ``torch.utils.checkpoint``.

The passes return new recurrent states; Zamba2's decode writes the
sites' KV caches in place, as ``attention.gqa_decode`` does.

With a sharding ``ctx`` (``repro_torch.sharding``) the passes run on a
device mesh as the reference lays them out: the batch's rows over the
batch axes; the mLSTM heads (``w_up``, ``w_q``, ``w_k``, ``w_v`` column-,
``w_down`` row-split) and Zamba2's shared attention and MLP over the model
axis; the embedding, head and cross-entropy split by vocabulary
(``dense_lm.embed`` / ``logits_of`` / ``xent``).  Mamba2 and sLSTM have
no rule and run whole on every model rank.  Recurrent states keep every
head on every model rank; Zamba2's site caches are split by sequence over
the model axis in the decode (``api.shard_cache``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import sharding as sh
from repro_torch.models import attention as attn
from repro_torch.models import common, dense_lm, ssm
from repro_torch.models.config import ModelConfig


def _remat(cfg: ModelConfig, decode: bool) -> bool:
    return cfg.remat and not decode and torch.is_grad_enabled()


def _broadcast(tree, lead: tuple):
    """Every leaf of ``tree`` repeated over new leading dims ``lead``."""
    if isinstance(tree, dict):
        return {k: _broadcast(v, lead) for k, v in tree.items()}
    return tree.expand(lead + tuple(tree.shape)).contiguous()


def _embed(params, tokens, cfg: ModelConfig, ctx):
    """This rank's rows of the global ``tokens``, embedded."""
    return dense_lm.embed(params, sh.batch_rows(ctx, tokens).long(), cfg,
                          ctx)


def _head(params, x, cfg: ModelConfig, ctx) -> torch.Tensor:
    """Last-token fp32 logits (the global batch's under a ctx)."""
    x = common.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return dense_lm.logits_of(params, x[:, -1], cfg, ctx)


def _loss(params, x, cfg: ModelConfig, batch: dict, ctx):
    x = common.rms_norm(x, params["final_norm"], cfg.norm_eps)
    loss = dense_lm.xent(params, x, batch["labels"], cfg, ctx)
    return loss, {"xent": loss}


# ===========================================================================
# xLSTM
# ===========================================================================
def _xlstm_shape(cfg: ModelConfig) -> Tuple[int, int]:
    n_sb = cfg.num_layers // cfg.slstm_every
    m_per = cfg.slstm_every - 1
    assert n_sb * cfg.slstm_every == cfg.num_layers, (
        "num_layers must be a multiple of slstm_every")
    return n_sb, m_per


def xlstm_init(rng: np.random.Generator, cfg: ModelConfig) -> dict:
    n_sb, m_per = _xlstm_shape(cfg)
    dt = cfg.dtype
    embed = common.embed_init(rng, cfg.padded_vocab, cfg.d_model, dt)

    def cell(init):
        return {"norm": common.ones((cfg.d_model,), dt),
                "cell": init(rng, cfg, cfg.d_model)}
    mlstm = common.stack_trees([
        common.stack_trees([cell(ssm.mlstm_init) for _ in range(m_per)])
        for _ in range(n_sb)])
    slstm = common.stack_trees([cell(ssm.slstm_init) for _ in range(n_sb)])
    return {
        "embed": embed,
        "mlstm": mlstm,
        "slstm": slstm,
        "final_norm": common.ones((cfg.d_model,), dt),
        "lm_head": common.dense_init(rng, cfg.d_model, cfg.padded_vocab, dt),
    }


def xlstm_empty_state(cfg: ModelConfig, batch: int, device="cpu") -> dict:
    n_sb, m_per = _xlstm_shape(cfg)
    return {
        "mlstm": _broadcast(ssm.mlstm_empty_state(cfg, cfg.d_model, batch,
                                                  device), (n_sb, m_per)),
        "slstm": _broadcast(ssm.slstm_empty_state(cfg, cfg.d_model, batch,
                                                  device), (n_sb,)),
    }


def _xlstm_pass(params, x, cfg: ModelConfig, state: Optional[dict],
                decode: bool, ctx=None):
    """The stack traversal -> (x, new state); ``state=None`` starts every
    cell from its empty state.  Under a ``ctx`` the mLSTM cells run their
    heads on each model rank (``ssm.mlstm_prefill``); the sLSTM cells, which
    no rule splits, run whole on every model rank."""
    n_sb, m_per = _xlstm_shape(cfg)
    remat = _remat(cfg, decode)
    m_fn = ssm.mlstm_decode if decode else ssm.mlstm_prefill
    s_fn = ssm.slstm_decode if decode else ssm.slstm_prefill

    def inner(p, st, h):
        y, st_new = m_fn(p["cell"], common.rms_norm(h, p["norm"],
                                                    cfg.norm_eps), cfg, st,
                         ctx)
        return h + y, st_new

    def outer(p_m, st_m, p_s, st_s, h):
        m_states = []
        for j in range(m_per):
            st = None if st_m is None else common.take(st_m, j)
            h, st_new = common.maybe_checkpoint(
                remat, inner, common.take(p_m, j), st, h)
            m_states.append(st_new)
        y, st_s_new = s_fn(p_s["cell"], common.rms_norm(h, p_s["norm"],
                                                        cfg.norm_eps),
                           cfg, st_s)
        return h + y, common.stack_trees(m_states), st_s_new

    m_all, s_all = [], []
    for i in range(n_sb):
        st_m = None if state is None else common.take(state["mlstm"], i)
        st_s = None if state is None else common.take(state["slstm"], i)
        x, st_m, st_s = common.maybe_checkpoint(
            remat, outer, common.take(params["mlstm"], i), st_m,
            common.take(params["slstm"], i), st_s, x)
        m_all.append(st_m)
        s_all.append(st_s)
    return x, {"mlstm": common.stack_trees(m_all),
               "slstm": common.stack_trees(s_all)}


# the passes take the model API's ``impl`` like every family's; xLSTM runs
# no attention, so it goes unused
def xlstm_loss(params, batch: dict, cfg: ModelConfig,
               impl: Optional[str] = None, ctx=None):
    x = _embed(params, batch["tokens"], cfg, ctx)
    x, _ = _xlstm_pass(params, x, cfg, None, decode=False, ctx=ctx)
    return _loss(params, x, cfg, batch, ctx)


def xlstm_prefill(params, batch: dict, cfg: ModelConfig,
                  impl: Optional[str] = None, ctx=None):
    x = _embed(params, batch["tokens"], cfg, ctx)
    x, state = _xlstm_pass(params, x, cfg, None, decode=False, ctx=ctx)
    return _head(params, x, cfg, ctx), state


def xlstm_decode(params, tokens, cache: dict, pos, cfg: ModelConfig,
                 impl: Optional[str] = None, ctx=None):
    x = _embed(params, tokens, cfg, ctx)
    x, state = _xlstm_pass(params, x, cfg, cache, decode=True, ctx=ctx)
    return _head(params, x, cfg, ctx), state


# ===========================================================================
# Zamba2 hybrid
# ===========================================================================
def _zamba_groups(cfg: ModelConfig):
    every = cfg.shared_attn_every
    n_full = cfg.num_layers // every
    rem = cfg.num_layers - n_full * every
    sizes = [every] * n_full + ([rem] if rem else [])
    return sizes, n_full  # n_full == number of shared-attn sites


def zamba_init(rng: np.random.Generator, cfg: ModelConfig) -> dict:
    dt, d = cfg.dtype, cfg.d_model
    embed = common.embed_init(rng, cfg.padded_vocab, d, dt)
    mamba = common.stack_trees([
        {"norm": common.ones((d,), dt), "cell": ssm.mamba2_init(rng, cfg, d)}
        for _ in range(cfg.num_layers)])
    shared = {
        "norm": common.ones((2 * d,), dt),
        "attn": attn.gqa_init(rng, cfg, d_model=2 * d),
        "mlp_norm": common.ones((d,), dt),
        "mlp": common.mlp_init(rng, d, cfg.d_ff, dt),
    }
    # output projection maps attention back to d_model
    shared["attn"]["w_o"] = common.dense_init(rng, cfg.n_heads * cfg.head_dim,
                                              d, dt)
    return {
        "embed": embed,
        "mamba": mamba,
        "shared": shared,
        "final_norm": common.ones((d,), dt),
        "lm_head": common.dense_init(rng, d, cfg.padded_vocab, dt),
    }


def zamba_empty_cache(cfg: ModelConfig, batch: int, seq: int, dtype=None,
                      device="cpu") -> dict:
    _, n_sites = _zamba_groups(cfg)
    s = seq if cfg.sliding_window is None else min(seq, cfg.sliding_window)
    one = attn.empty_cache(cfg, batch, s, dtype, device="meta")
    return {
        "mamba": _broadcast(ssm.mamba2_empty_state(cfg, cfg.d_model, batch,
                                                   device),
                            (cfg.num_layers,)),
        "attn": {k: torch.zeros((n_sites,) + tuple(a.shape), dtype=a.dtype,
                                device=device) for k, a in one.items()},
    }


def _shared_mlp(shared, h, cfg: ModelConfig, impl: Optional[str], ctx):
    f = common.rms_norm(h, shared["mlp_norm"], cfg.norm_eps)
    return h + common.mlp_apply_ctx(shared["mlp"], f, cfg.d_ff, impl, ctx)


def _shared_attn_prefill(shared, h, x0, positions, cfg: ModelConfig,
                         make_cache: bool, impl: Optional[str], ctx=None):
    cat = common.rms_norm(torch.cat([h, x0], dim=-1), shared["norm"],
                          cfg.norm_eps)
    a, cache = attn.gqa_prefill(shared["attn"], cat, cfg, positions,
                                make_cache=make_cache, attn_impl=impl,
                                ctx=ctx)
    return _shared_mlp(shared, h + a, cfg, impl, ctx), cache


def _shared_attn_decode(shared, h, x0, cfg: ModelConfig, cache, pos,
                        impl: Optional[str], ctx=None):
    cat = common.rms_norm(torch.cat([h, x0], dim=-1), shared["norm"],
                          cfg.norm_eps)
    a, cache = attn.gqa_decode(shared["attn"], cat, cfg, cache, pos,
                               attn_impl=impl, ctx=ctx)
    return _shared_mlp(shared, h + a, cfg, impl, ctx), cache


def _zamba_pass(params, x, cfg: ModelConfig, cache: Optional[dict], pos,
                decode: bool, make_cache: bool, impl: Optional[str],
                ctx=None):
    """Traverse the groups -> (x, new cache | None).  Under a ``ctx`` the
    shared site's attention and MLP are tensor-parallel over the model
    axis; the Mamba2 layers, which no rule splits, run whole on every
    model rank."""
    sizes, n_sites = _zamba_groups(cfg)
    b, s, _ = x.shape
    x0 = x
    remat = _remat(cfg, decode)
    m_fn = ssm.mamba2_decode if decode else ssm.mamba2_prefill
    if not decode:
        positions = torch.arange(pos, pos + s, device=x.device)[None].expand(
            b, s)

    def mamba_layer(p, st, h):
        y, st_new = m_fn(p["cell"], common.rms_norm(h, p["norm"],
                                                    cfg.norm_eps), cfg, st)
        return h + y, st_new

    m_states, a_caches = [], []
    layer = 0
    for gi, size in enumerate(sizes):
        for _ in range(size):
            st = common.take(cache["mamba"], layer) if decode else None
            x, st_new = common.maybe_checkpoint(
                remat, mamba_layer, common.take(params["mamba"], layer), st,
                x)
            m_states.append(st_new)
            layer += 1
        if gi >= n_sites:
            continue
        if decode:
            x, a_new = _shared_attn_decode(
                params["shared"], x, x0, cfg,
                common.take(cache["attn"], gi), pos, impl, ctx)
        else:
            # the loss path remats each shared site (its attention keeps
            # full-sequence q / k / v / out residuals otherwise)
            x, a_new = common.maybe_checkpoint(
                remat and not make_cache, _shared_attn_prefill,
                params["shared"], x, x0, positions, cfg, make_cache, impl,
                ctx)
        a_caches.append(a_new)

    if not (decode or make_cache):
        return x, None
    if decode:
        return x, {"mamba": common.stack_trees(m_states),
                   "attn": cache["attn"]}
    return x, {"mamba": common.stack_trees(m_states),
               "attn": common.stack_trees(a_caches) if a_caches else None}


def zamba_loss(params, batch: dict, cfg: ModelConfig,
               impl: Optional[str] = None, ctx=None):
    x = _embed(params, batch["tokens"], cfg, ctx)
    x, _ = _zamba_pass(params, x, cfg, None, 0, decode=False,
                       make_cache=False, impl=impl, ctx=ctx)
    return _loss(params, x, cfg, batch, ctx)


def zamba_prefill(params, batch: dict, cfg: ModelConfig,
                  impl: Optional[str] = None, ctx=None):
    x = _embed(params, batch["tokens"], cfg, ctx)
    x, cache = _zamba_pass(params, x, cfg, None, 0, decode=False,
                           make_cache=True, impl=impl, ctx=ctx)
    return _head(params, x, cfg, ctx), cache


def zamba_decode(params, tokens, cache: dict, pos, cfg: ModelConfig,
                 impl: Optional[str] = None, ctx=None):
    x = _embed(params, tokens, cfg, ctx)
    x, new_cache = _zamba_pass(params, x, cfg, cache, pos, decode=True,
                               make_cache=True, impl=impl, ctx=ctx)
    return _head(params, x, cfg, ctx), new_cache
