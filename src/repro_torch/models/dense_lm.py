"""Decoder layers, dense (GQA or MLA attention), MoE and VLM: init,
prefill and single-token decode.

PyTorch port of the dense, MoE and VLM families of
``repro/models/dense_lm.py`` (an MoE layer's FFN is ``models/moe.py``'s
capacity-dispatched experts).  A VLM backbone serves text as a GQA
decoder, as the reference's engine serves it: with text-only positions
(t = h = w) M-RoPE is 1-D RoPE, and ``patch_proj`` is carried in the
embed shard but applied by nothing on the serving path.
Parameters are nested dicts with the reference's keys and ``(in, out)``
layout; ``init_params`` stacks the layers on a leading axis, as the
reference's ``vmap``-ed init does, so ``checkpoint.partition_and_save``
splits either package's tree the same way.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.models import attention as attn
from repro_torch.models import common, moe
from repro_torch.models.config import DENSE, MOE, VLM, ModelConfig

DECODER_FAMILIES = (DENSE, MOE, VLM)


def check_dense(cfg: ModelConfig) -> None:
    if cfg.family not in DECODER_FAMILIES:
        raise NotImplementedError(
            f"model family '{cfg.family}' ({cfg.name}) is not yet ported in "
            f"repro_torch (dense, MoE and VLM only)")
    attn.check_attention(cfg)


# ===========================================================================
# Init (numpy, from an explicit generator)
# ===========================================================================
def layer_init(rng: np.random.Generator, cfg: ModelConfig) -> dict:
    p = {
        "attn_norm": np.ones((cfg.d_model,), cfg.dtype),
        "attn": attn.attn_init(rng, cfg),
        "ffn_norm": np.ones((cfg.d_model,), cfg.dtype),
    }
    if cfg.family == MOE:
        p["moe"] = moe.moe_init(rng, cfg)
    else:
        p["mlp"] = common.mlp_init(rng, cfg.d_model, cfg.d_ff, cfg.dtype,
                                   gated=cfg.gated_mlp)
    return p


def init_params(rng: np.random.Generator, cfg: ModelConfig) -> dict:
    """Random weights as a numpy tree with stacked ``layers``."""
    check_dense(cfg)
    layers = [layer_init(rng, cfg) for _ in range(cfg.num_layers)]

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return np.stack(xs)

    params = {
        "embed": common.embed_init(rng, cfg.padded_vocab, cfg.d_model,
                                   cfg.dtype),
        "layers": stack(*layers),
        "final_norm": np.ones((cfg.d_model,), cfg.dtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = common.dense_init(rng, cfg.d_model,
                                              cfg.padded_vocab, cfg.dtype)
    if cfg.family == VLM:
        # drawn after the head, as the reference folds it from the head's key
        params["patch_proj"] = common.dense_init(rng, cfg.d_model,
                                                 cfg.d_model, cfg.dtype)
    return params


# ===========================================================================
# Layer application
# ===========================================================================
def _ffn(p, x, cfg: ModelConfig, impl: Optional[str]):
    h = common.rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    if cfg.family == MOE:
        return x + moe.moe_apply(p["moe"], h, cfg)[0]
    return x + common.mlp_apply(p["mlp"], h, impl)


def attn_prefill(p, h, cfg: ModelConfig, positions, *, make_cache,
                 attn_impl: Optional[str] = None):
    """The layer's attention block on the normed input: MLA or GQA."""
    if cfg.attention == "mla":
        return attn.mla_prefill(p, h, cfg, positions, make_cache=make_cache,
                                attn_impl=attn_impl)
    return attn.gqa_prefill(p, h, cfg, positions, causal=cfg.causal,
                            make_cache=make_cache, attn_impl=attn_impl)


def attn_decode(p, h, cfg: ModelConfig, cache, pos, *,
                attn_impl: Optional[str] = None):
    """One token per row against the layer's cache: MLA or GQA."""
    if cfg.attention == "mla":
        return attn.mla_decode(p, h, cfg, cache, pos, attn_impl=attn_impl)
    return attn.gqa_decode(p, h, cfg, cache, pos, attn_impl=attn_impl)


def layer_prefill(p, x, cfg: ModelConfig, positions, *, make_cache,
                  attn_impl: Optional[str] = None):
    h = common.rms_norm(x, p["attn_norm"], cfg.norm_eps)
    a, cache = attn_prefill(p["attn"], h, cfg, positions,
                            make_cache=make_cache, attn_impl=attn_impl)
    return _ffn(p, x + a, cfg, attn_impl), cache


def layer_decode(p, x, cfg: ModelConfig, cache, pos, *,
                 attn_impl: Optional[str] = None):
    h = common.rms_norm(x, p["attn_norm"], cfg.norm_eps)
    a, cache = attn_decode(p["attn"], h, cfg, cache, pos,
                           attn_impl=attn_impl)
    return _ffn(p, x + a, cfg, attn_impl), cache


def layer_decode_paged(p, x, cfg: ModelConfig, pools, tables, pos, *,
                       attn_impl: Optional[str] = None):
    """GQA decode against PAGED cache pools (core/kv_pages.py), the paged
    sibling of ``layer_decode``; the pools are written in place."""
    h = common.rms_norm(x, p["attn_norm"], cfg.norm_eps)
    a, pools = attn.gqa_decode_paged(p["attn"], h, cfg, pools, tables, pos,
                                     attn_impl=attn_impl)
    return _ffn(p, x + a, cfg, attn_impl), pools


def layer_verify_paged(p, x, cfg: ModelConfig, pools, tables, pos, *,
                       attn_impl: Optional[str] = None):
    """Stacked W-token layer over PAGED pools (B, W, D), each token
    attending causally up to its own slot: the W>1 sibling of
    ``layer_decode_paged``."""
    h = common.rms_norm(x, p["attn_norm"], cfg.norm_eps)
    a, pools = attn.gqa_verify_paged(p["attn"], h, cfg, pools, tables, pos,
                                     attn_impl=attn_impl)
    return _ffn(p, x + a, cfg, attn_impl), pools
