"""Decoder language models, dense (GQA or MLA attention), MoE and VLM:
init, the per-layer prefill and single-token decode the engine streams,
and the full-model passes the model API trains and runs (``loss_fn``,
``prefill_fn``, ``decode_fn``, ``empty_cache``).

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

The full-model passes walk the stacked layers in a Python loop (the
reference's ``lax.scan``); with ``cfg.remat`` each layer of ``loss_fn``
runs under ``torch.utils.checkpoint``, which recomputes its forward in the
backward as ``jax.checkpoint`` does.  A VLM's training and prefill passes
prepend the projected patches to the text and rotate with 3-section
M-RoPE; its decode takes the text token's M-RoPE ids.  ``decode_fn``
writes the stacked cache IN PLACE and returns it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

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
        "attn_norm": common.ones((cfg.d_model,), cfg.dtype),
        "attn": attn.attn_init(rng, cfg),
        "ffn_norm": common.ones((cfg.d_model,), cfg.dtype),
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
        "final_norm": common.ones((cfg.d_model,), cfg.dtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = common.dense_init(rng, cfg.d_model,
                                              cfg.padded_vocab, cfg.dtype)
    if cfg.family == VLM:
        # drawn after the head, as the reference folds it from the head's key
        params["patch_proj"] = common.dense_init(rng, cfg.d_model,
                                                 cfg.d_model, cfg.dtype)
    return params


def lm_head_weight(params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# ===========================================================================
# Layer application
# ===========================================================================
def _ffn_aux(p, x, cfg: ModelConfig, impl: Optional[str]):
    """The FFN block and its auxiliary loss (the MoE router's; 0 else)."""
    h = common.rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    if cfg.family == MOE:
        out, aux = moe.moe_apply(p["moe"], h, cfg)
        return x + out, aux
    return (x + common.mlp_apply(p["mlp"], h, impl),
            torch.zeros((), dtype=torch.float32, device=x.device))


def _ffn(p, x, cfg: ModelConfig, impl: Optional[str]):
    return _ffn_aux(p, x, cfg, impl)[0]


def attn_prefill(p, h, cfg: ModelConfig, positions, *, make_cache,
                 attn_impl: Optional[str] = None):
    """The layer's attention block on the normed input: MLA or GQA."""
    if cfg.attention == "mla":
        return attn.mla_prefill(p, h, cfg, positions, make_cache=make_cache,
                                attn_impl=attn_impl)
    return attn.gqa_prefill(p, h, cfg, positions, causal=cfg.causal,
                            make_cache=make_cache, attn_impl=attn_impl)


def attn_decode(p, h, cfg: ModelConfig, cache, pos, *, mrope3=None,
                attn_impl: Optional[str] = None):
    """One token per row against the layer's cache: MLA or GQA (a VLM's
    text token with its M-RoPE ids ``mrope3``)."""
    if cfg.attention == "mla":
        return attn.mla_decode(p, h, cfg, cache, pos, attn_impl=attn_impl)
    return attn.gqa_decode(p, h, cfg, cache, pos, mrope_positions3=mrope3,
                           attn_impl=attn_impl)


def layer_prefill_aux(p, x, cfg: ModelConfig, positions, *, make_cache,
                      mrope3=None, attn_impl: Optional[str] = None):
    """One layer over a prompt -> (h, cache | None, aux), the reference's
    ``layer_prefill``: MLA, GQA with M-RoPE (``mrope3``, (3, B, S)) or
    GQA with RoPE at ``positions``."""
    h = common.rms_norm(x, p["attn_norm"], cfg.norm_eps)
    if mrope3 is not None and cfg.attention != "mla":
        a, cache = attn.gqa_mrope_prefill(p["attn"], h, cfg, mrope3,
                                          make_cache=make_cache,
                                          attn_impl=attn_impl)
    else:
        a, cache = attn_prefill(p["attn"], h, cfg, positions,
                                make_cache=make_cache, attn_impl=attn_impl)
    x, aux = _ffn_aux(p, x + a, cfg, attn_impl)
    return x, cache, aux


def layer_prefill(p, x, cfg: ModelConfig, positions, *, make_cache,
                  attn_impl: Optional[str] = None):
    """``layer_prefill_aux`` without the aux loss: (h, cache | None), the
    form the engine streams."""
    x, cache, _ = layer_prefill_aux(p, x, cfg, positions,
                                    make_cache=make_cache,
                                    attn_impl=attn_impl)
    return x, cache


def layer_decode(p, x, cfg: ModelConfig, cache, pos, *, mrope3=None,
                 attn_impl: Optional[str] = None):
    h = common.rms_norm(x, p["attn_norm"], cfg.norm_eps)
    a, cache = attn_decode(p["attn"], h, cfg, cache, pos, mrope3=mrope3,
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


# ===========================================================================
# VLM helpers
# ===========================================================================
def mrope_positions_prefill(cfg: ModelConfig, batch: int, n_patch: int,
                            s_text: int, device="cpu") -> torch.Tensor:
    """(3, B, n_patch + s_text) t/h/w position ids, Qwen2-VL style: the
    patches on a g x g grid at t = 0, the text from id g on."""
    g = max(int(round(n_patch ** 0.5)), 1)
    pid = torch.arange(n_patch, device=device)
    tid = g + torch.arange(s_text, device=device)
    pos3 = torch.stack([
        torch.cat([torch.zeros_like(pid), tid]),
        torch.cat([pid // g, tid]),
        torch.cat([pid % g, tid]),
    ])                                                        # (3, S)
    return pos3[:, None].expand(3, batch, n_patch + s_text)


def mrope_positions_decode(cfg: ModelConfig, batch: int, pos: int,
                           device="cpu") -> torch.Tensor:
    """Text-token M-RoPE ids (3, B, 1) for cache position ``pos``: text ids
    start at the patch grid's side g, so they carry the static delta
    ``g - num_patches`` against the cache position."""
    g = max(int(round(cfg.num_patches ** 0.5)), 1)
    return torch.full((3, batch, 1), int(pos) - cfg.num_patches + g,
                      dtype=torch.long, device=device)


# ===========================================================================
# Full-model passes over the stacked layers
# ===========================================================================
def _layer(layers, i: int) -> dict:
    """Layer ``i``'s parameters: views into the stacked leaves."""
    if isinstance(layers, dict):
        return {k: _layer(v, i) for k, v in layers.items()}
    return layers[i]


def _embed_inputs(params, cfg: ModelConfig, batch: dict):
    """(x (B, S, D), positions (B, S) or M-RoPE ids (3, B, S), the text's
    offset in S)."""
    tokens = batch["tokens"].long()
    b, s_text = tokens.shape
    x = params["embed"][tokens]
    if cfg.family == VLM:
        patches = batch["patches"].to(x.dtype)
        x = torch.cat([patches @ params["patch_proj"], x], dim=1)
        n_patch = patches.shape[1]
        return (x, mrope_positions_prefill(cfg, b, n_patch, s_text,
                                           x.device), n_patch)
    positions = torch.arange(x.shape[1], device=x.device)[None].expand(
        b, x.shape[1])
    return x, positions, 0


def _layers_forward(params, cfg: ModelConfig, x, pos_or3, *, make_cache,
                    remat: bool, attn_impl: Optional[str]):
    """Every layer in order -> (h, per-layer caches, summed aux)."""
    vlm = cfg.family == VLM

    def body(p, h):
        return layer_prefill_aux(p, h, cfg, None if vlm else pos_or3,
                                 make_cache=make_cache,
                                 mrope3=pos_or3 if vlm else None,
                                 attn_impl=attn_impl)
    caches, aux = [], torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.num_layers):
        p = _layer(params["layers"], i)
        if remat and torch.is_grad_enabled():
            x, cache, a = checkpoint(body, p, x, use_reentrant=False)
        else:
            x, cache, a = body(p, x)
        caches.append(cache)
        aux = aux + a
    return x, caches, aux


def loss_fn(params, batch: dict, cfg: ModelConfig,
            attn_impl: Optional[str] = None) -> Tuple[torch.Tensor, dict]:
    """(xent + 0.01 aux, {"xent", "aux"}) over a batch of tokens and labels
    (and a VLM's patches)."""
    x, pos_or3, text_off = _embed_inputs(params, cfg, batch)
    x, _, aux = _layers_forward(params, cfg, x, pos_or3, make_cache=False,
                                remat=cfg.remat, attn_impl=attn_impl)
    x = common.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.family == VLM:
        x = x[:, text_off:]
    loss = common.chunked_softmax_xent(x, lm_head_weight(params, cfg),
                                       batch["labels"].to(x.device))
    return loss + 0.01 * aux, {"xent": loss, "aux": aux}


def _stack_caches(caches) -> dict:
    return {k: torch.stack([c[k] for c in caches]) for k in caches[0]}


def prefill_fn(params, batch: dict, cfg: ModelConfig,
               attn_impl: Optional[str] = None):
    """(last-token logits (B, V) fp32, the stacked cache {leaf: (L, B, S,
    ...)})."""
    x, pos_or3, _ = _embed_inputs(params, cfg, batch)
    x, caches, _ = _layers_forward(params, cfg, x, pos_or3, make_cache=True,
                                   remat=False, attn_impl=attn_impl)
    x = common.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x[:, -1] @ lm_head_weight(params, cfg)
    return logits.float(), _stack_caches(caches)


def decode_fn(params, tokens, cache: dict, pos: int, cfg: ModelConfig,
              attn_impl: Optional[str] = None):
    """tokens (B, 1) at cache position ``pos`` against the stacked cache
    (written in place) -> (logits (B, V) fp32, cache)."""
    b = tokens.shape[0]
    x = params["embed"][tokens.long()]
    mrope3 = (mrope_positions_decode(cfg, b, pos, x.device)
              if cfg.family == VLM else None)
    for i in range(cfg.num_layers):
        x, _ = layer_decode(_layer(params["layers"], i), x, cfg,
                            {k: a[i] for k, a in cache.items()}, pos,
                            mrope3=mrope3, attn_impl=attn_impl)
    x = common.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x[:, -1] @ lm_head_weight(params, cfg)
    return logits.float(), cache


def empty_cache(cfg: ModelConfig, batch: int, seq: int, dtype=None,
                device="cpu") -> dict:
    """The stacked zeroed cache {leaf: (L, batch, seq, ...)}."""
    one = attn.empty_cache(cfg, batch, seq, dtype, device="meta")
    return {k: torch.zeros((cfg.num_layers,) + tuple(a.shape),
                           dtype=a.dtype, device=device)
            for k, a in one.items()}
