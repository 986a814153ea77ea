"""Uniform model API across families, PyTorch port of
``repro/models/api.py``.

``build_model(cfg)`` returns a ``ModelAPI`` of plain functions over a
parameter tree of tensors:

* ``init(rng, device="cuda")`` -> the parameters drawn by ``numpy``'s
  ``rng`` (the family's ``init_params`` / ``xlstm_init`` /
  ``zamba_init``: the reference's leaf names, shapes and dtypes), as
  tensors on ``device``;
* ``loss(params, batch, ctx=None)`` -> (loss, metrics): {"xent", "aux"}
  for the decoder families, {"xent"} for the others, as in the reference;
* ``prefill(params, batch, ctx=None)`` -> (last-token logits, cache);
* ``decode(params, tokens, cache, pos, ctx=None)`` -> (logits, cache):
  KV caches written in place, recurrent states new;
* ``empty_cache(batch, seq, dtype=None, device="cuda")`` -> the stacked
  zeroed cache (xLSTM: the empty recurrent state; ``seq`` unused).

Every family is ported: DENSE, MOE and VLM (GQA or MLA attention, in
``dense_lm``), ENCDEC (``encdec_lm``), XLSTM and MAMBA_HYBRID
(``recurrent_lm``).  The passes run the hand-written kernels when their
tensors lie on a CUDA device (``attn_impl="auto"``), their plain versions
on the CPU or with ``attn_impl=None``.

A sharding ``ctx`` (``repro_torch.sharding.ShardingCtx``) runs every
family on a device mesh: DENSE, MOE and VLM with GQA or MLA attention,
ENCDEC, XLSTM and MAMBA_HYBRID.  Each rank passes the parameter slices
``shard_params`` gives it and the global batch, of which it takes its
rows; ``loss`` returns the global loss and ``prefill`` / ``decode`` the
global logits.  ``prefill`` returns this rank's rows of the cache (every
head, every prompt slot) and ``decode`` takes the decode layout
``shard_cache`` makes: this rank's rows, and the sequence of the
attention caches split over the model axis.  int8 / int4 parameters
(``QuantizedTensor`` leaves) raise under a ctx.

``param_pspecs`` gives the reference's storage layout (its ``_NAME_RULES``
and ``_MOE_RULES``): per leaf a tuple of mesh axes (or None) per
dimension, as ``tuple(PartitionSpec)`` reads.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional

import torch

from repro_torch import sharding as sh
from repro_torch.checkpoint.partition import (from_jax_params, tree_leaves,
                                              tree_map)
from repro_torch.checkpoint.quant import QuantizedTensor
from repro_torch.core.modules import resolve_attn_impl
from repro_torch.launch.mesh import mesh_shape
from repro_torch.models import attention, dense_lm, encdec_lm, recurrent_lm
from repro_torch.models.config import (ENCDEC, MAMBA_HYBRID, XLSTM,
                                       ModelConfig)

# family -> (init, loss, prefill, decode, empty_cache), each taking the
# config and, for the passes, the resolved attention impl
_FAMILIES = {
    ENCDEC: (encdec_lm.init_params, encdec_lm.loss_fn, encdec_lm.prefill_fn,
             encdec_lm.decode_fn, encdec_lm.empty_cache),
    XLSTM: (recurrent_lm.xlstm_init, recurrent_lm.xlstm_loss,
            recurrent_lm.xlstm_prefill, recurrent_lm.xlstm_decode,
            lambda cfg, b, s, dt, device: recurrent_lm.xlstm_empty_state(
                cfg, b, device)),
    MAMBA_HYBRID: (recurrent_lm.zamba_init, recurrent_lm.zamba_loss,
                   recurrent_lm.zamba_prefill, recurrent_lm.zamba_decode,
                   recurrent_lm.zamba_empty_cache),
}
_DECODER = (dense_lm.init_params, dense_lm.loss_fn, dense_lm.prefill_fn,
            dense_lm.decode_fn, dense_lm.empty_cache)


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable[..., Any]          # (rng, device) -> params
    loss: Callable[..., Any]          # (params, batch, ctx) -> (loss, metrics)
    prefill: Callable[..., Any]       # (params, batch, ctx) -> (logits, cache)
    decode: Callable[..., Any]        # (params, tok, cache, pos, ctx) -> ...
    empty_cache: Callable[..., Any]   # (batch, seq, dtype?, device) -> cache


def _ctx_kw(cfg: ModelConfig, ctx, params) -> dict:
    """The passes' ``ctx`` keyword ({} without one).  Raises ``TypeError``
    for a ctx that is not a ``ShardingCtx``, and ``NotImplementedError``
    for quantized parameters under one (not yet ported)."""
    if ctx is None:
        return {}
    if not isinstance(ctx, sh.ShardingCtx):
        raise TypeError(f"ctx must be a ShardingCtx, got {type(ctx)}")
    if any(isinstance(t, QuantizedTensor) for t in tree_leaves(params)):
        raise NotImplementedError(f"int8 / int4 parameters under a sharding "
                                  f"ctx ({cfg.name}) are not yet ported in "
                                  f"repro_torch")
    return {"ctx": ctx}


def build_model(cfg: ModelConfig,
                attn_impl: Optional[str] = "auto") -> ModelAPI:
    cfg.validate()
    attention.check_attention(cfg)
    init_fn, loss_fn, prefill_fn, decode_fn, cache_fn = _FAMILIES.get(
        cfg.family, _DECODER)

    def impl(params):
        return resolve_attn_impl(attn_impl, params["embed"].device)

    def init(rng, device="cuda"):
        return from_jax_params(init_fn(rng, cfg), device)

    def loss(p, b, ctx=None):
        return loss_fn(p, b, cfg, impl(p), **_ctx_kw(cfg, ctx, p))

    def prefill(p, b, ctx=None):
        return prefill_fn(p, b, cfg, impl(p), **_ctx_kw(cfg, ctx, p))

    def decode(p, t, c, pos, ctx=None):
        return decode_fn(p, t, c, pos, cfg, impl(p), **_ctx_kw(cfg, ctx, p))

    def empty_cache(b, s, dt=None, device="cuda"):
        return cache_fn(cfg, b, s, dt, device)

    return ModelAPI(cfg=cfg, init=init, loss=loss, prefill=prefill,
                    decode=decode, empty_cache=empty_cache)


# ===========================================================================
# Partition specs for parameters (and optimizer state, which mirrors them)
# ===========================================================================
# rule: leaf-name -> (base_ndim, spec for the unstacked leaf)
_NAME_RULES = {
    "embed": (2, ("model", None)),
    "lm_head": (2, (None, "model")),
    "w_q": (2, (None, "model")),
    "w_k": (2, (None, "model")),
    "w_v": (2, (None, "model")),
    "w_o": (2, ("model", None)),
    "b_q": (1, ("model",)),
    "b_k": (1, ("model",)),
    "b_v": (1, ("model",)),
    "w_up": (2, (None, "model")),
    "w_gate": (2, (None, "model")),
    "w_down": (2, ("model", None)),
    # MLA up-projections (low-rank downs stay replicated by default)
    "w_uq_nope": (2, (None, "model")),
    "w_uq_rope": (2, (None, "model")),
    "w_uk": (2, (None, "model")),
    "w_uv": (2, (None, "model")),
}
# 3D expert weights (E, D, F): shard the expert dim on the model axis
_MOE_RULES = {
    "w_gate": (3, ("model", None, None)),
    "w_up": (3, ("model", None, None)),
    "w_down": (3, ("model", None, None)),
}


def _spec_for_leaf(path, leaf) -> tuple:
    """The storage spec of the leaf at ``path`` (its dict keys, root
    first): the rule for its name, with None for the stacked dims ahead
    of it; () (replicated) without a rule.  In an MoE block only the
    expert weights have rules (the router is replicated)."""
    if not path:
        return ()
    name = path[-1]
    rule = (_MOE_RULES if "moe" in path else _NAME_RULES).get(name)
    if rule is None:
        return ()
    base_ndim, spec = rule
    extra = len(leaf.shape) - base_ndim
    if extra < 0:
        return ()
    return (None,) * extra + spec


def _shard_size_ok(leaf, spec: tuple, shape: Mapping[str, int]) -> bool:
    return all(ax is None or dim % shape.get(ax, 1) == 0
               for dim, ax in zip(leaf.shape, spec))


def param_pspecs(params, mesh=None):
    """Tree of per-leaf specs matching ``params`` (tensors, numpy arrays or
    anything with ``shape``): the reference's ``param_pspecs``, each
    ``PartitionSpec`` as its tuple.  ``mesh`` (a ``DeviceMesh``, a ctx or
    {axis: size}) replicates a leaf whose sharded dimension does not
    divide its axis."""
    if isinstance(mesh, sh.ShardingCtx):
        mesh = mesh.mesh
    shape = mesh_shape(mesh) if mesh is not None else None

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        spec = _spec_for_leaf(path, tree)
        if shape is not None and not _shard_size_ok(tree, spec, shape):
            return ()
        return spec
    return walk(params, ())


def _shard_leaf(x, spec: tuple, ctx: sh.ShardingCtx):
    for dim, ax in enumerate(spec):
        if ax is not None:
            x = sh.local_slice(ctx, x, ax, dim)
    return x


def shard_params(params, ctx: Optional[sh.ShardingCtx]):
    """This rank's slices of the full parameters (numpy arrays or tensors,
    views where the input allows), by ``param_pspecs`` on ``ctx``'s mesh:
    the counterpart of ``jax.device_put(params, named(mesh, pspecs))``.
    The optimiser's moments mirror them (``adamw_init`` of the result)."""
    if ctx is None:
        return params
    specs = param_pspecs(params, ctx)

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k]) for k, v in tree.items()}
        return _shard_leaf(tree, spec, ctx)
    return walk(params, specs)


def shard_cache(cache, ctx: Optional[sh.ShardingCtx], total: int):
    """The decode layout of the stacked cache that ``prefill`` under
    ``ctx`` returns (this rank's rows of B, every head, every prompt
    slot), as the reference's ``cache_pspecs`` places it:

    * attention caches, (L, B, S, ...): GQA's {k, v}, MLA's latent {c, kr},
      an enc-dec's self cache and Zamba2's site caches {"attn": {k, v}}:
      S padded with zero slots to the decode's length ``total``, then this
      rank's slice of S on the model axis (``P(None, batch, model)``);
    * an enc-dec's cross cache {"cross": {k, v}} (L, B, S_enc, ...): this
      rank's slice of S_enc when the model axis divides it, else whole
      (``attention.cross_seq_sharded`` reads the same rule from the
      config's ``enc_seq_len``, which S_enc must equal);
    * recurrent states (Mamba2's {"mamba": ...}, xLSTM's mLSTM / sLSTM):
      as they are, this rank's rows with every head."""
    if ctx is None:
        raise ValueError("shard_cache needs a ShardingCtx")

    def seq(x, pad_to):
        if pad_to > x.shape[2]:
            pad = list(x.shape)
            pad[2] = pad_to - x.shape[2]
            x = torch.cat([x, x.new_zeros(pad)], dim=2)
        return sh.local_slice(ctx, x, ctx.model_axis, 2).contiguous()

    def attn_cache(tree):
        return tree_map(lambda x: seq(x, total), tree)

    if "self" in cache:                                     # ENCDEC
        cross = cache["cross"]
        if cross["k"].shape[2] % ctx.model_size == 0:
            cross = tree_map(lambda x: seq(x, 0), cross)
        return {"self": attn_cache(cache["self"]), "cross": cross}
    if "mamba" in cache:                                    # MAMBA_HYBRID
        return {"mamba": cache["mamba"],
                "attn": cache["attn"] and attn_cache(cache["attn"])}
    if "mlstm" in cache:                                    # XLSTM
        return cache
    return attn_cache(cache)
