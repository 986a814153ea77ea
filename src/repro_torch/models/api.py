"""Uniform model API across families, PyTorch port of
``repro/models/api.py``.

``build_model(cfg)`` returns a ``ModelAPI`` of plain functions over a
parameter tree of tensors:

* ``init(rng, device="cuda")`` -> the parameters drawn by ``numpy``'s
  ``rng`` (``dense_lm.init_params``), as tensors on ``device``;
* ``loss(params, batch, ctx=None)`` -> (loss, {"xent", "aux"});
* ``prefill(params, batch, ctx=None)`` -> (last-token logits, cache);
* ``decode(params, tokens, cache, pos, ctx=None)`` -> (logits, cache),
  the cache written in place;
* ``empty_cache(batch, seq, dtype=None, device="cuda")`` -> the stacked
  zeroed cache.

DENSE, MOE and VLM configs (GQA or MLA attention) are ported.  The
passes run the hand-written kernels when their tensors lie on a CUDA
device (``attn_impl="auto"``), their plain versions on the CPU or with
``attn_impl=None``.  ENCDEC, XLSTM and MAMBA_HYBRID raise, and so does a
sharding ``ctx``; the reference's parameter partition specs belong to
sharding and are not ported either.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch.checkpoint.partition import from_jax_params
from repro_torch.core.modules import resolve_attn_impl
from repro_torch.models import attention, dense_lm
from repro_torch.models.config import (ENCDEC, MAMBA_HYBRID, XLSTM,
                                       ModelConfig)

UNPORTED = (ENCDEC, XLSTM, MAMBA_HYBRID)


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable[..., Any]          # (rng, device) -> params
    loss: Callable[..., Any]          # (params, batch, ctx) -> (loss, metrics)
    prefill: Callable[..., Any]       # (params, batch, ctx) -> (logits, cache)
    decode: Callable[..., Any]        # (params, tok, cache, pos, ctx) -> ...
    empty_cache: Callable[..., Any]   # (batch, seq, dtype?, device) -> cache


def _no_ctx(ctx) -> None:
    if ctx is not None:
        raise NotImplementedError("a sharding ctx (the device mesh) is not "
                                  "yet ported in repro_torch")


def build_model(cfg: ModelConfig,
                attn_impl: Optional[str] = "auto") -> ModelAPI:
    cfg.validate()
    if cfg.family in UNPORTED:
        raise NotImplementedError(
            f"model family '{cfg.family}' ({cfg.name}) is not yet ported in "
            f"repro_torch's model API (dense, MoE and VLM only)")
    attention.check_attention(cfg)

    def impl(params):
        return resolve_attn_impl(attn_impl, params["embed"].device)

    def init(rng, device="cuda"):
        return from_jax_params(dense_lm.init_params(rng, cfg), device)

    def loss(p, b, ctx=None):
        _no_ctx(ctx)
        return dense_lm.loss_fn(p, b, cfg, impl(p))

    def prefill(p, b, ctx=None):
        _no_ctx(ctx)
        return dense_lm.prefill_fn(p, b, cfg, impl(p))

    def decode(p, t, c, pos, ctx=None):
        _no_ctx(ctx)
        return dense_lm.decode_fn(p, t, c, pos, cfg, impl(p))

    def empty_cache(b, s, dt=None, device="cuda"):
        return dense_lm.empty_cache(cfg, b, s, dt, device)

    return ModelAPI(cfg=cfg, init=init, loss=loss, prefill=prefill,
                    decode=decode, empty_cache=empty_cache)
