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
on the CPU or with ``attn_impl=None``.  A sharding ``ctx`` raises; the
reference's parameter partition specs belong to sharding and are not
ported either.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch.checkpoint.partition import from_jax_params
from repro_torch.core.modules import resolve_attn_impl
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


def _no_ctx(ctx) -> None:
    if ctx is not None:
        raise NotImplementedError("a sharding ctx (the device mesh) is not "
                                  "yet ported in repro_torch")


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
        _no_ctx(ctx)
        return loss_fn(p, b, cfg, impl(p))

    def prefill(p, b, ctx=None):
        _no_ctx(ctx)
        return prefill_fn(p, b, cfg, impl(p))

    def decode(p, t, c, pos, ctx=None):
        _no_ctx(ctx)
        return decode_fn(p, t, c, pos, cfg, impl(p))

    def empty_cache(b, s, dt=None, device="cuda"):
        return cache_fn(cfg, b, s, dt, device)

    return ModelAPI(cfg=cfg, init=init, loss=loss, prefill=prefill,
                    decode=decode, empty_cache=empty_cache)
