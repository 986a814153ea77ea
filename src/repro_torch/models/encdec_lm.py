"""Encoder-decoder backbone (seamless-m4t-medium language/decoder side).

PyTorch port of ``repro/models/encdec_lm.py``.  The audio frontend is a
stub: ``batch["frames"]`` carries precomputed frame embeddings (B, S_enc,
D) and a learned projection (``frame_proj``) makes it non-trivial.  The
encoder is non-causal GQA self attention + SwiGLU; each decoder layer is
causal self attention, cross attention over the encoder's output, then
SwiGLU.

Every attention runs the flash-attention kernel on the card (non-causal
for the encoder and for cross attention at Sq != Sk, its backward while
training) and a decode step the flash-decoding kernel over the self and
the cross caches, as ``models/attention`` chooses by ``attn_impl``.  With
``cfg.remat`` each encoder and decoder layer of the loss path runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` bodies).
The caches are ``{"self": {k, v}, "cross": {k, v}}`` with the layers
stacked on a leading axis; ``decode_fn`` writes the self cache in place.

With a sharding ``ctx`` (``repro_torch.sharding``) the passes run on a
device mesh as ``dense_lm``'s do: the batch's rows (frames, tokens,
labels) split over the batch axes; the self, cross and encoder attention
heads and the MLP columns over the model axis (tensor-parallel); the
embedding, head and cross-entropy split by vocabulary
(``dense_lm.embed`` / ``logits_of`` / ``xent``).  The decode's self cache
is split by sequence over the model axis, its cross cache too when the
axis divides ``enc_seq_len`` (``attention.cross_attn_apply``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import sharding as sh
from repro_torch.models import attention as attn
from repro_torch.models import common, dense_lm
from repro_torch.models.config import ModelConfig


def _enc_layer_init(rng: np.random.Generator, cfg: ModelConfig) -> dict:
    dt = cfg.dtype
    return {
        "attn_norm": common.ones((cfg.d_model,), dt),
        "attn": attn.gqa_init(rng, cfg),
        "ffn_norm": common.ones((cfg.d_model,), dt),
        "mlp": common.mlp_init(rng, cfg.d_model, cfg.d_ff, dt),
    }


def _dec_layer_init(rng: np.random.Generator, cfg: ModelConfig) -> dict:
    dt = cfg.dtype
    return {
        "self_norm": common.ones((cfg.d_model,), dt),
        "self_attn": attn.gqa_init(rng, cfg),
        "cross_norm": common.ones((cfg.d_model,), dt),
        "cross_attn": attn.gqa_init(rng, cfg),
        "ffn_norm": common.ones((cfg.d_model,), dt),
        "mlp": common.mlp_init(rng, cfg.d_model, cfg.d_ff, dt),
    }


def init_params(rng: np.random.Generator, cfg: ModelConfig) -> dict:
    dt = cfg.dtype
    return {
        "frame_proj": common.dense_init(rng, cfg.d_model, cfg.d_model, dt),
        "enc_layers": common.stack_trees([_enc_layer_init(rng, cfg)
                                          for _ in range(cfg.enc_layers)]),
        "enc_norm": common.ones((cfg.d_model,), dt),
        "embed": common.embed_init(rng, cfg.padded_vocab, cfg.d_model, dt),
        "dec_layers": common.stack_trees([_dec_layer_init(rng, cfg)
                                          for _ in range(cfg.num_layers)]),
        "final_norm": common.ones((cfg.d_model,), dt),
        "lm_head": common.dense_init(rng, cfg.d_model, cfg.padded_vocab, dt),
    }


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


def _remat(cfg: ModelConfig) -> bool:
    return cfg.remat and torch.is_grad_enabled()


def _mlp(p, h, cfg: ModelConfig, impl: Optional[str], ctx):
    f = common.rms_norm(h, p["ffn_norm"], cfg.norm_eps)
    return h + common.mlp_apply_ctx(p["mlp"], f, cfg.d_ff, impl, ctx)


def encode(params, frames, cfg: ModelConfig, impl: Optional[str] = None,
           ctx=None) -> torch.Tensor:
    """The encoder's output (B, S_enc, D) of this rank's rows of the
    global ``frames`` (all of them without a ``ctx``)."""
    frames = sh.batch_rows(ctx, frames)
    b, s_enc, _ = frames.shape
    x = frames.to(cfg.torch_dtype) @ params["frame_proj"]
    positions = _positions(b, s_enc, x.device)

    def body(p, h):
        a = common.rms_norm(h, p["attn_norm"], cfg.norm_eps)
        a, _ = attn.gqa_prefill(p["attn"], a, cfg, positions, causal=False,
                                make_cache=False, attn_impl=impl, ctx=ctx)
        return _mlp(p, h + a, cfg, impl, ctx)

    for i in range(cfg.enc_layers):
        p = common.take(params["enc_layers"], i)
        x = common.maybe_checkpoint(_remat(cfg), body, p, x)
    return common.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _dec_layer_prefill(p, h, enc_out, cfg: ModelConfig, positions,
                       make_cache: bool, impl: Optional[str], ctx=None):
    a = common.rms_norm(h, p["self_norm"], cfg.norm_eps)
    a, self_cache = attn.gqa_prefill(p["self_attn"], a, cfg, positions,
                                     causal=True, make_cache=make_cache,
                                     attn_impl=impl, ctx=ctx)
    h = h + a
    c = common.rms_norm(h, p["cross_norm"], cfg.norm_eps)
    cross_kv = attn.cross_attn_prefill_kv(p["cross_attn"], enc_out, cfg,
                                          impl, ctx)
    h = h + attn.cross_attn_apply(p["cross_attn"], c, cross_kv, cfg, impl,
                                  ctx)
    if make_cache:
        cross_kv = attn.gather_heads(ctx, cross_kv, cfg)
    return _mlp(p, h, cfg, impl, ctx), self_cache, cross_kv


def _decoder_inputs(params, batch: dict, cfg: ModelConfig,
                    impl: Optional[str], ctx):
    enc_out = encode(params, batch["frames"].to(params["embed"].device), cfg,
                     impl, ctx)
    tokens = sh.batch_rows(ctx, batch["tokens"]).long()
    b, s = tokens.shape
    return (enc_out, dense_lm.embed(params, tokens, cfg, ctx),
            _positions(b, s, enc_out.device))


def loss_fn(params, batch: dict, cfg: ModelConfig,
            impl: Optional[str] = None, ctx=None
            ) -> Tuple[torch.Tensor, dict]:
    enc_out, x, positions = _decoder_inputs(params, batch, cfg, impl, ctx)

    def body(p, h, e):
        return _dec_layer_prefill(p, h, e, cfg, positions, False, impl,
                                  ctx)[0]

    for i in range(cfg.num_layers):
        p = common.take(params["dec_layers"], i)
        x = common.maybe_checkpoint(_remat(cfg), body, p, x, enc_out)
    x = common.rms_norm(x, params["final_norm"], cfg.norm_eps)
    loss = dense_lm.xent(params, x, batch["labels"], cfg, ctx)
    return loss, {"xent": loss}


def prefill_fn(params, batch: dict, cfg: ModelConfig,
               impl: Optional[str] = None, ctx=None):
    """(last-token logits (B, V) fp32, the stacked caches {"self": {k, v}
    (L, B, S, KV, dh), "cross": {k, v} (L, B, S_enc, KV, dh)}).  Under a
    ``ctx`` the logits are the global batch's and the caches hold this
    rank's rows, every head and every slot (``api.shard_cache`` lays them
    out for ``decode_fn``)."""
    enc_out, x, positions = _decoder_inputs(params, batch, cfg, impl, ctx)
    caches = []
    for i in range(cfg.num_layers):
        x, self_c, cross_c = _dec_layer_prefill(
            common.take(params["dec_layers"], i), x, enc_out, cfg, positions,
            True, impl, ctx)
        caches.append({"self": self_c, "cross": cross_c})
    x = common.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (dense_lm.logits_of(params, x[:, -1], cfg, ctx),
            common.stack_trees(caches))


def decode_fn(params, tokens, cache: dict, pos, cfg: ModelConfig,
              impl: Optional[str] = None, ctx=None):
    """tokens (B, 1) at self-cache position ``pos`` -> (logits (B, V)
    fp32, cache), the self cache written in place.  Under a ``ctx`` the
    tokens and logits are the global batch's and the cache this rank's
    shard (``api.shard_cache``)."""
    x = dense_lm.embed(params, sh.batch_rows(ctx, tokens).long(), cfg, ctx)
    for i in range(cfg.num_layers):
        p, c = common.take(params["dec_layers"], i), common.take(cache, i)
        a = common.rms_norm(x, p["self_norm"], cfg.norm_eps)
        a, _ = attn.gqa_decode(p["self_attn"], a, cfg, c["self"], pos,
                               attn_impl=impl, ctx=ctx)
        x = x + a
        cc = common.rms_norm(x, p["cross_norm"], cfg.norm_eps)
        x = x + attn.cross_attn_apply(p["cross_attn"], cc, c["cross"], cfg,
                                      impl, ctx)
        x = _mlp(p, x, cfg, impl, ctx)
    x = common.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return dense_lm.logits_of(params, x[:, -1], cfg, ctx), cache


def empty_cache(cfg: ModelConfig, batch: int, seq: int, dtype=None,
                device="cpu") -> dict:
    """{"self": {k, v} (L, batch, seq, KV, dh), "cross": {k, v} (L, batch,
    enc_seq_len, KV, dh)}, zeroed."""
    def stacked(s):
        one = attn.empty_cache(cfg, batch, s, dtype, device="meta")
        return {k: torch.zeros((cfg.num_layers,) + tuple(a.shape),
                               dtype=a.dtype, device=device)
                for k, a in one.items()}
    return {"self": stacked(seq), "cross": stacked(cfg.enc_seq_len)}
