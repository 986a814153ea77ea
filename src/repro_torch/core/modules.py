"""Per-layer executable modules for the PIPELOAD Execution Engine.

PyTorch port of ``repro/core/modules.py`` (dense, MoE and VLM families;
GQA and MLA attention).  The engine
operates at shard granularity: ``embed`` -> N x ``layer`` -> ``head``,
in two generation regimes:

  * **re-prefill** (the paper's §V-B2 semantics): ``layer`` is a
    full-sequence forward without a cache;
  * **KV-cache incremental decode**: ``layer_cache`` is the prefill that
    also emits the layer's KV cache, allocated once at ``total_len`` slots
    so later single-token writes go in place, and ``layer_decode``
    advances one token against it.  ``layer_decode_paged`` and
    ``layer_verify_paged`` do the same against paged pools (one token,
    or W stacked tokens, per request) through block tables.

Prefill attention runs the hand-written flash-attention kernel, decode
attention the flash-decoding kernel, paged attention the paged decode
and verify kernels, and every linear layer of an int8/int4 shard the
dequantizing matmul kernel (``attn_impl="auto"`` picks them for a CUDA
device and their plain versions on the CPU; ``None`` asks for the plain
versions on any device).  There is no jit: every call runs eagerly on the
device its inputs live on.

Quantized checkpoints arrive as weight trees whose 2-D matmul weights are
``QuantizedTensor`` leaves, and stay so: the reference dequantizes whole
trees inside its jit, the port multiplies by the quantized form
(``common.linear``) and gathers embedding rows from it (``take_rows``), so
no fp32 copy of a quantized weight is built.

MoE-family configs run ``models/moe.py``'s experts inside the whole-layer
fns (whole-layer checkpoints) and also get the **expert-streaming split**
of the layer forward, which ``core/expert_stream.py`` drives for
expert-split checkpoints:

  * ``moe_router`` / ``moe_router_cache`` / ``moe_router_decode``: the
    attention block (the same kernels as the dense fns) plus the router.
    They return the post-attention residual, the normed FFN input and the
    batch's normalised top-k routing ``(top_w, top_ids)``; the engine
    reads ``top_ids`` back and demand-loads exactly those experts.
  * ``moe_combine``: capacity-based dispatch, expert FFN and combine over
    the round's activated experts only.  Every kept (token, expert) pair
    lands in the buffer row the in-memory oracle gives it, with the same
    capacity-drop rule; experts that received no token had all-zero rows
    in the oracle.  Unlike the reference, the union is not padded to a
    power-of-two bucket (the bucket exists so XLA compiles once per
    bucket; eager PyTorch compiles nothing), and the experts run one by
    one on their weights as streamed, so no stacked copy of the union's
    weights is built on the device.  An int8 / int4 expert runs its SwiGLU
    as three quantized matmuls (``common.mlp_apply``), where the reference
    dequantizes the union's weights inside its jit.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.checkpoint.quant import is_quantized
from repro_torch.models import moe
from repro_torch.models.attention import KERNEL
from repro_torch.models.common import linear, mlp_apply, rms_norm
from repro_torch.models.config import DENSE, MOE, VLM, ModelConfig
from repro_torch.models.dense_lm import (attn_decode, attn_prefill,
                                         check_dense, layer_decode,
                                         layer_decode_paged, layer_prefill,
                                         layer_verify_paged)

# Families the PIPELOAD engine can execute at shard granularity (a VLM
# backbone serves text, as in the reference's engine).
ENGINE_FAMILIES = (DENSE, MOE, VLM)


def check_engine_family(cfg: ModelConfig, where: str = "the PIPELOAD "
                        "engine") -> None:
    """Raise a clear error for families the port cannot stream yet."""
    if cfg.family not in ENGINE_FAMILIES:
        raise NotImplementedError(
            f"model family '{cfg.family}' ({cfg.name}) is not yet ported "
            f"in repro_torch for {where}; ported families: "
            f"{', '.join(ENGINE_FAMILIES)}")
    check_dense(cfg)


def resolve_attn_impl(attn_impl: Optional[str],
                      device: torch.device) -> Optional[str]:
    """"auto" -> the hand-written kernels on a CUDA device, the plain
    versions on the CPU; None -> the plain versions on any device."""
    if attn_impl == "auto":
        return KERNEL if torch.device(device).type == "cuda" else None
    if attn_impl not in (None, KERNEL):
        raise ValueError(f"unknown attn_impl {attn_impl!r}; choose 'auto', "
                         f"'{KERNEL}' or None")
    return attn_impl


def _pad_seq(a: torch.Tensor, total_len: int) -> torch.Tensor:
    """Grow a cache leaf (B, S, ...) to (B, total_len, ...), allocated
    once; later decode steps write into it in place."""
    if a.shape[1] >= total_len:
        return a
    out = torch.zeros((a.shape[0], total_len) + tuple(a.shape[2:]),
                      dtype=a.dtype, device=a.device)
    out[:, :a.shape[1]] = a
    return out


def _positions(x: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    return torch.arange(s, device=x.device)[None].expand(b, s)


def build_module_fns(cfg: ModelConfig, attn_impl: Optional[str] = "auto",
                     device="cuda") -> Dict[str, Callable]:
    """{embed, layer, layer_cache, layer_decode, layer_decode_paged,
    [layer_verify_paged,] head, head_all} apply functions (weights are
    arguments: the engine streams them), plus the expert-streaming split
    (moe_router, moe_router_cache, moe_router_decode, moe_combine) for
    MoE-family configs."""
    check_engine_family(cfg)
    impl = resolve_attn_impl(attn_impl, device)

    def embed_apply(weights, tokens):
        emb = weights["embed"]
        if is_quantized(emb):
            return emb.take_rows(tokens)
        return emb[tokens]

    def layer_apply(weights, x):
        out, _ = layer_prefill(weights, x, cfg, _positions(x),
                               make_cache=False, attn_impl=impl)
        return out

    def layer_cache_apply(weights, x, total_len: int):
        """Prefill one layer AND capture its KV cache, padded to
        ``total_len`` slots so decode steps write in place."""
        out, cache = layer_prefill(weights, x, cfg, _positions(x),
                                   make_cache=True, attn_impl=impl)
        return out, {k: _pad_seq(a, total_len) for k, a in cache.items()}

    def layer_decode_apply(weights, x, cache, pos):
        """One token per sequence (B, 1, D) against this layer's cache;
        ``pos`` is an int or a RAGGED (B,) device vector."""
        return layer_decode(weights, x, cfg, cache, pos, attn_impl=impl)

    # Paged KV (core/kv_pages.py): cache leaves live in (P, page, ...) page
    # pools and each request's sequence is a block table of page ids.
    # Full-attention GQA takes the paged kernels; MLA ({c, kr} latent
    # leaves) and sliding-window configs gather the rows' pages into the
    # contiguous cache, run the ordinary layer_decode and scatter the one
    # written row back into its page.
    gqa_paged = cfg.attention != "mla" and cfg.sliding_window is None

    def layer_decode_paged_apply(weights, x, pools, tables, pos):
        """One token per request against the paged cache: ``pools`` is
        this layer's cache dict with (P, page, ...) leaves ({k, v} of
        (P, page, KV, dh), or MLA's {c, kr}), written in place;
        ``tables`` (B, NB) int32 on the device; ``pos`` (B,) ragged
        write positions.  The write page must be private."""
        b, nb = tables.shape
        posv = pos.reshape(b)
        if gqa_paged:
            return layer_decode_paged(weights, x, cfg, pools, tables, posv,
                                      attn_impl=impl)
        ps = next(iter(pools.values())).shape[1]
        cache = {k: a[tables].reshape((b, nb * ps) + tuple(a.shape[2:]))
                 for k, a in pools.items()}
        out, cache = layer_decode(weights, x, cfg, cache, posv,
                                  attn_impl=impl)
        rows = torch.arange(b, device=x.device)
        pids = tables[rows, posv // ps]
        for k, a in pools.items():
            a[pids, posv % ps] = cache[k][rows, posv].to(a.dtype)
        return out, pools

    def layer_verify_paged_apply(weights, x, pools, tables, pos):
        """W stacked tokens per request (B, W, D) against the paged cache;
        ``pos`` (B,) is the slot of each row's FIRST stacked token."""
        return layer_verify_paged(weights, x, cfg, pools, tables,
                                  pos.reshape(tables.shape[0]),
                                  attn_impl=impl)

    def head_apply(weights, x):
        h = rms_norm(x, weights["final_norm"], cfg.norm_eps)
        if "lm_head" in weights:
            return linear(h[:, -1], weights["lm_head"], impl).float()
        return h[:, -1].float()

    def head_all_apply(weights, x):
        """Logits for EVERY stacked position (B, W, V)."""
        h = rms_norm(x, weights["final_norm"], cfg.norm_eps)
        if "lm_head" in weights:
            return linear(h, weights["lm_head"], impl).float()
        return h.float()

    fns = {"embed": embed_apply, "layer": layer_apply,
           "layer_cache": layer_cache_apply,
           "layer_decode": layer_decode_apply,
           "layer_decode_paged": layer_decode_paged_apply,
           "head": head_apply, "head_all": head_all_apply}
    if gqa_paged:
        # the stacked path has no windowed or MLA variant; the key's
        # presence is how callers test for it
        fns["layer_verify_paged"] = layer_verify_paged_apply
    if cfg.family == MOE:
        fns.update(_build_moe_stream_fns(cfg, impl))
    return fns


# ===========================================================================
# Expert-streaming MoE split (core/expert_stream.py drives these)
# ===========================================================================
def _build_moe_stream_fns(cfg: ModelConfig,
                          impl: Optional[str]) -> Dict[str, Callable]:
    k, n_e = cfg.top_k, cfg.n_experts

    def route(weights, x):
        """Post-attention residual -> (flat FFN input, normalised top-k
        weights, expert ids): ``models/moe._moe_local``'s routing."""
        hf = rms_norm(x, weights["ffn_norm"], cfg.norm_eps)
        hf = hf.reshape(-1, hf.shape[-1])
        logits = moe.router_logits(weights["moe"]["router"], hf)
        _, top_w, top_ids = moe.top_k_routing(logits, k)
        return hf, top_w, top_ids

    def attn_block(weights, x, make_cache: bool):
        h = rms_norm(x, weights["attn_norm"], cfg.norm_eps)
        a, cache = attn_prefill(weights["attn"], h, cfg, _positions(x),
                                make_cache=make_cache, attn_impl=impl)
        return x + a, cache

    def moe_router_apply(weights, x):
        """Full-sequence attention + router (no cache)."""
        xa, _ = attn_block(weights, x, False)
        return (xa,) + route(weights, xa)

    def moe_router_cache_apply(weights, x, total_len: int):
        """Cache-capturing prefill (padded as ``layer_cache`` pads)."""
        xa, cache = attn_block(weights, x, True)
        cache = {name: _pad_seq(a, total_len) for name, a in cache.items()}
        return (xa, cache) + route(weights, xa)

    def moe_router_decode_apply(weights, x, cache, pos):
        """One token per row against the layer cache, then the router;
        ``pos`` an int or a ragged (B,) device vector."""
        h = rms_norm(x, weights["attn_norm"], cfg.norm_eps)
        a, cache = attn_decode(weights["attn"], h, cfg, cache, pos,
                               attn_impl=impl)
        xa = x + a
        return (xa, cache) + route(weights, xa)

    def moe_combine_apply(experts, ids, xa, hf, top_w, top_ids):
        """Dispatch + expert FFN + combine over the round's streamed
        experts: ``experts[i]`` holds the weights of global expert
        ``ids[i]`` (``ids`` ascending).  The dispatch is the oracle's
        ``_dispatch_indices`` over all experts (same capacity, same drop
        rule); each kept pair's global row is then moved onto the union's
        buffer."""
        u = len(ids)
        t, d = hf.shape
        dev = hf.device
        cap = moe.capacity(cfg, t)
        slots = moe._dispatch_indices(top_ids, k, n_e, cap, 0, n_e)
        # global expert id -> union slot (-1: not streamed this round)
        inv = torch.full((n_e + 1,), -1, dtype=torch.long, device=dev)
        inv[torch.as_tensor(ids, dtype=torch.long, device=dev)] = \
            torch.arange(u, device=dev)
        uslot = inv[torch.clamp(slots // cap, max=n_e)]
        local = torch.where((slots < n_e * cap) & (uslot >= 0),
                            uslot * cap + slots % cap,
                            torch.full_like(slots, u * cap))
        tok = torch.arange(t, device=dev).repeat_interleave(k)
        buf = hf.new_zeros((u * cap + 1, d))       # + a sink for drops
        buf[local.reshape(-1)] = hf[tok]
        out = hf.new_empty((u * cap, d))
        for i, w in enumerate(experts):
            rows = slice(i * cap, (i + 1) * cap)
            if is_quantized(w["w_gate"]):
                # int8 / int4 shards: three quantized matmuls on the
                # weights as streamed, never widened
                out[rows] = mlp_apply(w, buf[rows], impl)
            else:
                out[rows] = moe._expert_ffn(buf[rows][None],
                                            w["w_gate"][None],
                                            w["w_up"][None],
                                            w["w_down"][None])[0]
        return xa + moe.combine(out, local, top_w).reshape(xa.shape)

    return {"moe_router": moe_router_apply,
            "moe_router_cache": moe_router_cache_apply,
            "moe_router_decode": moe_router_decode_apply,
            "moe_combine": moe_combine_apply}
