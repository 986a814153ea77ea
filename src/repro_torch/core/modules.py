"""Per-layer executable modules for the PIPELOAD Execution Engine.

PyTorch port of ``repro/core/modules.py`` (dense family).  The engine
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
attention the flash-decoding kernel and paged attention the paged decode
and verify kernels (``attn_impl="auto"`` picks them for a CUDA device and
their plain versions on the CPU; ``None`` asks for the plain versions on
any device).  There is no jit: every call runs eagerly
on the device its inputs live on.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.models.attention import KERNEL
from repro_torch.models.common import rms_norm
from repro_torch.models.config import DENSE, ModelConfig
from repro_torch.models.dense_lm import (check_dense, layer_decode,
                                         layer_decode_paged, layer_prefill,
                                         layer_verify_paged)

ENGINE_FAMILIES = (DENSE,)


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
    arguments: the engine streams them)."""
    check_engine_family(cfg)
    impl = resolve_attn_impl(attn_impl, device)

    def embed_apply(weights, tokens):
        return weights["embed"][tokens]

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
    # Full-attention GQA takes the paged kernels; a sliding-window config
    # gathers the rows' pages into the contiguous cache, runs the ordinary
    # layer_decode and scatters the one written row back into its page.
    gqa_paged = cfg.sliding_window is None

    def layer_decode_paged_apply(weights, x, pools, tables, pos):
        """One token per request against the paged cache: ``pools`` is
        this layer's {k, v} with (P, page, KV, dh) leaves, written in
        place; ``tables`` (B, NB) int32 on the device; ``pos`` (B,) ragged
        write positions.  The write page must be private."""
        b, nb = tables.shape
        posv = pos.reshape(b)
        if gqa_paged:
            return layer_decode_paged(weights, x, cfg, pools, tables, posv,
                                      attn_impl=impl)
        ps = pools["k"].shape[1]
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
            return (h[:, -1] @ weights["lm_head"]).float()
        return h[:, -1].float()

    def head_all_apply(weights, x):
        """Logits for EVERY stacked position (B, W, V)."""
        h = rms_norm(x, weights["final_norm"], cfg.norm_eps)
        if "lm_head" in weights:
            return (h @ weights["lm_head"]).float()
        return h.float()

    fns = {"embed": embed_apply, "layer": layer_apply,
           "layer_cache": layer_cache_apply,
           "layer_decode": layer_decode_apply,
           "layer_decode_paged": layer_decode_paged_apply,
           "head": head_apply, "head_all": head_all_apply}
    if gqa_paged:
        # the stacked path has no windowed variant; the key's presence is
        # how callers test for it
        fns["layer_verify_paged"] = layer_verify_paged_apply
    return fns
