"""Mixture-of-Experts FFN with capacity-based dispatch, PyTorch port.

Port of ``repro/models/moe.py``'s single-device path.  Dispatch is
sort-based (GShard-style capacity, token dropping) rather than
one-hot-einsum based: the (T, E, C) dispatch tensor is never built.  Each
(token, expert) pair gets a slot in a per-expert capacity buffer; pairs
beyond an expert's capacity are dropped and contribute nothing.

The router runs in fp32 whatever the checkpoint dtype, ``torch.topk``
gives the descending order ``lax.top_k`` gives, and the combine adds the
k contributions in the reference's scan order, so the sums round alike.
The expert products are library calls (``torch.bmm``), as the reference's
are ``jnp.einsum`` outside any Pallas kernel.

Not yet ported: the expert-parallel ``shard_map`` path (a sharding ctx),
which waits for the port's device mesh.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import common
from repro_torch.models.config import ModelConfig


def moe_init(rng: np.random.Generator, cfg: ModelConfig) -> dict:
    """Router (fp32) and stacked expert weights, drawn one expert at a
    time so no fp32 copy of a whole (E, D, F) stack is built."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.expert_d_ff

    def experts(rows: int, cols: int) -> np.ndarray:
        scale = np.float32(1.0 / math.sqrt(rows))
        out = np.empty((e, rows, cols), common.np_dtype(cfg.dtype))
        for i in range(e):
            w = rng.standard_normal((rows, cols), dtype=np.float32)
            w *= scale
            out[i] = common.cast(w, cfg.dtype)
        return out

    return {"router": common.dense_init(rng, d, e, np.float32),
            "w_gate": experts(d, f), "w_up": experts(d, f),
            "w_down": experts(f, d)}


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts
                      * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)  # the reference's multiple of 8


def _dispatch_indices(expert_ids: torch.Tensor, top_k: int, n_experts: int,
                      cap: int, e0: int, e_local: int) -> torch.Tensor:
    """Pair -> local buffer slot (or ``e_local * cap`` = dropped).

    expert_ids: (T, K) integer.  Returns slots (T, K) int64 into a local
    (e_local * cap) buffer; pairs routed to non-local experts or beyond
    an expert's capacity map to e_local * cap."""
    t = expert_ids.shape[0]
    flat_e = expert_ids.reshape(-1).long()
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    # position of each pair within its expert group (deterministic)
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_sorted = torch.arange(t * top_k, device=flat_e.device) - first
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    pos = pos.reshape(t, top_k)
    local_e = expert_ids.long() - e0
    ok = (local_e >= 0) & (local_e < e_local) & (pos < cap)
    return torch.where(ok, local_e * cap + pos,
                       torch.full_like(pos, e_local * cap))


def _expert_ffn(buf: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """buf: (E, C, D) -> (E, C, D) via per-expert SwiGLU."""
    gate = F.silu(torch.bmm(buf, w_gate))
    up = torch.bmm(buf, w_up)
    return torch.bmm(gate * up, w_down)


def router_logits(router: torch.Tensor, x_flat: torch.Tensor
                  ) -> torch.Tensor:
    """(T, D) -> fp32 router logits (T, E)."""
    return x_flat.float() @ router


def top_k_routing(logits: torch.Tensor, k: int):
    """fp32 logits -> (probs, normalised top-k weights, expert ids), the
    weights in descending order as ``lax.top_k`` gives them."""
    probs = torch.softmax(logits, dim=-1)
    top_w, top_ids = torch.topk(probs, k, dim=-1, sorted=True)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_w, top_ids


def combine(buf: torch.Tensor, slots: torch.Tensor,
            top_w: torch.Tensor) -> torch.Tensor:
    """Sum each token's k expert outputs: ``buf`` (N, D) holds the expert
    outputs by slot, ``slots`` (T, K) index it (N or past = dropped, which
    contributes 0).  The k terms are added in order from zero, as the
    reference's scan adds them."""
    padded = torch.cat([buf, buf.new_zeros((1, buf.shape[1]))])
    idx = slots.clamp(max=buf.shape[0])
    acc = buf.new_zeros((slots.shape[0], buf.shape[1]))
    for kk in range(slots.shape[1]):
        acc = acc + padded[idx[:, kk]] * top_w[:, kk, None].to(buf.dtype)
    return acc


def _moe_local(params, x_flat: torch.Tensor, cfg: ModelConfig, cap: int,
               e0: int, e_local: int) -> Tuple[torch.Tensor, tuple]:
    """Dispatch + expert compute for experts [e0, e0 + e_local).

    x_flat: (T, D).  Returns (out (T, D) holding only these experts'
    contributions, the load-balance statistics over all experts)."""
    t, d = x_flat.shape
    k, e = cfg.top_k, cfg.n_experts
    logits = router_logits(params["router"], x_flat)           # (T, E)
    probs, top_w, top_ids = top_k_routing(logits, k)           # (T, K)
    # Switch-style load-balance statistics
    frac = torch.zeros((e,), dtype=torch.float32, device=x_flat.device)
    frac.index_add_(0, top_ids.reshape(-1),
                    torch.ones((t * k,), device=x_flat.device))
    frac = frac / (t * k)
    p_mean = probs.mean(0)
    zloss = (torch.logsumexp(logits, -1) ** 2).mean() * 1e-3
    stats = (frac, p_mean, zloss)

    slots = _dispatch_indices(top_ids, k, e, cap, e0, e_local)  # (T, K)
    n = e_local * cap
    # scatter pairs into the capacity buffer; dropped pairs land in a sink
    # row past the end
    buf = x_flat.new_zeros((n + 1, d))
    tok = torch.arange(t, device=x_flat.device).repeat_interleave(k)
    buf[slots.reshape(-1)] = x_flat[tok]
    out = _expert_ffn(buf[:n].reshape(e_local, cap, d), params["w_gate"],
                      params["w_up"], params["w_down"]).reshape(n, d)
    return combine(out, slots, top_w), stats


def _aux_from_stats(cfg: ModelConfig, stats) -> torch.Tensor:
    frac, p_mean, zloss = stats
    return cfg.n_experts * torch.sum(frac * p_mean) + zloss


def moe_apply(params, x: torch.Tensor, cfg: ModelConfig, ctx=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux scalar)."""
    if ctx is not None:
        raise NotImplementedError("expert-parallel moe_apply (a sharding "
                                  "ctx) is not yet ported in repro_torch")
    b, s, d = x.shape
    cap = capacity(cfg, b * s)
    out, stats = _moe_local(params, x.reshape(-1, d), cfg, cap, 0,
                            cfg.n_experts)
    return out.reshape(b, s, d), _aux_from_stats(cfg, stats)
