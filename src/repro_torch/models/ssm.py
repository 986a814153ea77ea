"""Recurrent sequence-mixing blocks: Mamba2 (SSD) and xLSTM (mLSTM/sLSTM).

PyTorch port of ``repro/models/ssm.py``.  All three cells expose the same
triple of entry points:

    *_init(rng, cfg, d_model)             -> params (numpy)
    *_prefill(params, x, cfg, state=None) -> (y, final_state)   # full seq
    *_decode(params, x_tok, cfg, state)   -> (y_tok, new_state) # 1 token

The prefill paths are chunkwise-parallel (linear time, O(chunk^2)
intra-chunk work); the decode paths are exact single-step recurrences, and
prefill equals step-by-step decode.  The scans are torch ops, as the
reference's are jnp (no Pallas kernel): Mamba2 and mLSTM walk their chunks
in a Python loop (the reference's ``lax.scan``), each chunk under
``torch.utils.checkpoint`` while autograd records (its ``jax.checkpoint``);
sLSTM steps once per token.

Dtypes follow the reference: ``a_log``, ``d_skip``, ``dt_bias``,
``if_bias``, ``b_zifo`` and every recurrent state are fp32 whatever the
config's dtype; the scans run in fp32 and their outputs return to the
input's dtype before the gate, norm and output projection.

One difference: the intra-chunk decay ``exp(cum_q - cum_p)`` is masked to
the causal triangle BEFORE the exponential (the reference masks the
product after it).  The forward is the same; where a chunk's decay
overflows above the triangle, the reference's gradient is NaN and this
one stays finite.

Simplifications vs. the source papers are the reference's: the mLSTM
input gate is clipped at exp(8) in both paths, and Mamba2 uses one B/C
group shared across heads.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import sharding as sh
from repro_torch.models import common
from repro_torch.models.config import ModelConfig

F32 = torch.float32


def _chunk_len(cfg: ModelConfig, s: int) -> int:
    """``min(ssm_chunk, S)`` halved until it divides S."""
    q = min(cfg.ssm_chunk, s)
    while s % q:
        q //= 2
    return q


def _tril_decay(cum: torch.Tensor) -> torch.Tensor:
    """cum (B, Q, H) -> exp(cum_q - cum_p) (B, Q, P, H) for p <= q, 0
    above the diagonal (masked before the exponential)."""
    q = cum.shape[1]
    mask = torch.ones((q, q), dtype=torch.bool, device=cum.device).tril()
    diff = cum[:, :, None] - cum[:, None, :]
    return torch.exp(diff.masked_fill(~mask[None, :, :, None], -math.inf))


def _scan_chunks(step, carry, xs):
    """Apply ``step(carry, *chunk) -> (carry, y)`` over the chunks of
    ``xs`` (tensors with the chunk index at dim 1) -> (carry, ys stacked
    at dim 1); each step under ``torch.utils.checkpoint`` while autograd
    records."""
    ys = []
    for c in range(xs[0].shape[1]):
        carry, y = common.maybe_checkpoint(torch.is_grad_enabled(), step,
                                           carry, *(t[:, c] for t in xs))
        ys.append(y)
    return carry, torch.stack(ys, 1)


# ===========================================================================
# Mamba2 (State Space Duality, chunked)
# ===========================================================================
def _mamba_dims(cfg: ModelConfig, d_model: int):
    d_inner = cfg.ssm_expand * d_model
    head_p = 64 if d_inner % 64 == 0 else max(d_inner // 4, 1)
    n_heads = d_inner // head_p
    return d_inner, n_heads, head_p


def mamba2_init(rng: np.random.Generator, cfg: ModelConfig,
                d_model: int) -> dict:
    d_inner, nh, hp = _mamba_dims(cfg, d_model)
    n = cfg.ssm_state
    conv_dim = d_inner + 2 * n
    dt = cfg.dtype
    conv_w = rng.standard_normal((cfg.ssm_conv, conv_dim), dtype=np.float32)
    conv_w *= np.float32(0.2)
    return {
        # order: [x(d_inner), B(n), C(n), z(d_inner), dt(nh)]
        "w_in": common.dense_init(rng, d_model, 2 * d_inner + 2 * n + nh,
                                  dt),
        "conv_w": common.cast(conv_w, dt),
        "conv_b": common.zeros((conv_dim,), dt),
        "a_log": np.log(np.linspace(1.0, 16.0, nh, dtype=np.float32)),
        "d_skip": np.ones((nh,), np.float32),
        "dt_bias": np.log(np.expm1(
            np.linspace(1e-3, 1e-1, nh, dtype=np.float32))),
        "out_norm": common.ones((d_inner,), dt),
        "w_out": common.dense_init(rng, d_inner, d_model, dt),
    }


def _mamba_split(params, x, cfg: ModelConfig, d_model: int):
    d_inner, nh, hp = _mamba_dims(cfg, d_model)
    n = cfg.ssm_state
    z = x @ params["w_in"]
    return (z[..., :d_inner], z[..., d_inner:d_inner + 2 * n],
            z[..., d_inner + 2 * n:2 * d_inner + 2 * n],
            z[..., 2 * d_inner + 2 * n:])


def _causal_conv(seq, conv_w, conv_b, tail=None):
    """seq: (B, S, C) depthwise causal conv, kernel K.  ``tail``: (B, K-1,
    C) carried conv inputs from a previous segment (zeros for a fresh
    sequence)."""
    k, s = conv_w.shape[0], seq.shape[1]
    if tail is None:
        pad = F.pad(seq, (0, 0, k - 1, 0))
    else:
        pad = torch.cat([tail.to(seq.dtype), seq], dim=1)
    out = pad[:, 0:s] * conv_w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + s] * conv_w[i]
    return F.silu(out + conv_b)


def _conv_step(state, new, conv_w, conv_b):
    """state: (B, K-1, C); new: (B, C) -> (out (B, C), new state)."""
    window = torch.cat([state, new[:, None]], dim=1)          # (B, K, C)
    out = torch.einsum("bkc,kc->bc", window, conv_w) + conv_b
    return F.silu(out), window[:, 1:]


def mamba2_empty_state(cfg: ModelConfig, d_model: int, batch: int,
                       device="cpu") -> dict:
    d_inner, nh, hp = _mamba_dims(cfg, d_model)
    n = cfg.ssm_state
    conv_dim = d_inner + 2 * n
    return {
        "ssm": torch.zeros((batch, nh, n, hp), dtype=F32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim),
                            dtype=cfg.torch_dtype, device=device),
    }


def _ssd_chunk(a):
    """The SSD chunk step with the heads' decay rates ``a`` (H,)."""
    def step(st, xck, bk, ck, dtk):
        # st (B,H,N,P); xck (B,Q,H,P); bk, ck (B,Q,N); dtk (B,Q,H)
        cum = torch.cumsum(dtk * a, dim=1)                    # (B,Q,H)
        # intra-chunk (masked attention-like)
        cb = torch.einsum("bqn,bpn->bqp", ck, bk)
        m = cb[..., None] * _tril_decay(cum) * dtk[:, None]  # (B,Q,P,H)
        y_intra = torch.einsum("bqph,bphd->bqhd", m, xck)
        # inter-chunk (carry-in state)
        y_inter = torch.einsum("bqn,bqh,bhnd->bqhd", ck, torch.exp(cum), st)
        # state passing
        decay_out = torch.exp(cum[:, -1:, :] - cum)           # (B,Q,H)
        st_new = (torch.exp(cum[:, -1])[..., None, None] * st
                  + torch.einsum("bqh,bqn,bqhd->bhnd", decay_out * dtk, bk,
                                 xck))
        return st_new, y_intra + y_inter
    return step


def mamba2_prefill(params, x, cfg: ModelConfig,
                   state: Optional[dict] = None) -> Tuple[torch.Tensor, dict]:
    b, s, d_model = x.shape
    d_inner, nh, hp = _mamba_dims(cfg, d_model)
    n = cfg.ssm_state
    q = _chunk_len(cfg, s)
    nc = s // q

    xin, bc, gate, dt_raw = _mamba_split(params, x, cfg, d_model)
    conv_in = torch.cat([xin, bc], dim=-1)
    conv_out = _causal_conv(conv_in, params["conv_w"], params["conv_b"],
                            tail=None if state is None else state["conv"])
    xc = conv_out[..., :d_inner].reshape(b, s, nh, hp)
    bmat = conv_out[..., d_inner:d_inner + n]
    cmat = conv_out[..., d_inner + n:]

    a = -torch.exp(params["a_log"])                           # (H,)
    dtv = F.softplus(dt_raw.float() + params["dt_bias"])      # (B,S,H)

    xcf = xc.float().reshape(b, nc, q, nh, hp)
    bf = bmat.float().reshape(b, nc, q, n)
    cf = cmat.float().reshape(b, nc, q, n)
    dtc = dtv.reshape(b, nc, q, nh)
    s0 = (torch.zeros((b, nh, n, hp), dtype=F32, device=x.device)
          if state is None else state["ssm"])
    s_final, ych = _scan_chunks(_ssd_chunk(a), s0, (xcf, bf, cf, dtc))
    y = ych.reshape(b, s, nh, hp)
    y = y + params["d_skip"][None, None, :, None] * xc.float()
    y = y.reshape(b, s, d_inner).to(x.dtype)
    y = y * F.silu(gate)
    y = common.rms_norm(y, params["out_norm"], cfg.norm_eps)
    out = y @ params["w_out"]

    # conv state = last K-1 raw conv inputs (including any carried tail so
    # segment-wise prefill composes exactly)
    k = cfg.ssm_conv
    prev = (state["conv"].to(conv_in.dtype) if state is not None
            else conv_in.new_zeros((b, k - 1, conv_in.shape[-1])))
    tail = torch.cat([prev, conv_in], dim=1)[:, -(k - 1):]
    return out, {"ssm": s_final, "conv": tail.to(cfg.torch_dtype)}


def mamba2_decode(params, x, cfg: ModelConfig,
                  state: dict) -> Tuple[torch.Tensor, dict]:
    """x: (B, 1, D)."""
    b, _, d_model = x.shape
    d_inner, nh, hp = _mamba_dims(cfg, d_model)
    n = cfg.ssm_state

    xin, bc, gate, dt_raw = _mamba_split(params, x[:, 0], cfg, d_model)
    conv_in = torch.cat([xin, bc], dim=-1)                    # (B, C)
    conv_out, conv_state = _conv_step(state["conv"], conv_in,
                                      params["conv_w"], params["conv_b"])
    xc = conv_out[..., :d_inner].reshape(b, nh, hp).float()
    bk = conv_out[..., d_inner:d_inner + n].float()
    ck = conv_out[..., d_inner + n:].float()

    a = -torch.exp(params["a_log"])
    dtv = F.softplus(dt_raw.float() + params["dt_bias"])
    da = torch.exp(dtv * a)                                   # (B,H)
    st = (da[..., None, None] * state["ssm"]
          + torch.einsum("bh,bn,bhd->bhnd", dtv, bk, xc))
    y = torch.einsum("bn,bhnd->bhd", ck, st)
    y = y + params["d_skip"][None, :, None] * xc
    y = y.reshape(b, d_inner).to(x.dtype) * F.silu(gate)
    y = common.rms_norm(y, params["out_norm"], cfg.norm_eps)
    out = (y @ params["w_out"])[:, None]
    return out, {"ssm": st, "conv": conv_state}


# ===========================================================================
# xLSTM: mLSTM (matrix memory, chunkwise-parallel) + sLSTM (scalar, scan)
# ===========================================================================
def _mlstm_dims(cfg: ModelConfig, d_model: int):
    d_inner = 2 * d_model
    nh = 4
    dv = d_inner // nh
    dk = dv // 2
    return d_inner, nh, dk, dv


I_CLIP = 8.0


def mlstm_init(rng: np.random.Generator, cfg: ModelConfig,
               d_model: int) -> dict:
    d_inner, nh, dk, dv = _mlstm_dims(cfg, d_model)
    dt = cfg.dtype
    return {
        "w_up": common.dense_init(rng, d_model, 2 * d_inner, dt),
        "w_q": common.dense_init(rng, d_inner, nh * dk, dt),
        "w_k": common.dense_init(rng, d_inner, nh * dk, dt),
        "w_v": common.dense_init(rng, d_inner, nh * dv, dt),
        "w_if": common.dense_init(rng, d_inner, 2 * nh, dt),
        "if_bias": np.concatenate(
            [np.zeros((nh,), np.float32),
             np.linspace(3.0, 6.0, nh, dtype=np.float32)]),
        "out_norm": common.ones((d_inner,), dt),
        "w_down": common.dense_init(rng, d_inner, d_model, dt),
    }


def mlstm_empty_state(cfg: ModelConfig, d_model: int, batch: int,
                      device="cpu") -> dict:
    _, nh, dk, dv = _mlstm_dims(cfg, d_model)
    return {"c": torch.zeros((batch, nh, dk, dv), dtype=F32, device=device),
            "n": torch.zeros((batch, nh, dk), dtype=F32, device=device)}


def _mlstm_gates(params, xi, nh):
    raw = (xi @ params["w_if"]).float() + params["if_bias"]
    i_raw, f_raw = raw[..., :nh], raw[..., nh:]
    return torch.exp(torch.clamp(i_raw, max=I_CLIP)), F.logsigmoid(f_raw)


# mLSTM's weights the reference's rules split (``param_pspecs``): name ->
# the dim the model axis splits (w_up, w_q, w_k, w_v column-, w_down
# row-wise; w_if, if_bias and out_norm stay whole)
_MLSTM_SPLIT = {"w_q": 1, "w_k": 1, "w_v": 1, "w_down": 0}


def _mlstm_params(params, cfg: ModelConfig, d_model: int, ctx):
    """(params, local) of an mLSTM cell under a sharding ``ctx``: each model
    rank on its heads (``local``) when w_q, w_k, w_v and w_down hold this
    rank's whole heads, else those weights whole (a split one gathered
    over the model axis)."""
    if ctx is None or ctx.model_size == 1:
        return params, False
    d_inner, nh, dk, dv = _mlstm_dims(cfg, d_model)
    full = {"w_q": nh * dk, "w_k": nh * dk, "w_v": nh * dv,
            "w_down": d_inner}
    split = {n: params[n].shape[d] != full[n] for n, d in _MLSTM_SPLIT.items()}
    if all(split.values()) and nh % ctx.model_size == 0:
        return params, True
    whole = dict(params)
    for n, d in _MLSTM_SPLIT.items():
        if split[n]:
            whole[n] = sh.gather_from_model(ctx, params[n], d)
    return whole, False


def _mlstm_in(params, x, cfg: ModelConfig, d_model: int, ctx):
    """(p, local, xi, gate, q, k, v, i_gate, log_f) of an mLSTM cell on x
    (..., D): the up-projection's halves, whole (``w_up``'s column-split
    output gathered over the model axis: over 2 ranks one rank holds all of
    xi, the other all of the gate); q / k / v fp32 (..., h, dk | dv) and
    the gates (..., h) of the heads this rank runs (``_mlstm_params``)."""
    d_inner, nh, dk, dv = _mlstm_dims(cfg, d_model)
    w_up = params["w_up"]
    if ctx is not None and w_up.shape[-1] != 2 * d_inner:
        up = sh.gather_from_model(ctx, sh.copy_to_model(ctx, x) @ w_up, -1)
    else:
        up = x @ w_up
    xi, gate = up[..., :d_inner], up[..., d_inner:]
    p, local = _mlstm_params(params, cfg, d_model, ctx)
    xh = sh.copy_to_model(ctx, xi) if local else xi
    lead = tuple(xi.shape[:-1])
    qm = (xh @ p["w_q"]).reshape(lead + (-1, dk)).float() * (
        1.0 / math.sqrt(dk))
    km = (xh @ p["w_k"]).reshape(lead + (-1, dk)).float()
    vm = (xh @ p["w_v"]).reshape(lead + (-1, dv)).float()
    i_gate, log_f = _mlstm_gates(p, xi, nh)
    if local:
        i_gate = sh.scatter_to_model(ctx, i_gate, -1)
        log_f = sh.scatter_to_model(ctx, log_f, -1)
    return p, local, xi, gate, qm, km, vm, i_gate, log_f


def _mlstm_out(p, y, gate, cfg: ModelConfig, ctx, local: bool):
    """The cell's output from its heads' rows y (..., h * dv): gated, normed
    over the whole d_inner and down-projected.  A rank that runs its heads
    holds part of each row: the norm's sum of squares is summed over the
    model axis (forward and backward: each rank's loss sees only its part
    of the norm's use), and the row-split w_down's partial outputs too."""
    if not local:
        y = y * F.silu(gate)
        return common.rms_norm(y, p["out_norm"], cfg.norm_eps) @ p["w_down"]
    y = y * F.silu(sh.scatter_to_model(ctx, gate, -1))
    yf = y.float()
    ss = sh.copy_to_model(ctx, sh.reduce_from_model(
        ctx, (yf * yf).sum(-1, keepdim=True)))
    y = yf * torch.rsqrt(ss / gate.shape[-1] + cfg.norm_eps)
    y = (y * sh.scatter_to_model(ctx, p["out_norm"], -1).float()).to(
        gate.dtype)
    return sh.reduce_from_model(ctx, y @ p["w_down"])


def _heads(ctx, state: dict, local: bool) -> dict:
    """This rank's heads (dim 1) of an mLSTM state that holds every head."""
    if not local:
        return state
    return {k: sh.scatter_to_model(ctx, v, 1) for k, v in state.items()}


def _all_heads(ctx, state: dict, local: bool) -> dict:
    """``_heads``' inverse: every head, gathered over the model axis (the
    reference keeps recurrent states whole on every model rank)."""
    if not local:
        return state
    return {k: sh.gather_from_model(ctx, v, 1) for k, v in state.items()}


def _mlstm_chunk(c_n, qk, kk, vk, ik, fk):
    c_st, n_st = c_n
    cum = torch.cumsum(fk, dim=1)                             # (B,Q,H)
    # intra-chunk decay: prod of f in (p, q] = exp(cum_q - cum_p)
    scores = torch.einsum("bqhd,bphd->bqph", qk, kk)
    m = scores * _tril_decay(cum) * ik[:, None]
    y_intra = torch.einsum("bqph,bphd->bqhd", m, vk)
    y_inter = torch.einsum("bqhd,bqh,bhdv->bqhv", qk, torch.exp(cum), c_st)
    # normaliser: n_t.q_t = sum_p decay*i*(k_p.q_t) + exp(cum)*n_carry.q;
    # the intra part is exactly the row-sum of m
    nq_intra = m.sum(dim=2)                                   # (B,Q,H)
    nq_inter = torch.einsum("bqhd,bqh,bhd->bqh", qk, torch.exp(cum), n_st)
    denom = torch.clamp(torch.abs(nq_intra + nq_inter), min=1.0)
    y = (y_intra + y_inter) / denom[..., None]
    # state update
    decay_out = torch.exp(cum[:, -1:, :] - cum)               # (B,Q,H)
    c_new = (torch.exp(cum[:, -1])[..., None, None] * c_st
             + torch.einsum("bqh,bqhd,bqhv->bhdv", decay_out * ik, kk, vk))
    n_new = (torch.exp(cum[:, -1])[..., None] * n_st
             + torch.einsum("bqh,bqhd->bhd", decay_out * ik, kk))
    return (c_new, n_new), y


def mlstm_prefill(params, x, cfg: ModelConfig,
                  state: Optional[dict] = None,
                  ctx=None) -> Tuple[torch.Tensor, dict]:
    """Under a sharding ``ctx`` each model rank runs its heads
    (``_mlstm_in`` / ``_mlstm_out``); the state, in and out, holds every
    head."""
    b, s, d_model = x.shape
    q_len = _chunk_len(cfg, s)
    nc = s // q_len
    p, local, xi, gate, qm, km, vm, i_gate, log_f = _mlstm_in(
        params, x, cfg, d_model, ctx)
    nh, dk, dv = qm.shape[2], qm.shape[3], vm.shape[3]
    xs = (qm.reshape(b, nc, q_len, nh, dk), km.reshape(b, nc, q_len, nh, dk),
          vm.reshape(b, nc, q_len, nh, dv), i_gate.reshape(b, nc, q_len, nh),
          log_f.reshape(b, nc, q_len, nh))
    if state is None:
        state = mlstm_empty_state(cfg, d_model, b, x.device)
    st = _heads(ctx, state, local)
    (c_f, n_f), ych = _scan_chunks(_mlstm_chunk, (st["c"], st["n"]), xs)
    y = ych.reshape(b, s, nh * dv).to(x.dtype)
    return (_mlstm_out(p, y, gate, cfg, ctx, local),
            _all_heads(ctx, {"c": c_f, "n": n_f}, local))


def mlstm_decode(params, x, cfg: ModelConfig, state: dict,
                 ctx=None) -> Tuple[torch.Tensor, dict]:
    b, _, d_model = x.shape
    p, local, xi, gate, qv, kv, vv, i_gate, log_f = _mlstm_in(
        params, x[:, 0], cfg, d_model, ctx)
    st = _heads(ctx, state, local)
    f = torch.exp(log_f)
    c_new = (f[..., None, None] * st["c"]
             + i_gate[..., None, None] * kv[..., :, None] * vv[..., None, :])
    n_new = f[..., None] * st["n"] + i_gate[..., None] * kv
    num = torch.einsum("bhd,bhdv->bhv", qv, c_new)
    den = torch.clamp(torch.abs(torch.einsum("bhd,bhd->bh", qv, n_new)),
                      min=1.0)
    y = (num / den[..., None]).reshape(b, -1).to(x.dtype)
    return (_mlstm_out(p, y, gate, cfg, ctx, local)[:, None],
            _all_heads(ctx, {"c": c_new, "n": n_new}, local))


# ---------------------------------------------------------------------------
# sLSTM: scalar-memory recurrent cell with exponential gating + stabiliser
# ---------------------------------------------------------------------------
def slstm_init(rng: np.random.Generator, cfg: ModelConfig,
               d_model: int) -> dict:
    nh = 4
    dh = d_model // nh
    dt = cfg.dtype
    w_zifo = common.dense_init(rng, d_model, 4 * d_model, dt)
    r_zifo = rng.standard_normal((4, nh, dh, dh), dtype=np.float32)
    r_zifo /= np.float32(math.sqrt(dh))
    return {
        # gates z,i,f,o each (D, D) input + per-head recurrent R (H, dh, dh)
        "w_zifo": w_zifo,
        "r_zifo": common.cast(r_zifo, dt),
        "b_zifo": np.zeros((4 * d_model,), np.float32),
        "out_norm": common.ones((d_model,), dt),
        "w_out": common.dense_init(rng, d_model, d_model, dt),
    }


def slstm_empty_state(cfg: ModelConfig, d_model: int, batch: int,
                      device="cpu") -> dict:
    def full(v):
        return torch.full((batch, d_model), v, dtype=F32, device=device)
    return {"c": full(0.0), "n": full(0.0), "m": full(-1e30), "h": full(0.0)}


def _slstm_cell(params, xt, st, nh, dh):
    """One sLSTM step.  xt: (B, 4*D) pre-projected input contribution."""
    b = xt.shape[0]
    hh = st["h"].reshape(b, nh, dh)
    rec = torch.einsum("bhd,ghde->gbhe", hh.to(params["r_zifo"].dtype),
                       params["r_zifo"]).reshape(4, b, nh * dh)
    zifo = (xt.reshape(b, 4, -1).transpose(0, 1).float() + rec.float()
            + params["b_zifo"].reshape(4, 1, -1))
    z = torch.tanh(zifo[0])
    log_i = zifo[1]
    log_f = F.logsigmoid(zifo[2])
    o = torch.sigmoid(zifo[3])
    m_new = torch.maximum(log_f + st["m"], log_i)
    i_s = torch.exp(log_i - m_new)
    f_s = torch.exp(log_f + st["m"] - m_new)
    c_new = f_s * st["c"] + i_s * z
    n_new = f_s * st["n"] + i_s
    h_new = o * c_new / torch.clamp(n_new, min=1e-6)
    return {"c": c_new, "n": n_new, "m": m_new, "h": h_new}


def slstm_prefill(params, x, cfg: ModelConfig,
                  state: Optional[dict] = None) -> Tuple[torch.Tensor, dict]:
    b, s, d_model = x.shape
    nh, dh = 4, d_model // 4
    st = state if state is not None else slstm_empty_state(cfg, d_model, b,
                                                           x.device)
    xz = x @ params["w_zifo"]                                 # (B,S,4D)
    hs = []
    for t in range(s):
        st = _slstm_cell(params, xz[:, t], st, nh, dh)
        hs.append(st["h"])
    y = torch.stack(hs, 1).to(x.dtype)                        # (B,S,D)
    y = common.rms_norm(y, params["out_norm"], cfg.norm_eps)
    return y @ params["w_out"], st


def slstm_decode(params, x, cfg: ModelConfig,
                 state: dict) -> Tuple[torch.Tensor, dict]:
    b, _, d_model = x.shape
    nh, dh = 4, d_model // 4
    xz = x[:, 0] @ params["w_zifo"]
    st = _slstm_cell(params, xz, state, nh, dh)
    y = st["h"][:, None].to(x.dtype)
    y = common.rms_norm(y, params["out_norm"], cfg.norm_eps)
    return y @ params["w_out"], st
