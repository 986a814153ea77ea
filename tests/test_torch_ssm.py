"""The port's recurrent cells (``repro_torch/models/ssm.py``: Mamba2,
mLSTM, sLSTM) against the JAX package's on the same seeded inputs, and
the invariants ``tests/test_ssm.py`` holds the reference to, on the port.

Against the JAX package (fp32, parameters carried across with
``from_jax_params``): each cell's prefill output and final state, from a
fresh and from a carried state, its decode step, and the gradients of a
weighted sum of its prefill outputs and final state with respect to every
parameter and the input, each within 1e-5 of that leaf's largest
magnitude; the init's leaf names, shapes and dtypes at fp32 and bf16 (the
fp32 leaves stay fp32).  On the port alone, with ``tests/test_ssm.py``'s
tolerances (atol 2e-4, rtol 1e-3: prefill and stepwise decode sum in
different orders): prefill equals stepwise decode, chunk sizes 4, 8 and
24 give the same output, and a state carried between two prefills gives
the whole sequence's.  Where a chunk's decay overflows above the causal
triangle the reference's gradient is NaN; the port's forward is the same
and its gradient finite."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_recurrent import leaf_close, like, requires_grad, same_layout
from repro.models import ssm as jssm
from repro.models.config import MAMBA_HYBRID
from repro.models.config import ModelConfig as JaxConfig
from repro_torch.checkpoint.partition import from_jax_params
from repro_torch.models import ssm
from repro_torch.models.config import ModelConfig

ARGS = ("t", MAMBA_HYBRID, 2, 64, 4, 4, 128, 100)
KW = dict(ssm_state=16, ssm_chunk=8, dtype="float32", remat=False)
JCFG, CFG = JaxConfig(*ARGS, **KW), ModelConfig(*ARGS, **KW)
B, S, D = 2, 24, 64
CELLS = ("mamba2", "mlstm", "slstm")
INVARIANT = dict(atol=2e-4, rtol=1e-3)      # tests/test_ssm.py's


def _fns(mod, cell):
    return (getattr(mod, f"{cell}_prefill"), getattr(mod, f"{cell}_decode"),
            getattr(mod, f"{cell}_empty_state"))


def _jax_fns(cell, cfg=JCFG):
    """The reference's prefill and decode, jitted at ``cfg``."""
    pre, dec, _ = _fns(jssm, cell)
    return (jax.jit(lambda p, x, st=None: pre(p, x, cfg, st)),
            jax.jit(lambda p, x, st: dec(p, x, cfg, st)))


@pytest.fixture(scope="module", params=CELLS)
def cell(request):
    """(name, the JAX init as numpy, the same on the port, input x)."""
    name = request.param
    init = getattr(jssm, f"{name}_init")
    params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), JCFG, D))
    x = (np.random.default_rng(1).standard_normal((B, S, D)) * 0.5).astype(
        np.float32)
    return name, params, from_jax_params(params, device="cpu"), x


def _states_close(got: dict, want: dict, what: str) -> None:
    assert sorted(got) == sorted(want), what
    for k in want:
        assert got[k].dtype == torch.float32 or k == "conv", (what, k)
        leaf_close(got[k], np.asarray(want[k]), f"{what} state {k}")


def test_prefill_matches_jax(cell):
    """From a fresh state, then from the state the first 16 tokens leave."""
    name, params, tparams, x = cell
    jpre, _ = _jax_fns(name)
    tpre, _, _ = _fns(ssm, name)
    with torch.no_grad():
        y, st = tpre(tparams, torch.from_numpy(x), CFG)
        y1, st1 = tpre(tparams, torch.from_numpy(x[:, :16]), CFG)
        y2, st2 = tpre(tparams, torch.from_numpy(x[:, 16:]), CFG, st1)
    jy, jst = jpre(params, jnp.asarray(x))
    _, jst1 = jpre(params, jnp.asarray(x[:, :16]))
    jy2, jst2 = jpre(params, jnp.asarray(x[:, 16:]), jst1)
    leaf_close(y, jy, f"{name} prefill y")
    _states_close(st, jst, f"{name} prefill")
    leaf_close(y2, jy2, f"{name} carried prefill y")
    _states_close(st2, jst2, f"{name} carried prefill")


def test_decode_matches_jax(cell):
    """Two decode steps from the JAX prefill's state, carried across."""
    name, params, tparams, x = cell
    jpre, jdec = _jax_fns(name)
    _, tdec, _ = _fns(ssm, name)
    _, jst = jpre(params, jnp.asarray(x[:, :20]))
    st = from_jax_params(jax.tree.map(np.asarray, jst), device="cpu")
    for t in (20, 21):
        jy, jst = jdec(params, jnp.asarray(x[:, t:t + 1]), jst)
        with torch.no_grad():
            y, st = tdec(tparams, torch.from_numpy(x[:, t:t + 1]), CFG, st)
        leaf_close(y, jy, f"{name} decode y at {t}")
        _states_close(st, jst, f"{name} decode at {t}")


def test_grads_match_jax(cell):
    """d/d(params, x) of sum(w_y * y) + sum(w_s * state) over the prefill
    (the chunk scan under ``torch.utils.checkpoint``)."""
    name, params, _, x = cell
    jpre, _, _ = _fns(jssm, name)
    tpre, _, _ = _fns(ssm, name)
    rng = np.random.default_rng(2)
    w_y = rng.standard_normal((B, S, D)).astype(np.float32)
    w_s = {k: rng.standard_normal(v.shape).astype(np.float32)
           for k, v in jax.eval_shape(lambda: jpre(
               params, jnp.asarray(x), JCFG)[1]).items()}

    def jloss(p, xx):
        y, st = jpre(p, xx, JCFG)
        return jnp.sum(y * w_y) + sum(jnp.sum(st[k] * w_s[k]) for k in w_s)
    jl, (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        params, jnp.asarray(x))
    tparams = from_jax_params(params, device="cpu")
    leaves = requires_grad(tparams)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, st = tpre(tparams, tx, CFG)
    tl = (y * torch.from_numpy(w_y)).sum() + sum(
        (st[k] * torch.from_numpy(w_s[k])).sum() for k in w_s)
    grads = torch.autograd.grad(tl, leaves + [tx])
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    gp = like(tparams, grads[:-1])
    for k in jgp:
        leaf_close(gp[k], np.asarray(jgp[k]), f"{name} d {k}")
    leaf_close(grads[-1], np.asarray(jgx), f"{name} d x")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", CELLS)
def test_init_layout_matches_jax(name, dtype):
    """The numpy init's leaves: the reference's names, shapes and dtypes
    (``a_log``, ``d_skip``, ``dt_bias``, ``if_bias``, ``b_zifo`` fp32 at
    any dtype)."""
    want = jax.eval_shape(lambda k: getattr(jssm, f"{name}_init")(
        k, JCFG.with_(dtype=dtype), D), jax.random.PRNGKey(0))
    got = from_jax_params(getattr(ssm, f"{name}_init")(
        np.random.default_rng(0), CFG.with_(dtype=dtype), D), device="cpu")
    same_layout(got, want, f"{name} init {dtype}")
    states = (jax.eval_shape(lambda: getattr(jssm, f"{name}_empty_state")(
        JCFG.with_(dtype=dtype), D, B)),
        getattr(ssm, f"{name}_empty_state")(CFG.with_(dtype=dtype), D, B))
    same_layout(states[1], states[0], f"{name} state {dtype}")


def test_prefill_equals_stepwise_decode(cell):
    name, _, tparams, x = cell
    tpre, tdec, empty = _fns(ssm, name)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        y_ref, st_ref = tpre(tparams, xt, CFG)
        st, ys = empty(CFG, D, B), []
        for t in range(S):
            y, st = tdec(tparams, xt[:, t:t + 1], CFG, st)
            ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_ref.numpy(),
                               **INVARIANT)
    for k in st_ref:
        np.testing.assert_allclose(st[k].numpy(), st_ref[k].numpy(),
                                   **INVARIANT)


@pytest.mark.parametrize("name", ["mamba2", "mlstm"])
def test_chunk_size_invariance(name):
    """The chunkwise-parallel scan is exact for any chunk size."""
    init = getattr(ssm, f"{name}_init")
    tparams = from_jax_params(init(np.random.default_rng(3), CFG, D),
                              device="cpu")
    x = torch.from_numpy((np.random.default_rng(4).standard_normal(
        (B, S, D)) * 0.5).astype(np.float32))
    tpre, _, _ = _fns(ssm, name)
    with torch.no_grad():
        outs = [tpre(tparams, x, CFG.with_(ssm_chunk=c))[0].numpy()
                for c in (4, 8, 24)]
    np.testing.assert_allclose(outs[0], outs[1], **INVARIANT)
    np.testing.assert_allclose(outs[0], outs[2], **INVARIANT)


def test_prefill_state_carry(cell):
    """prefill(x1) then prefill(x2, state) == prefill(concat(x1, x2))."""
    name, _, tparams, x = cell
    tpre, _, _ = _fns(ssm, name)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        y_full, _ = tpre(tparams, xt, CFG)
        y1, st = tpre(tparams, xt[:, :16], CFG)
        y2, _ = tpre(tparams, xt[:, 16:], CFG, st)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), **INVARIANT)


def test_overflowing_decay_keeps_grads_finite():
    """dt_bias + 4 makes a 32-token chunk's decay overflow above the
    causal triangle: the reference's gradient is NaN there (it masks the
    product after the exponential), the port's finite, with the same
    forward."""
    cfg, jcfg = CFG.with_(ssm_chunk=32), JCFG.with_(ssm_chunk=32)
    params = jax.tree.map(np.asarray,
                          jssm.mamba2_init(jax.random.PRNGKey(0), jcfg, D))
    params["dt_bias"] = params["dt_bias"] + np.float32(4.0)
    x = np.random.default_rng(5).standard_normal((B, 32, D)).astype(
        np.float32)
    jy, _ = _jax_fns("mamba2", jcfg)[0](params, jnp.asarray(x))
    jg = jax.jit(jax.grad(lambda p: jssm.mamba2_prefill(
        p, jnp.asarray(x), jcfg)[0].sum()))(params)
    assert any(bool(jnp.isnan(g).any()) for g in jax.tree.leaves(jg))
    tparams = from_jax_params(params, device="cpu")
    leaves = requires_grad(tparams)
    y, _ = ssm.mamba2_prefill(tparams, torch.from_numpy(x), cfg)
    leaf_close(y, jy, "forward")
    grads = torch.autograd.grad(y.sum(), leaves)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
