"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package's
``repro.models.moe`` on the same numpy-seeded inputs: capacity rounding,
the dispatch slots, and ``moe_apply``'s output and aux loss, with and
without dropped pairs; plus the reference's own MoE semantics tests run on
the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.hypothesis_compat import given, settings, st

from repro.models import moe as jmoe
from repro.models.config import MOE as JMOE
from repro.models.config import ModelConfig as JCfg
from repro_torch.configs import get as torch_get
from repro_torch.models import moe
from repro_torch.models.config import MOE, ModelConfig

# the reference's tests/test_moe.py CFG, and its tests/test_moe_stream.py
# CFG (routers x8 as its fixture scales them)
FIELDS = dict(name="moe", num_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
              d_ff=0, vocab_size=100, n_experts=4, top_k=2, expert_d_ff=32,
              dtype="float32", remat=False)
STREAM_FIELDS = dict(name="moe-stream-test", num_layers=3, d_model=64,
                     n_heads=4, n_kv_heads=2, d_ff=0, vocab_size=256,
                     head_dim=16, n_experts=8, top_k=2, expert_d_ff=32,
                     dtype="float32", vocab_pad_to=64, remat=False)
CFG = ModelConfig(family=MOE, **FIELDS)
JAX_CFG = JCfg(family=JMOE, **FIELDS)
ROUTER_SCALE = 8.0


def _setup(cfg, t=32, seed=0, scale=ROUTER_SCALE):
    """Port-initialised numpy params (routers scaled) and inputs."""
    rng = np.random.default_rng(seed)
    params = moe.moe_init(rng, cfg)
    params["router"] = params["router"] * np.float32(scale)
    x = rng.standard_normal((2, t // 2, cfg.d_model), dtype=np.float32)
    return params, x


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _assert_decisive(params, x, k):
    """Identical routing is shown, not assumed: every token's top-k logit
    margin exceeds 100x the measured difference between the two packages'
    router logits."""
    xf = x.reshape(-1, x.shape[-1])
    want = np.asarray(jnp.asarray(xf) @ jnp.asarray(params["router"]))
    got = moe.router_logits(torch.from_numpy(params["router"]),
                            torch.from_numpy(xf)).numpy()
    err = float(np.abs(got - want).max())
    top = -np.sort(-want, axis=-1)
    margin = float((top[:, k - 1] - top[:, k]).min())
    assert margin > 100 * err, (margin, err)


@pytest.mark.parametrize("n_tokens", [1, 7, 32, 64, 1000])
@pytest.mark.parametrize("factor", [0.25, 1.25, 64.0])
def test_capacity_rounding_matches_jax(n_tokens, factor):
    cfg, jcfg = (CFG.with_(capacity_factor=factor),
                 JAX_CFG.with_(capacity_factor=factor))
    assert moe.capacity(cfg, n_tokens) == jmoe.capacity(jcfg, n_tokens)
    assert moe.capacity(cfg, n_tokens) % 8 == 0
    assert moe.capacity(CFG, 64) >= 64 * CFG.top_k / CFG.n_experts


@settings(max_examples=15, deadline=None)
@given(t=st.integers(2, 16), e=st.sampled_from([2, 4, 8]),
       k=st.integers(1, 2), seed=st.integers(0, 2**30))
def test_dispatch_indices_match_jax(t, e, k, seed):
    """Slots equal the JAX function's, are unique, in range, and respect
    capacity (including pairs dropped past it)."""
    k = min(k, e)
    cap = 8 if seed % 2 else 2
    ids = np.random.default_rng(seed).integers(0, e, (t, k))
    want = np.asarray(jmoe._dispatch_indices(jnp.asarray(ids, jnp.int32), k,
                                             e, cap, 0, e))
    got = moe._dispatch_indices(torch.from_numpy(ids), k, e, cap, 0,
                                e).numpy()
    np.testing.assert_array_equal(got, want)
    kept = got[got < e * cap]
    assert len(np.unique(kept)) == len(kept)
    assert all(np.bincount(kept // cap) <= cap)


@pytest.mark.parametrize("factor", [64.0, 0.25], ids=["no-drop", "drop"])
def test_moe_apply_matches_jax(factor):
    cfg, jcfg = (CFG.with_(capacity_factor=factor),
                 JAX_CFG.with_(capacity_factor=factor))
    params, x = _setup(cfg)
    _assert_decisive(params, x, cfg.top_k)
    jout, jaux = jax.jit(lambda p, xx: jmoe.moe_apply(p, xx, jcfg, None))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    out, aux = moe.moe_apply(_torch(params), torch.from_numpy(x), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    if factor < 1:   # the tight capacity really dropped pairs
        t = x.shape[0] * x.shape[1]
        assert moe.capacity(cfg, t) * cfg.n_experts < t * cfg.top_k


def test_stream_cfg_moe_apply_matches_jax():
    """The reference's expert-streaming CFG (8 experts, top-2, GQA)."""
    cfg = ModelConfig(family=MOE, **STREAM_FIELDS)
    jcfg = JCfg(family=JMOE, **STREAM_FIELDS)
    params, x = _setup(cfg, t=24, seed=3)
    _assert_decisive(params, x, cfg.top_k)
    jout, jaux = jmoe.moe_apply(jax.tree.map(jnp.asarray, params),
                                jnp.asarray(x), jcfg, None)
    out, aux = moe.moe_apply(_torch(params), torch.from_numpy(x), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_no_drop_at_high_capacity_matches_dense_mixture():
    """With capacity >= T*K every pair is kept: the output is the dense
    per-token mixture of its top-k experts."""
    cfg = CFG.with_(capacity_factor=64.0)
    params, x = _setup(cfg, scale=1.0)
    p = _torch(params)
    out, _ = moe.moe_apply(p, torch.from_numpy(x), cfg)
    t = torch.from_numpy(x).reshape(-1, cfg.d_model)
    _, top_w, top_ids = moe.top_k_routing(t @ p["router"], cfg.top_k)
    gate = torch.nn.functional.silu(torch.einsum("td,edf->tef", t,
                                                 p["w_gate"]))
    up = torch.einsum("td,edf->tef", t, p["w_up"])
    all_out = torch.einsum("tef,efd->ted", gate * up, p["w_down"])
    want = sum(all_out[torch.arange(len(t)), top_ids[:, kk]]
               * top_w[:, kk, None] for kk in range(cfg.top_k))
    np.testing.assert_allclose(out.reshape(-1, cfg.d_model).numpy(),
                               want.numpy(), atol=1e-4, rtol=1e-4)


def test_dropping_reduces_output_norm():
    params, x = _setup(CFG, scale=1.0)
    p, xt = _torch(params), torch.from_numpy(x)
    full, _ = moe.moe_apply(p, xt, CFG.with_(capacity_factor=64.0))
    tight, _ = moe.moe_apply(p, xt, CFG.with_(capacity_factor=0.25))
    assert float(tight.norm()) < float(full.norm())


def test_deterministic_and_aux_loss_bounds():
    params, x = _setup(CFG.with_(capacity_factor=8.0), scale=1.0)
    cfg = CFG.with_(capacity_factor=8.0)
    a, aux = moe.moe_apply(_torch(params), torch.from_numpy(x), cfg)
    b, _ = moe.moe_apply(_torch(params), torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    # Switch load-balance loss is >= 1 at uniform routing, less z-loss
    assert float(aux) >= 0.9


def test_init_is_seeded_with_reference_shapes():
    cfg = torch_get("qwen3_moe_30b_a3b").reduced()
    a = moe.moe_init(np.random.default_rng(0), cfg)
    b = moe.moe_init(np.random.default_rng(0), cfg)
    ref = jmoe.moe_init(jax.random.PRNGKey(0), JAX_CFG.with_(
        d_model=cfg.d_model, n_experts=cfg.n_experts,
        expert_d_ff=cfg.expert_d_ff))
    assert list(a) == list(ref)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name])
        assert a[name].shape == ref[name].shape
        assert a[name].dtype == np.dtype(ref[name].dtype)


def test_sharded_ctx_not_ported():
    """A mesh whose model axis does not divide the experts is refused,
    naming both numbers, as the reference's assert refuses it (the
    expert-parallel path itself is ``test_torch_sharding.py``'s)."""
    from types import SimpleNamespace

    from repro_torch.sharding import ShardingCtx
    params, x = _setup(CFG)
    mesh = SimpleNamespace(mesh=torch.zeros(1, 3), mesh_dim_names=(
        "data", "model"), get_coordinate=lambda: [0, 0])
    with pytest.raises(ValueError, match=rf"model axis \(3 ranks\) does not "
                       rf"divide n_experts \({CFG.n_experts}\)"):
        moe.moe_apply(_torch(params), torch.from_numpy(x), CFG,
                      ctx=ShardingCtx(mesh=mesh))
