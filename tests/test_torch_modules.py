"""Per-layer module outputs of the port against the JAX package's, on the
same weights (JAX init carried across with ``from_jax_params``), in fp32
within 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.modules import build_module_fns as jax_fns
from repro.models.dense_lm import init_params as jax_init
from repro_torch.checkpoint import from_jax_params
from repro_torch.configs import get as torch_get
from repro_torch.core.modules import build_module_fns as torch_fns

TOL = dict(atol=1e-5, rtol=1e-5)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


@pytest.fixture(scope="module", params=["gpt2_base", "yi_9b", "minicpm3_4b",
                                        "qwen2_vl_2b"])
def model(request):
    jcfg = get_config(request.param).reduced()
    tcfg = torch_get(request.param).reduced()
    params = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(5), jcfg))
    tparams = from_jax_params(params, device="cpu")
    layer = lambda tree, i: jax.tree.map(lambda a: a[i], tree)  # noqa: E731
    j = {"embed": {"embed": params["embed"]},
         "layers": [layer(params["layers"], i)
                    for i in range(jcfg.num_layers)],
         "head": {"final_norm": params["final_norm"],
                  "lm_head": params["lm_head"]}}
    t = {"embed": {"embed": tparams["embed"]},
         "layers": [layer(tparams["layers"], i)
                    for i in range(tcfg.num_layers)],
         "head": {"final_norm": tparams["final_norm"],
                  "lm_head": tparams["lm_head"]}}
    return (jcfg, jax_fns(jcfg, attn_impl=None), j,
            tcfg, torch_fns(tcfg, device="cpu"), t)


def test_embed_layer_head(model):
    jcfg, jf, j, tcfg, tf, t = model
    assert jcfg.q_heads_per_kv == tcfg.q_heads_per_kv
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 13))
    jx = jf["embed"](j["embed"], jnp.asarray(toks))
    tx = tf["embed"](t["embed"], torch.as_tensor(toks))
    _close(tx, jx)
    for jw, tw in zip(j["layers"], t["layers"]):
        jx = jf["layer"](jw, jx)
        tx = tf["layer"](tw, tx)
        _close(tx, jx)
    _close(tf["head"](t["head"], tx), jf["head"](j["head"], jx))


def test_layer_cache_then_ragged_decode(model):
    """Cache-capturing prefill padded to total_len, then decode steps with
    a scalar pos and with a RAGGED (B,) pos vector.  Every cache leaf:
    GQA's {k, v}, MLA's latent {c, kr}."""
    jcfg, jf, j, tcfg, tf, t = model
    rng = np.random.default_rng(1)
    b, s, total = 3, 11, 16
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    jw, tw = j["layers"][0], t["layers"][0]
    jy, jc = jf["layer_cache"](jw, jnp.asarray(x), total)
    ty, tc = tf["layer_cache"](tw, torch.from_numpy(x), total)
    _close(ty, jy)
    assert set(tc) == set(jc)
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape
        _close(tc[key], jc[key])
    # scalar position: every row writes slot s
    x1 = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
    jy1, jc = jf["layer_decode"](jw, jnp.asarray(x1), jc, jnp.int32(s))
    ty1, tc = tf["layer_decode"](tw, torch.from_numpy(x1), tc, s)
    _close(ty1, jy1)
    # ragged positions: each row at its own slot, device tensor
    pos = np.asarray([s + 1, 4, 14])
    x2 = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
    jy2, jc = jf["layer_decode"](jw, jnp.asarray(x2), jc,
                                 jnp.asarray(pos, jnp.int32))
    ty2, tc = tf["layer_decode"](tw, torch.from_numpy(x2), tc,
                                 torch.as_tensor(pos))
    _close(ty2, jy2)
    for key in jc:
        _close(tc[key], jc[key])


def test_kernel_and_plain_paths_agree_on_cpu(model):
    """attn_impl="cuda" on CPU tensors dispatches to the same plain
    versions as attn_impl=None."""
    jcfg, _, _, tcfg, tf, t = model
    plain = torch_fns(tcfg, attn_impl=None, device="cpu")
    kern = torch_fns(tcfg, attn_impl="cuda", device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 9, tcfg.d_model)).astype(np.float32))
    torch.testing.assert_close(kern["layer"](t["layers"][1], x),
                               plain["layer"](t["layers"][1], x))


def test_resolve_attn_impl():
    from repro_torch.core.modules import resolve_attn_impl
    assert resolve_attn_impl("auto", "cpu") is None
    assert resolve_attn_impl("auto", "cuda") == "cuda"
    assert resolve_attn_impl(None, "cuda") is None
    with pytest.raises(ValueError):
        resolve_attn_impl("pallas", "cpu")


def test_unported_families_raise():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        torch_fns(torch_get("seamless_m4t_medium").reduced(), device="cpu")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        torch_fns(torch_get("xlstm_1_3b").reduced(), device="cpu")
