"""The port's numpy initialisers in bfloat16 against the JAX package's
casting rule: the reference draws fp32 and casts to the config's dtype
(``src/repro/models/common.py``), so a bfloat16 leaf of the port is its
fp32 draw (the same generator, the same draw in float32) rounded as
``jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)`` rounds it, bit for
bit, kept as the 2-byte void bytes the port's shards use.  Carried to the
JAX package, the same bfloat16 parameters give last logits within
``LOGIT_RTOL`` of its largest |logit|."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.data.synthetic import make_batch as jax_batch
from repro.models.api import build_model as jax_build
from repro_torch.checkpoint import quant as qz
from repro_torch.checkpoint.partition import from_jax_params
from repro_torch.configs import get as torch_get
from repro_torch.data.synthetic import make_batch
from repro_torch.models.api import build_model
from repro_torch.models.dense_lm import init_params

# bf16 keeps 8 bits of mantissa (2^-8 relative); the two packages round
# activations to bf16 at different points of each of the reduced model's
# layers, which moves a logit by a few bf16 units (2^-8) of the largest
LOGIT_RTOL = 2e-2


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}['{k}']")
    else:
        yield prefix, tree


def test_narrow_bf16_rounds_as_jax():
    """Ties to even, carries into the exponent, overflow to inf, the
    signed zeros, subnormals and NaN, as jnp's float32 -> bfloat16."""
    rng = np.random.default_rng(0)
    special = np.array([0.0, -0.0, 1.0, 1.00390625, 1.01171875, 3.4e38,
                        -3.4e38, 1e-40, -1e-40, np.inf, -np.inf, np.nan,
                        1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8], np.float32)
    x = np.concatenate([special, rng.standard_normal(4096, np.float32),
                        rng.integers(0, 2 ** 32, 4096, dtype=np.uint64)
                        .astype(np.uint32).view(np.float32)])
    got = qz.narrow_bf16(x)
    want = np.asarray(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16))
    assert got.dtype == qz.BF16
    finite = ~np.isnan(x)
    np.testing.assert_array_equal(got.view(np.uint16)[finite],
                                  want.view(np.uint16)[finite])
    assert np.isnan(want[~finite].astype(np.float32)).all()
    assert np.isnan(qz.widen_bf16(got[~finite])).all()


@pytest.mark.parametrize("arch", ["gpt2_base", "qwen3_moe_30b_a3b",
                                  "minicpm3_4b", "qwen2_vl_2b"])
def test_bf16_init_is_the_fp32_draw_rounded(arch):
    """Every leaf of a reduced bfloat16 config's init: the fp32 config's
    leaf from the same seed, rounded by jnp, bit for bit (the routers stay
    fp32 in both)."""
    cfg = torch_get(arch).reduced().with_(dtype="bfloat16")
    got = dict(_leaves(init_params(np.random.default_rng(0), cfg)))
    f32 = dict(_leaves(init_params(np.random.default_rng(0),
                                   cfg.with_(dtype="float32"))))
    assert sorted(got) == sorted(f32)
    for name, a in got.items():
        want = f32[name]
        if "router" in name:
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, want)
            continue
        assert a.dtype == qz.BF16, name
        jw = np.asarray(jnp.asarray(want, jnp.float32).astype(jnp.bfloat16))
        np.testing.assert_array_equal(a.view(np.uint16),
                                      jw.view(np.uint16), err_msg=name)


def test_bf16_init_logits_match_jax():
    """A reduced bfloat16 gpt2_base initialised by the port, carried to the
    JAX package: ``prefill``'s last logits within ``LOGIT_RTOL`` of the
    reference's largest |logit|, in bfloat16 on both sides."""
    jcfg = get_config("gpt2_base").reduced().with_(dtype="bfloat16")
    tcfg = torch_get("gpt2_base").reduced().with_(dtype="bfloat16")
    params = init_params(np.random.default_rng(3), tcfg)
    tparams = from_jax_params(params, device="cpu")
    assert tparams["embed"].dtype == torch.bfloat16
    jparams = jax.tree.map(
        lambda a: jnp.asarray(a.view(ml_dtypes.bfloat16) if qz.is_bf16(a)
                              else a), params)
    assert jparams["embed"].dtype == jnp.bfloat16
    jlog, _ = jax_build(jcfg).prefill(jparams, jax_batch(jcfg, 2, 16, 1))
    tlog, _ = build_model(tcfg).prefill(tparams, make_batch(tcfg, 2, 16, 1))
    want = np.asarray(jlog, np.float32)
    got = tlog.float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= LOGIT_RTOL, err
