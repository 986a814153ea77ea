"""The PyTorch port's config registry against the JAX package's."""
import dataclasses

import jax.numpy as jnp
import pytest

import repro.configs as jax_configs
import repro_torch.configs as torch_configs


def test_registry_names_match():
    assert torch_configs.names() == jax_configs.names()
    assert torch_configs.list_archs() == jax_configs.list_archs()
    assert torch_configs.list_paper_models() == jax_configs.list_paper_models()


@pytest.mark.parametrize("name", jax_configs.names())
def test_every_field_equal(name):
    ref = jax_configs.get(name)
    got = torch_configs.get(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert dataclasses.asdict(got.reduced()) == dataclasses.asdict(
        ref.reduced())
    assert got.torch_dtype.itemsize == jnp.dtype(ref.dtype).itemsize
    assert got.cache_bytes(3, 17) == ref.cache_bytes(3, 17)
    assert got.padded_vocab == ref.padded_vocab
    assert got.q_heads_per_kv == ref.q_heads_per_kv
    long_ref = jax_configs.long_variant(ref)
    long_got = torch_configs.long_variant(got)
    if long_ref is None:
        assert long_got is None
    else:
        assert dataclasses.asdict(long_got) == dataclasses.asdict(long_ref)


def test_unknown_arch_error():
    with pytest.raises(ValueError, match="unknown architecture"):
        torch_configs.get("gpt-5")
