"""The port's checkpoint reader/writer against the JAX package's format."""
import json

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import partition as jax_partition
from repro.configs import get_config
from repro.models.dense_lm import init_params as jax_init
from repro_torch.checkpoint import partition as tp
from repro_torch.configs import get as torch_get
from repro_torch.models.dense_lm import init_params as torch_init


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    cfg = get_config("gpt2_base").reduced()
    params = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(3), cfg))
    path = tmp_path_factory.mktemp("jax_ckpt")
    manifest = jax_partition.partition_and_save(params, cfg, path)
    return cfg, params, path, manifest


def test_jax_shards_load_to_equal_arrays(jax_ckpt):
    _, _, path, manifest = jax_ckpt
    assert tp.load_manifest(path) == manifest
    for name in tp.shard_names(manifest):
        want = jax.tree.map(np.asarray, jax_partition.load_shard(path, name))
        got = tp.load_shard(path, name)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_port_writer_matches_manifest_bytes(jax_ckpt, tmp_path):
    cfg, params, _, manifest = jax_ckpt
    tcfg = torch_get("gpt2_base").reduced()
    got = tp.partition_and_save(tp.from_jax_params(params, device="cpu"),
                                tcfg, tmp_path)
    assert got == manifest
    assert json.loads((tmp_path / "manifest.json").read_text()) == manifest
    # and the JAX reader reads the port's shards back to the same arrays
    for name in tp.shard_names(manifest):
        a = jax_partition.load_shard(tmp_path, name)
        b = tp.load_shard(tmp_path, name)
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_array_equal(np.asarray(x), y)


def test_from_jax_params_round_trips(jax_ckpt):
    _, params, _, _ = jax_ckpt
    ported = tp.from_jax_params(params, device="cpu")
    assert all(isinstance(t, torch.Tensor) for t in jax.tree.leaves(ported))
    back = tp.to_numpy(ported)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine "
                    "without a CUDA device")
def test_from_jax_params_defaults_to_cuda(jax_ckpt):
    _, params, _, _ = jax_ckpt
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.from_jax_params(params)


def test_numpy_init_is_seeded_and_has_reference_shapes():
    tcfg = torch_get("yi_9b").reduced()
    a = torch_init(np.random.default_rng(0), tcfg)
    b = torch_init(np.random.default_rng(0), tcfg)
    ref = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0),
                                            get_config("yi_9b").reduced()))
    assert jax.tree.structure(a) == jax.tree.structure(ref)
    for x, y, r in zip(jax.tree.leaves(a), jax.tree.leaves(b),
                       jax.tree.leaves(ref)):
        np.testing.assert_array_equal(x, y)
        assert x.shape == r.shape and x.dtype == r.dtype


def test_quantized_manifest_not_ported(tmp_path):
    """Quantized dense checkpoints are ported (tests/test_torch_quant.py);
    a quantized EXPERT-SPLIT (MoE) manifest is not, and still raises."""
    (tmp_path / "manifest.json").write_text(json.dumps(
        {"model": "qwen3_moe_30b_a3b", "num_layers": 1, "dtype": "float32",
         "quant": "int8", "expert_split": True, "shards": [],
         "total_bytes": 0, "layer_bytes": 0}))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tp.load_manifest(tmp_path)
