"""fp16 models through the port against the JAX package, on checkpoints
the JAX package wrote: a reduced GPT-J (fp16, head_dim 256, the geometry
the port's attention kernels gained) and a reduced ViT-Large (fp16,
non-causal).  Greedy tokens identical, logits within 2e-3 of their
largest magnitude (the packages round to fp16 at different points of
each layer, which moves a logit by a few fp16 units), ledger peaks equal
to the byte.  On the CPU the port runs the kernels' plain
versions; the kernels themselves are held against those at fp16 / bf16
and head_dim 256 by the ``cuda`` cases of ``test_torch_kernels.py``."""
import jax
import numpy as np
import pytest

from repro.checkpoint import load_manifest, partition_and_save
from repro.configs import get_config
from repro.core import PipeloadEngine as JaxEngine
from repro.models.dense_lm import init_params as jax_init
from repro_torch.configs import get as torch_get
from repro_torch.core import PipeloadEngine

LOGIT_RTOL = 2e-3           # of the largest |logit|
GPTJ = dict(dtype="float16", head_dim=256, d_model=128, d_ff=256,
            vocab_size=256, vocab_pad_to=8, num_layers=2, remat=False)
VIT = dict(dtype="float16", d_model=128, d_ff=256, vocab_size=64,
           vocab_pad_to=8, num_layers=3, remat=False)


def _ckpt(tmp_path_factory, arch, geom):
    jcfg = get_config(arch).reduced().with_(**geom)
    tcfg = torch_get(arch).reduced().with_(**geom)
    path = tmp_path_factory.mktemp(arch) / arch
    partition_and_save(jax_init(jax.random.PRNGKey(0), jcfg), jcfg, path)
    return jcfg, tcfg, path


@pytest.fixture(scope="module")
def gptj(tmp_path_factory):
    return _ckpt(tmp_path_factory, "gpt_j", GPTJ)


@pytest.fixture(scope="module")
def vit(tmp_path_factory):
    return _ckpt(tmp_path_factory, "vit_large", VIT)


def _close_logits(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=LOGIT_RTOL * np.abs(want).max())


def _one_layer_budget(path, cfg, cache_total=0):
    man = load_manifest(path)
    layer = man["layer_bytes"] // cfg.num_layers
    return man["total_bytes"] - man["layer_bytes"] + cache_total + layer


def test_reduced_gptj_fp16_dh256_matches_jax(gptj):
    jcfg, tcfg, path = gptj
    assert (tcfg.dtype, tcfg.head_dim, tcfg.causal) == ("float16", 256, True)
    toks = np.random.default_rng(1).integers(0, 256, (2, 12))
    new = 4
    budget = _one_layer_budget(path, jcfg, jcfg.num_layers
                               * jcfg.cache_bytes(2, 12 + new))
    kw = dict(mode="pipeload", num_agents=2, budget_bytes=budget)
    with JaxEngine(path, jcfg, **kw) as je:
        jout, jst = je.run_generate(toks, new, kv_cache=True)
        jl, jsst = je.run_single(toks)
    with PipeloadEngine(path, tcfg, device="cpu", **kw) as te:
        tout, tst = te.run_generate(toks, new, kv_cache=True)
        tl, tsst = te.run_single(toks)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert tst.peak_bytes == jst.peak_bytes == budget
    assert tst.streamed_bytes == jst.streamed_bytes
    _close_logits(tl, jl)
    assert tsst.peak_bytes == jsst.peak_bytes


def test_reduced_vit_fp16_noncausal_matches_jax(vit):
    jcfg, tcfg, path = vit
    assert (tcfg.dtype, tcfg.causal) == ("float16", False)
    toks = np.random.default_rng(2).integers(0, 64, (2, 17))
    budget = _one_layer_budget(path, jcfg)
    kw = dict(mode="pipeload", num_agents=2, budget_bytes=budget)
    with JaxEngine(path, jcfg, **kw) as je:
        jl, jst = je.run_single(toks)
    with PipeloadEngine(path, tcfg, device="cpu", **kw) as te:
        tl, tst = te.run_single(toks)
    assert tuple(tl.shape) == tuple(jl.shape)
    _close_logits(tl, jl)
    np.testing.assert_array_equal(tl.float().numpy().argmax(-1),
                                  np.asarray(jl, np.float32).argmax(-1))
    assert tst.peak_bytes == jst.peak_bytes == budget
    assert tst.loads == jst.loads
