"""The port's PIPELOAD engine against the JAX package's, on one checkpoint
the JAX package wrote: identical greedy tokens, ledger peaks equal to the
byte, and an audited ledger that drains."""
import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import load_manifest, partition_and_save
from repro.configs import get_config
from repro.core import PipeloadEngine as JaxEngine
from repro.models.dense_lm import init_params as jax_init
from repro_torch.configs import get as torch_get
from repro_torch.core import PipeloadEngine, engine as torch_engine

GEOM = dict(num_layers=4, d_model=128, n_heads=4, n_kv_heads=4,
            head_dim=32, d_ff=512, vocab_size=1000, vocab_pad_to=8)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """Small GPT-2-geometry checkpoint written by the JAX package."""
    jcfg = get_config("gpt2_base").with_(remat=False, **GEOM)
    tcfg = torch_get("gpt2_base").with_(remat=False, **GEOM)
    path = tmp_path_factory.mktemp("ckpt") / "gpt2s"
    partition_and_save(jax_init(jax.random.PRNGKey(0), jcfg), jcfg, path)
    return jcfg, tcfg, path


def _floor(path, cfg, cache_total, pin):
    man = load_manifest(path)
    layer = man["layer_bytes"] // cfg.num_layers
    other = man["total_bytes"] - man["layer_bytes"]
    return other + cache_total + pin * layer + layer


@pytest.fixture
def toks():
    return np.random.default_rng(3).integers(0, 1000, (2, 10))


@pytest.mark.parametrize("kv_cache", [False, True])
@pytest.mark.parametrize("pin", [0, 1])
def test_generate_matches_jax_engine(ckpt, toks, kv_cache, pin):
    jcfg, tcfg, path = ckpt
    new = 5
    cache = jcfg.num_layers * jcfg.cache_bytes(2, 10 + new) if kv_cache else 0
    budget = _floor(path, jcfg, cache, pin)
    kw = dict(mode="pipeload", num_agents=2, budget_bytes=budget,
              pin_window=pin)
    with JaxEngine(path, jcfg, **kw) as je:
        jout, jst = je.run_generate(toks, new, kv_cache=kv_cache)
    with PipeloadEngine(path, tcfg, device="cpu", **kw) as te:
        tout, tst = te.run_generate(toks, new, kv_cache=kv_cache)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert tst.peak_bytes == jst.peak_bytes == budget
    assert sum(tst.peak_breakdown.values()) == tst.peak_bytes
    assert tst.loads == jst.loads
    assert tst.streamed_bytes == jst.streamed_bytes
    assert tst.cache_bytes == jst.cache_bytes
    if pin == 0:
        # one streaming layer at a time: the attribution is deterministic
        assert tst.peak_breakdown == jst.peak_breakdown


@pytest.mark.parametrize("mode", ["baseline", "pipeswitch"])
def test_other_modes_match_jax_engine(ckpt, toks, mode):
    jcfg, tcfg, path = ckpt
    with JaxEngine(path, jcfg, mode=mode) as je:
        jout, jst = je.run_generate(toks, 3, kv_cache=True)
    with PipeloadEngine(path, tcfg, mode=mode, device="cpu") as te:
        tout, tst = te.run_generate(toks, 3, kv_cache=True)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert tst.peak_bytes == jst.peak_bytes
    assert tst.peak_breakdown == jst.peak_breakdown


def test_run_single_logits_match(ckpt, toks):
    jcfg, tcfg, path = ckpt
    with JaxEngine(path, jcfg, num_agents=3) as je:
        jl, _ = je.run_single(toks)
    with PipeloadEngine(path, tcfg, num_agents=3, device="cpu") as te:
        tl, _ = te.run_single(toks)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=1e-5)


def test_audited_ledger_drains_and_catches_double_release(ckpt, toks,
                                                          monkeypatch):
    _, tcfg, path = ckpt
    monkeypatch.setenv("REPRO_LEDGER_AUDIT", "1")
    with PipeloadEngine(path, tcfg, num_agents=2, device="cpu") as te:
        _, st = te.run_generate(toks, 3, kv_cache=True)  # drains or raises
    assert st.kv_cache and st.new_tokens == 3
    ledger = torch_engine._Ledger(None)
    ledger.acquire(10, owner="stream", detail="x")
    ledger.release(10, owner="stream", detail="x")
    ledger.audit_check_drained("stream")
    with pytest.raises(torch_engine.LedgerAuditError, match="negative"):
        ledger.release(1, owner="stream")


def test_budget_below_floor_raises(ckpt, toks):
    _, tcfg, path = ckpt
    with PipeloadEngine(path, tcfg, budget_bytes=1000, device="cpu") as te:
        with pytest.raises(ValueError, match="KV decode floor"):
            te.run_generate(toks, 3, kv_cache=True)


def test_cuda_requested_without_card_raises(ckpt):
    _, tcfg, path = ckpt
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        PipeloadEngine(path, tcfg)


def test_unported_options_raise(ckpt, toks):
    _, tcfg, path = ckpt
    with pytest.raises(NotImplementedError, match="not yet ported"):
        PipeloadEngine(path, tcfg, page_size=4, device="cpu")
    with PipeloadEngine(path, tcfg, device="cpu") as te:
        with pytest.raises(NotImplementedError, match="not yet ported"):
            te.run_generate(toks, 3, speculative=object())
