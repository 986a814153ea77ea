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
from repro_torch.core.engine import SpecConfig

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
    """Paged KV and speculative decoding are ported: the single-request
    speculative path rejects a batch of 2, and a stacked W=2 verify round
    without paged pools raises, with the reference's ValueErrors."""
    _, tcfg, path = ckpt
    with PipeloadEngine(path, tcfg, page_size=4, device="cpu") as te:
        assert te.page_size == 4
        with pytest.raises(ValueError, match="single-request path"):
            te.run_generate(toks, 3, speculative=SpecConfig(path, tcfg))
        with pytest.raises(ValueError, match="needs paged pools"):
            te.run_batch_round(None, [], 0.0,
                               decode_x=torch.zeros((1, 2, 128)))


@pytest.mark.parametrize("config, nbytes", [
    (":4096:8", 32 * 2**20),
    (":4096:2:16:8", (4096 * 2 + 16 * 8) * 1024),
])
def test_blas_workspace_bytes(monkeypatch, config, nbytes):
    """The cuBLAS workspace PyTorch keeps beside the ledger: nothing on the
    CPU; on the card PyTorch's own size, or its CUBLAS_WORKSPACE_CONFIG
    rule where it does not report one."""
    assert torch_engine.blas_workspace_bytes(torch.device("cpu")) == 0
    monkeypatch.delattr(torch._C, "_cuda_getCublasWorkspaceSize",
                        raising=False)
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", config)
    assert torch_engine.blas_workspace_bytes(torch.device("cuda")) == nbytes


def test_facade_plans_within_the_ledger_budget(ckpt, monkeypatch):
    """Hermes gives the planner and the engine the device budget less the
    BLAS workspace: equal on the CPU, 32 MiB less where cuBLAS keeps 32
    MiB."""
    from repro_torch.core import Hermes
    from repro_torch.core import hermes as hermes_mod
    _, tcfg, path = ckpt
    hermes = Hermes(path, tcfg, device="cpu")
    budget = 8 * 2**20
    assert hermes.ledger_budget(budget) == budget
    assert hermes.ledger_budget(None) is None
    assert hermes.plan_generate([budget])[0].budget_bytes == budget
    monkeypatch.setattr(hermes_mod, "blas_workspace_bytes",
                        lambda device: 2**20)
    assert hermes.ledger_budget(budget) == budget - 2**20
    assert hermes.plan_generate([budget])[0].budget_bytes == budget - 2**20
    with hermes.engine(budget_bytes=budget, num_agents=1) as eng:
        assert eng.budget == budget - 2**20


def test_packed_shard_is_one_buffer_of_aligned_views():
    """The device loader's packing (``engine._packed``), run to the CPU:
    every leaf of a shard (fp32, bf16, int8, and an int4 QuantizedTensor's
    payload and scales) comes back equal, each a view of one buffer at a
    256-byte aligned offset."""
    from repro_torch.checkpoint.quant import quantize_array
    rng = np.random.default_rng(0)
    qt = quantize_array(rng.normal(size=(7, 5)).astype(np.float32), "int4")
    host = {"attn": {"w_q": torch.from_numpy(rng.normal(size=(3, 5))
                                             .astype(np.float32)),
                     "w_o": qt},
            "norm": torch.arange(5, dtype=torch.float32).bfloat16(),
            "ids": torch.arange(3, dtype=torch.int8)}
    dev, buf = torch_engine._packed(host, torch.device("cpu"))
    pairs = [(dev["attn"]["w_q"], host["attn"]["w_q"]),
             (dev["attn"]["w_o"].q, qt.q), (dev["attn"]["w_o"].scale,
                                            qt.scale),
             (dev["norm"], host["norm"]), (dev["ids"], host["ids"])]
    base = buf.untyped_storage().data_ptr()
    for got, want in pairs:
        assert got.dtype == want.dtype and torch.equal(got, want)
        assert got.untyped_storage().data_ptr() == base
        assert (got.data_ptr() - base) % torch_engine._LEAF_ALIGN == 0
    w_o = dev["attn"]["w_o"]
    assert (w_o.bits, w_o.shape, w_o.dtype) == (4, (7, 5), "float32")
    assert buf.numel() == 5 * torch_engine._LEAF_ALIGN
