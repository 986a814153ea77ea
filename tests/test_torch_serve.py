"""The port's continuous-batching scheduler and serve launcher against the
JAX package's, plus the port's import isolation from JAX."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.checkpoint import load_manifest, partition_and_save
from repro.configs import get_config
from repro.core import BatchScheduler as JaxScheduler
from repro.core import PipeloadEngine as JaxEngine
from repro.launch.serve import poisson_arrivals as jax_arrivals
from repro.models.dense_lm import init_params as jax_init
from repro_torch.configs import get as torch_get
from repro_torch.core import BatchScheduler, Hermes, PipeloadEngine
from repro_torch.launch import serve

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
GEOM = dict(num_layers=4, d_model=128, n_heads=4, n_kv_heads=4,
            head_dim=32, d_ff=512, vocab_size=1000, vocab_pad_to=8)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    jcfg = get_config("gpt2_base").with_(remat=False, **GEOM)
    tcfg = torch_get("gpt2_base").with_(remat=False, **GEOM)
    path = tmp_path_factory.mktemp("ckpt") / "gpt2s"
    partition_and_save(jax_init(jax.random.PRNGKey(1), jcfg), jcfg, path)
    return jcfg, tcfg, path


def _serve(sched, prompts, news, arrivals):
    rids = [sched.submit(p, n, arrival_round=a)
            for p, n, a in zip(prompts, news, arrivals)]
    outs, stats = sched.run()
    sched.close()
    return [np.asarray(outs[r]) for r in rids], stats


@pytest.mark.parametrize("seed,pin", [(0, 0), (1, 1)])
def test_scheduler_matches_jax(ckpt, seed, pin):
    """Same prompts, Poisson arrivals and schedule: identical per-request
    tokens, rounds and ledger peak.  The budget admits two requests at a
    time with one streaming layer, so the peak is deterministic."""
    jcfg, tcfg, path = ckpt
    rng = np.random.default_rng(seed)
    n, total = 5, 24
    prompts = [rng.integers(0, 1000, (int(s),))
               for s in rng.integers(6, 14, n)]
    news = [int(x) for x in rng.integers(2, 8, n)]
    arrivals = jax_arrivals(n, 1.5, rng)
    man = load_manifest(path)
    layer = man["layer_bytes"] // jcfg.num_layers
    per_req = jcfg.num_layers * jcfg.cache_bytes(1, total)
    budget = (man["total_bytes"] - man["layer_bytes"] + 2 * per_req
              + (pin + 1) * layer)
    kw = dict(mode="pipeload", num_agents=2, budget_bytes=budget,
              pin_window=pin)
    sk = dict(max_inflight=3, max_total_len=total, seed=seed)
    jouts, jst = _serve(JaxScheduler(JaxEngine(path, jcfg, **kw), **sk),
                        prompts, news, arrivals)
    touts, tst = _serve(BatchScheduler(PipeloadEngine(path, tcfg,
                                                      device="cpu", **kw),
                                       **sk),
                        prompts, news, arrivals)
    for t, j in zip(touts, jouts):
        np.testing.assert_array_equal(t, j)
    assert tst.rounds == jst.rounds
    assert tst.peak_bytes == jst.peak_bytes
    assert tst.max_inflight_seen == jst.max_inflight_seen == 2
    assert tst.new_tokens == jst.new_tokens == sum(news)
    assert tst.cache_bytes_peak == jst.cache_bytes_peak
    assert [p[:3] for p in tst.policy] == [p[:3] for p in jst.policy]
    assert sum(tst.peak_breakdown.values()) == tst.peak_bytes
    # CPU tensors take the plain versions, which launch nothing
    assert tst.kernel_launches == {"flash_decode": 0, "flash_attention": 0,
                                   "paged_flash_decode": 0,
                                   "paged_flash_verify": 0,
                                   "quantized_matmul": 0}
    if pin == 0:
        assert tst.peak_breakdown == jst.peak_breakdown


def test_hermes_scheduler_facade(ckpt, tmp_path):
    """profile -> plan_generate -> engine -> scheduler on the CPU; the
    profile is cached under the port's own name."""
    _, tcfg, path = ckpt
    local = tmp_path / "ckpt"
    shutil.copytree(path, local)
    hermes = Hermes(local, tcfg, device="cpu")
    sched = hermes.scheduler(max_inflight=2, prompt_len=8, new_tokens=3)
    rng = np.random.default_rng(5)
    outs, stats = _serve(sched, [rng.integers(0, 1000, (8,))
                                 for _ in range(3)], [3, 3, 3], [0, 0, 1])
    assert [len(o) for o in outs] == [11, 11, 11]
    assert stats.max_inflight_seen <= 2
    assert (local / "profile_torch_cpu.json").exists()
    assert not (local / "profile.json").exists()


def test_scheduler_rejects_unported_modes(ckpt):
    """Paged KV and chunked prefill are ported; speculation and the SLO
    tier still raise, and submit takes no SLO keywords (priorities,
    tenants)."""
    _, tcfg, path = ckpt
    eng = PipeloadEngine(path, tcfg, device="cpu")
    for kw in (dict(draft=object()), dict(spec_depth=2),
               dict(slo=object())):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            BatchScheduler(eng, **kw)
    sched = BatchScheduler(eng, page_size=4, chunk_prefill=8)
    assert (sched.page_size, sched.chunk) == (4, 8)
    for kw in (dict(priority=1), dict(tenant="t1")):
        with pytest.raises(TypeError, match="unexpected keyword"):
            sched.submit(np.arange(6), 2, **kw)
    with pytest.raises(ValueError, match="needs paged KV"):
        BatchScheduler(eng, chunk_prefill=8)
    eng.close()


def test_serve_cli_runs_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(serve, "CKPT_ROOT", tmp_path)
    serve.main(["--device", "cpu", "--requests", "3", "--prompt-len", "6",
                "--new-tokens", "3", "--max-inflight", "2",
                "--arrival-rate", "1.0", "--seed", "4"])
    out = capsys.readouterr().out
    assert re.search(r"served 3 reqs x 3 tokens in \d+ rounds", out)
    assert "device cpu" in out
    assert (tmp_path / "gpt2-base-smoke" / "profile_torch_cpu.json").exists()


@pytest.mark.parametrize("flags", [["--autotune"],
                                   ["--spec-depth", "2"],
                                   ["--draft-arch", "gpt2_base"],
                                   ["--tenants", "2"]])
def test_serve_cli_unported_flags_exit(flags, capsys):
    with pytest.raises(SystemExit, match="not yet ported in repro_torch"):
        serve.main(["--device", "cpu"] + flags)


def test_import_leaves_out_jax_and_repro():
    code = ("import sys, repro_torch.launch.serve, repro_torch.core, "
            "repro_torch.kernels.build, repro_torch.checkpoint.quant, "
            "repro_torch.kernels.quant_matmul\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, check=True, timeout=120)
    assert res.stdout.strip() == "[]"


def test_port_sources_never_import_jax_or_repro():
    pat = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)"
                     r"(\.|\s+import)|import\s+jax\.)", re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in pat.finditer(f.read_text())]
    assert hits == []
