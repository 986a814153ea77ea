"""The port's expert-streaming PIPELOAD against the JAX package's, on
checkpoints the JAX package wrote from one seeded parameter tree: the
expert-split shards byte for byte, the in-memory oracle, greedy tokens,
the ExpertCache, ledger peaks, breakdowns and expert hit / miss / eviction
counts to the byte and the count, the scheduler, the profiler and planner,
``Hermes.execute`` and the serve CLI.  Each routing-sensitive test first
shows that routing is decisive: every token's top-k router margin exceeds
100x the measured difference between the two packages' router logits."""
import dataclasses
import functools
import gc
import json
import shutil
import weakref
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_manifest, partition_and_save
from repro.configs import get_config
from repro.core import BatchScheduler as JaxScheduler
from repro.core import Hermes as JaxHermes
from repro.core import PipeloadEngine as JaxEngine
from repro.core import plan_generate as jax_plan_generate
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models.api import build_model
from repro.models.config import MOE as JMOE
from repro.models.config import ModelConfig as JCfg
from repro.models.dense_lm import layer_prefill as jax_layer_prefill
from repro_torch.checkpoint import partition as tp
from repro_torch.configs import get as torch_get
from repro_torch.core import (BatchScheduler, ExpertCache, Hermes,
                              PipeloadEngine, plan_generate, profile_model)
from repro_torch.core.engine import SpecConfig
from repro_torch.core.telemetry import telemetry
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import dense_lm, moe
from repro_torch.models.config import MOE, ModelConfig

# the reference's tests/test_moe_stream.py CFG
FIELDS = dict(name="moe-stream-test", num_layers=3, d_model=64, n_heads=4,
              n_kv_heads=2, d_ff=0, vocab_size=256, head_dim=16, n_experts=8,
              top_k=2, expert_d_ff=32, dtype="float32", vocab_pad_to=64,
              remat=False)
MODELS = {
    "stream_cfg": (JCfg(family=JMOE, **FIELDS),
                   ModelConfig(family=MOE, **FIELDS)),
    "reduced": (get_config("qwen3_moe_30b_a3b").reduced(),
                torch_get("qwen3_moe_30b_a3b").reduced()),
}
PROMPT, NEW = 12, 5
TOTAL = PROMPT + NEW
ROUTER_SCALE = 8.0


def _write(jcfg, root):
    """Seeded params (routers x8, as the reference's fixture scales them)
    as numpy, and the JAX package's split and whole-layer checkpoints."""
    p = build_model(jcfg).init(jax.random.PRNGKey(0))
    p["layers"]["moe"]["router"] = p["layers"]["moe"]["router"] * ROUTER_SCALE
    params = jax.tree.map(np.asarray, p)
    paths = {"split": root / "split", "whole": root / "whole"}
    partition_and_save(params, jcfg, paths["split"])
    partition_and_save(params, jcfg, paths["whole"], expert_split=False)
    return params, paths


@pytest.fixture(scope="module", params=list(MODELS))
def model(request, tmp_path_factory):
    jcfg, tcfg = MODELS[request.param]
    params, paths = _write(jcfg, tmp_path_factory.mktemp(request.param))
    return jcfg, tcfg, params, paths


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    jcfg, tcfg = MODELS["stream_cfg"]
    params, paths = _write(jcfg, tmp_path_factory.mktemp("stream"))
    return jcfg, tcfg, params, paths


@pytest.fixture(scope="module")
def toks():
    return np.random.default_rng(0).integers(0, FIELDS["vocab_size"],
                                             (2, PROMPT))


def _budget(path, cfg, extra_experts=6, batch=1):
    man = load_manifest(path)
    other = sum(s["bytes"] for s in man["shards"]
                if s["kind"] in ("embed", "head"))
    lb = max(s["bytes"] for s in man["shards"] if s["kind"] == "layer")
    eb = max(s["bytes"] for s in man["shards"] if s["kind"] == "expert")
    kv = cfg.num_layers * cfg.cache_bytes(batch, TOTAL)
    return other + kv + 2 * lb + extra_experts * eb


@functools.partial(jax.jit, static_argnums=(2,))
def _jax_router_logits(params, tok, jcfg):
    """Every layer's router logits (L, B*S, E) along the JAX package's own
    layer functions."""
    b, s = tok.shape
    pos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
    x, out = params["embed"][tok], []
    for i in range(jcfg.num_layers):
        p = jax.tree.map(lambda a: a[i], params["layers"])
        a, _ = jattn.gqa_prefill(p["attn"], jcommon.rms_norm(
            x, p["attn_norm"], jcfg.norm_eps), jcfg, None, pos,
            make_cache=False)
        hf = jcommon.rms_norm(x + a, p["ffn_norm"], jcfg.norm_eps)
        out.append(hf.reshape(-1, jcfg.d_model) @ p["moe"]["router"])
        x, _, _ = jax_layer_prefill(p, x, jcfg, None, pos, make_cache=False)
    return jnp.stack(out)


def _torch_router_logits(params, tokens, tcfg):
    """The same along the port's layer functions."""
    b, s = tokens.shape
    pos = torch.arange(s)[None].expand(b, s)
    tparams = tp.from_jax_params(params, device="cpu")
    y, out = tparams["embed"][torch.from_numpy(tokens)], []
    for i in range(tcfg.num_layers):
        p = tp.tree_map(lambda a: a[i], tparams["layers"])
        a, _ = tattn.gqa_prefill(p["attn"], tcommon.rms_norm(
            y, p["attn_norm"], tcfg.norm_eps), tcfg, pos, make_cache=False)
        hf = tcommon.rms_norm(y + a, p["ffn_norm"], tcfg.norm_eps)
        out.append(moe.router_logits(p["moe"]["router"],
                                     hf.reshape(-1, tcfg.d_model)).numpy())
        y, _ = dense_lm.layer_prefill(p, y, tcfg, pos, make_cache=False)
    return np.stack(out)


def assert_decisive(params, jcfg, tcfg, seqs):
    """The precondition of every routing-sensitive comparison, over every
    position of each token sequence in ``seqs`` (right-padded into one
    batch: causal attention keeps the padding out of the real rows)."""
    seqs = [np.asarray(q).reshape(-1) for q in seqs]
    n = max(len(q) for q in seqs)
    tokens = np.zeros((len(seqs), n), np.int64)
    valid = np.zeros((len(seqs), n), bool)
    for i, q in enumerate(seqs):
        tokens[i, :len(q)], valid[i, :len(q)] = q, True
    want = np.asarray(_jax_router_logits(params, jnp.asarray(tokens,
                                                             jnp.int32),
                                         jcfg))[:, valid.reshape(-1)]
    got = _torch_router_logits(params, tokens, tcfg)[:, valid.reshape(-1)]
    err = float(np.abs(got - want).max())
    top = -np.sort(-want, axis=-1)
    k = jcfg.top_k
    margin = float((top[..., k - 1] - top[..., k]).min())
    assert margin > 100 * err, (margin, err)


EXPERT_FIELDS = ("expert_hits", "expert_misses", "expert_evictions",
                 "expert_cache_bytes", "unique_experts_per_round")


def assert_same_run(st, jst, breakdown=True):
    for f in EXPERT_FIELDS + ("peak_bytes", "loads", "streamed_bytes"):
        assert getattr(st, f) == getattr(jst, f), f
    if breakdown:
        assert st.peak_breakdown == jst.peak_breakdown
    assert sum(st.peak_breakdown.values()) == st.peak_bytes


# ---------------------------------------------------------------------------
# Checkpoint layout
# ---------------------------------------------------------------------------
def test_manifest_and_shards_equal_jax(model, tmp_path):
    """The port's writer, from the same numpy tree, writes the JAX
    package's manifest and shards: the same zip members in the same order
    with the same bytes (only the zip's write timestamps differ)."""
    jcfg, tcfg, params, paths = model
    man = tp.partition_and_save(params, tcfg, tmp_path)
    assert man == load_manifest(paths["split"]) == tp.load_manifest(
        paths["split"])
    for s in man["shards"]:
        with zipfile.ZipFile(tmp_path / f"{s['name']}.npz") as a, \
                zipfile.ZipFile(paths["split"] / f"{s['name']}.npz") as b:
            assert a.namelist() == b.namelist()
            for name in a.namelist():
                assert a.read(name) == b.read(name)
    experts = [s for s in man["shards"] if s["kind"] == "expert"]
    assert man["expert_split"] is True
    assert len(experts) == tcfg.num_layers * tcfg.n_experts
    assert man["experts_per_layer"] == tcfg.n_experts
    assert all(s["name"] == f"layer_{s['index']:03d}_expert_"
               f"{s['expert']:03d}" for s in experts)
    whole = tp.partition_and_save(params, tcfg, tmp_path / "whole",
                                  expert_split=False)
    assert whole == load_manifest(paths["whole"])
    assert (man["layer_bytes"] + man["expert_total_bytes"]
            == whole["layer_bytes"])


def test_expert_split_needs_moe(tmp_path):
    with pytest.raises(ValueError, match="MoE"):
        tp.partition_and_save({}, torch_get("gpt2_base").reduced(),
                              tmp_path / "x", expert_split=True)


# ---------------------------------------------------------------------------
# Oracle and engine parity
# ---------------------------------------------------------------------------
def test_single_pass_matches_oracle_and_jax(model, toks):
    jcfg, tcfg, params, paths = model
    toks = toks % jcfg.vocab_size
    assert_decisive(params, jcfg, tcfg, toks)
    oracle, _ = jax.jit(build_model(jcfg).prefill)(
        params, {"tokens": jnp.asarray(toks, jnp.int32)})
    with JaxEngine(paths["split"], jcfg, num_agents=2) as je:
        jl, jst = je.run_single(toks)
    with PipeloadEngine(paths["split"], tcfg, num_agents=2,
                        device="cpu") as te:
        tl, st = te.run_single(toks)
    with PipeloadEngine(paths["whole"], tcfg, num_agents=2,
                        device="cpu") as tw:
        wl, _ = tw.run_single(toks)
    np.testing.assert_allclose(tl.numpy(), np.asarray(oracle), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(wl.numpy(), np.asarray(oracle), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=1e-5)
    assert st.expert_misses > 0
    assert_same_run(st, jst)


def test_generation_matches_whole_layer_and_jax(model, toks):
    jcfg, tcfg, params, paths = model
    toks = toks % jcfg.vocab_size
    with JaxEngine(paths["split"], jcfg, num_agents=2) as je:
        jout, jst = je.run_generate(toks, NEW, kv_cache=True)
    with PipeloadEngine(paths["split"], tcfg, num_agents=2,
                        device="cpu") as te:
        out, st = te.run_generate(toks, NEW, kv_cache=True)
    with PipeloadEngine(paths["whole"], tcfg, num_agents=2,
                        device="cpu") as tw:
        wout, wst = tw.run_generate(toks, NEW, kv_cache=True)
    assert_decisive(params, jcfg, tcfg, out.numpy()[:, :-1])
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(out.numpy(), wout.numpy())
    assert st.expert_hit_rate > 0
    assert st.streamed_bytes < wst.streamed_bytes
    assert_same_run(st, jst)


def test_expert_cache_lru_order_and_counters():
    c = ExpertCache()
    for e in range(3):
        assert c.get(("L0", e)) is None                # 3 misses
        c.put(("L0", e), {"w": e}, 10)
    assert len(c) == 3 and c.resident == 30
    assert c.get(("L0", 0))["w"] == 0                  # 0 becomes MRU
    key, freed = c.evict_lru()                         # LRU is now 1
    assert key == ("L0", 1) and freed == 10
    assert c.resident == 20 and c.evictions == 1
    key, _ = c.evict_lru(exclude=frozenset({("L0", 2)}))
    assert key == ("L0", 0)
    assert c.evict_lru(exclude=frozenset({("L0", 2)})) is None
    assert c.hits == 1 and c.misses == 3
    c.put(("L0", 2), {"w": 9}, 10)                     # replaced, not added
    assert c.resident == 10 and c.peek(("L0", 2))["w"] == 9


def test_budgeted_run_matches_jax_and_evicts(stream, toks):
    """Budget pressure: the cache evicts, the ledger stays within the
    budget, and peak, breakdown, hits, misses and evictions equal the
    reference's to the byte and the count."""
    jcfg, tcfg, params, paths = stream
    budget = _budget(paths["split"], jcfg, extra_experts=9, batch=2)
    kw = dict(mode="pipeload", num_agents=2, budget_bytes=budget)
    with JaxEngine(paths["split"], jcfg, **kw) as je:
        jout, jst = je.run_generate(toks, NEW, kv_cache=True)
    with PipeloadEngine(paths["split"], tcfg, device="cpu", **kw) as te:
        out, st = te.run_generate(toks, NEW, kv_cache=True)
        min_ws = te.expert.min_ws
    assert_decisive(params, jcfg, tcfg, out.numpy()[:, :-1])
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert st.peak_bytes <= budget
    assert st.expert_evictions > 0
    assert st.expert_cache_bytes >= min_ws
    assert st.peak_breakdown.get("expert_cache")
    assert_same_run(st, jst)


def test_cache_too_small_raises_clear_error(stream, toks):
    jcfg, tcfg, _, paths = stream
    man = load_manifest(paths["split"])
    eb = max(s["bytes"] for s in man["shards"] if s["kind"] == "expert")
    with PipeloadEngine(paths["split"], tcfg, num_agents=2, device="cpu",
                        budget_bytes=_budget(paths["split"], jcfg),
                        expert_cache_bytes=tcfg.top_k * eb) as te:
        with pytest.raises(ValueError, match="expert cache too small"):
            te.run_single(toks)


def test_budget_below_expert_floor_raises(stream, toks):
    _, tcfg, _, paths = stream
    man = load_manifest(paths["split"])
    other = sum(s["bytes"] for s in man["shards"]
                if s["kind"] in ("embed", "head"))
    lb = max(s["bytes"] for s in man["shards"] if s["kind"] == "layer")
    with PipeloadEngine(paths["split"], tcfg, num_agents=2, device="cpu",
                        budget_bytes=other + lb + 1) as te:
        with pytest.raises(ValueError, match="expert cache"):
            te.run_single(toks)
        with pytest.raises(ValueError, match="expert cache"):
            te.run_generate(toks, 3, kv_cache=True)


def test_speculative_and_paged_refused(stream, toks):
    _, tcfg, _, paths = stream
    with PipeloadEngine(paths["split"], tcfg, page_size=4,
                        device="cpu") as te:
        with pytest.raises(ValueError, match="expert-split"):
            te.run_generate(toks[:1], 3, speculative=SpecConfig(
                paths["whole"], tcfg))
        with pytest.raises(ValueError, match="paged KV serving is not "
                           "supported"):
            BatchScheduler(te, max_total_len=TOTAL)


def test_engine_is_freed_without_the_cycle_collector(stream, toks):
    """No reference cycle keeps a closed engine (and the experts cached
    on the device) alive until the garbage collector runs."""
    _, tcfg, _, paths = stream
    gc.disable()
    try:
        te = PipeloadEngine(paths["split"], tcfg, num_agents=2,
                            device="cpu")
        te.run_single(toks)
        assert len(te.expert.cache) > 0
        te.close()
        ref = weakref.ref(te)
        del te
        assert ref() is None
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# Scheduler
# ---------------------------------------------------------------------------
def _serve_both(paths, jcfg, tcfg, prompts, new, budget=None, inflight=3):
    runs = []
    for sched_cls, eng in (
            (JaxScheduler, JaxEngine(paths["split"], jcfg, num_agents=2,
                                     budget_bytes=budget)),
            (BatchScheduler, PipeloadEngine(paths["split"], tcfg,
                                            num_agents=2, device="cpu",
                                            budget_bytes=budget))):
        sched = sched_cls(eng, max_inflight=inflight, max_total_len=TOTAL)
        try:
            sched.warmup(prompt_lens=sorted({len(p) for p in prompts}))
            rids = [sched.submit(p, new) for p in prompts]
            outs, stats = sched.run()
        finally:
            sched.close()
        runs.append((rids, outs, stats))
    return runs


def _assert_same_serving(jrun, trun):
    (jrids, jouts, jst), (rids, outs, st) = jrun, trun
    assert rids == jrids
    for rid in rids:
        np.testing.assert_array_equal(outs[rid], np.asarray(jouts[rid]))
    for f in EXPERT_FIELDS + ("rounds", "peak_bytes", "loads",
                              "streamed_bytes", "cache_bytes_peak"):
        assert getattr(st, f) == getattr(jst, f), f
    assert st.peak_breakdown == jst.peak_breakdown
    assert st.expert_hit_rate == jst.expert_hit_rate


def test_scheduler_batched_moe_matches_jax(stream):
    jcfg, tcfg, params, paths = stream
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jcfg.vocab_size, (6 + 2 * i,))
               for i in range(3)]
    jrun, trun = _serve_both(paths, jcfg, tcfg, prompts, 4)
    _assert_same_serving(jrun, trun)
    rids, outs, st = trun
    assert_decisive(params, jcfg, tcfg, [outs[r][:-1] for r in rids])
    for rid, p in zip(rids, prompts):
        with PipeloadEngine(paths["whole"], tcfg, num_agents=2,
                            device="cpu") as tw:
            seq, _ = tw.run_generate(p[None], 4, kv_cache=True)
        np.testing.assert_array_equal(outs[rid], seq.numpy()[0])
    assert st.expert_hit_rate > 0 and st.expert_misses > 0
    assert st.unique_experts_per_round > 0


def test_scheduler_admission_shrinks_expert_cache(stream):
    """A queued request's cache wins over cold cached experts: the
    reservation shrinks through the ledger, as the reference's does."""
    jcfg, tcfg, params, paths = stream
    budget = _budget(paths["split"], jcfg, extra_experts=14, batch=1)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, jcfg.vocab_size, (6,)) for _ in range(2)]
    jrun, trun = _serve_both(paths, jcfg, tcfg, prompts, 3, budget=budget,
                             inflight=2)
    _assert_same_serving(jrun, trun)
    rids, outs, st = trun
    assert_decisive(params, jcfg, tcfg, [outs[r][:-1] for r in rids])
    assert sorted(outs) == sorted(rids)
    assert st.peak_bytes <= budget
    assert st.max_inflight_seen == 2
    assert any(e[1] == "expert_evict" for e in st.events)


# ---------------------------------------------------------------------------
# Profiler, planner, facade, CLI
# ---------------------------------------------------------------------------
def test_profile_and_plan_moe(stream):
    jcfg, tcfg, _, paths = stream
    prof = profile_model(paths["split"], tcfg, batch=1, seq=PROMPT,
                         repeats=1, device="cpu")
    assert prof["expert_split"] and prof["n_experts"] == tcfg.n_experts
    assert prof["top_k"] == tcfg.top_k
    assert prof["expert_bytes"] > 0 and prof["expert_t_load"] > 0
    rows = [s for s in prof["shards"] if s["kind"] == "expert"]
    assert len(rows) == tcfg.num_layers * tcfg.n_experts
    assert all(r["t_load"] > 0 for r in rows)
    man = load_manifest(paths["split"])
    assert prof["layer_bytes"] < man["layer_bytes"] + man[
        "expert_total_bytes"]
    assert prof["other_bytes"] == man["total_bytes"] - man[
        "layer_bytes"] - man["expert_total_bytes"]
    # both planners make the same plan from this profile
    budget = _budget(paths["split"], jcfg, extra_experts=10)
    cb = tcfg.cache_bytes(1, TOTAL)
    for b in (budget, None):
        [g] = plan_generate(prof, [b], new_tokens=NEW,
                            cache_bytes_per_layer=cb, max_agents=3)
        [jg] = jax_plan_generate(prof, [b], new_tokens=NEW,
                                 cache_bytes_per_layer=cb, max_agents=3)
        assert dataclasses.asdict(g) == dataclasses.asdict(jg)
        assert g.feasible and g.expert_cache_bytes > 0
        if b is not None:
            assert g.predicted_peak_bytes <= budget
        else:   # an unconstrained budget caches the whole expert pool
            assert g.expert_cache_bytes == prof["expert_bytes"] * \
                tcfg.num_layers * tcfg.n_experts


@pytest.mark.parametrize("generate", [0, 3])
def test_hermes_execute_matches_jax(stream, toks, tmp_path, generate):
    """``Hermes.execute`` end to end: the planned generation (its agents,
    pin window and expert cache from the generation-aware plan) and the
    single pass, both packages planning from one profile."""
    jcfg, tcfg, params, paths = stream
    ckpt = tmp_path / "split"
    shutil.copytree(paths["split"], ckpt)
    hermes = Hermes(ckpt, tcfg, device="cpu")
    prof = hermes.profile(seq=PROMPT)
    (ckpt / "profile.json").write_text(json.dumps(prof))
    budget = _budget(paths["split"], jcfg, extra_experts=12, batch=1)
    kw = dict(generate=generate, kv_cache=bool(generate),
              budget_bytes=budget)
    if not generate:
        kw.update(num_agents=2)
    jst = JaxHermes(ckpt, jcfg).execute(toks[:1], **kw)
    st = hermes.execute(toks[:1], **kw)
    assert st.peak_bytes <= budget
    assert st.expert_misses > 0
    assert st.new_tokens == generate
    assert (st.num_agents, st.cache_bytes) == (jst.num_agents,
                                               jst.cache_bytes)
    # the plan may pin layers, whose attribution at the peak is not
    # deterministic: peaks and counts only
    assert_same_run(st, jst, breakdown=False)
    assert hermes.telemetry() is telemetry()


def test_serve_cli_serves_moe_on_cpu(capsys, tmp_path, monkeypatch):
    monkeypatch.setattr(serve, "CKPT_ROOT", tmp_path)
    serve.main(["--device", "cpu", "--arch", "qwen3_moe_30b_a3b",
                "--requests", "2", "--prompt-len", "8", "--new-tokens",
                "3"])
    out = capsys.readouterr().out
    assert "expert cache" in out.split("planner(serve)")[1].splitlines()[0]
    for row in ("expert_hit_rate", "experts_per_round", "expert_cache_mb"):
        assert row in out
    assert "served 2 reqs x 3 tokens" in out
    man = tp.load_manifest(tmp_path / "qwen3-moe-30b-a3b-smoke")
    assert man["expert_split"] and man["num_layers"] == 8


@pytest.mark.parametrize("flags, msg", [
    (["--page-size", "4"], "paged KV serving is not supported with "
     "expert-split MoE"),
    # quantized expert shards are served; with paged KV they are still
    # refused, before any checkpoint is written
    (["--quant", "int8", "--page-size", "4"], "paged KV serving is not "
     "supported with expert-split MoE")], ids=["page-size", "quant"])
def test_serve_cli_moe_refusals(flags, msg, tmp_path, monkeypatch):
    monkeypatch.setattr(serve, "CKPT_ROOT", tmp_path)
    with pytest.raises(SystemExit, match=msg):
        serve.main(["--device", "cpu", "--arch", "qwen3_moe_30b_a3b"]
                   + flags)
    assert list(tmp_path.iterdir()) == []
