"""The port's speculative decoding against the JAX package's, on
checkpoints the JAX package wrote: the single-request draft/verify loop
(``run_generate(speculative=...)``), speculative serving in the
scheduler, the planner's spec-depth search, the audit's drain of the
``draft`` and ``spec_headroom`` owners, and ``serve --draft-arch``.
Greedy tokens equal the JAX package's bitwise, and so do the spec
counters and the ledger peaks at equal schedules."""
import dataclasses
import json
import re

import jax
import numpy as np
import pytest

from repro.checkpoint import load_manifest, partition_and_save
from repro.configs import get_config
from repro.core import BatchScheduler as JaxScheduler
from repro.core import PipeloadEngine as JaxEngine
from repro.core.engine import DraftModel as JaxDraft
from repro.core.engine import SpecConfig as JaxSpec
from repro.core.planner import plan_generate as jax_plan_generate
from repro.models.dense_lm import init_params as jax_init
from repro_torch.configs import get as torch_get
from repro_torch.core import BatchScheduler, PipeloadEngine
from repro_torch.core.engine import LEDGER_OWNERS, DraftModel, SpecConfig
from repro_torch.core.kv_pages import pages_for
from repro_torch.core.planner import plan_generate
from repro_torch.launch import serve

# the target and weak draft of tests/test_spec_decode.py
GEOM = dict(num_layers=3, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
            d_ff=128, vocab_size=300, vocab_pad_to=4, remat=False)
MAX_TOTAL = 16
SPEC_FIELDS = ("spec_depth", "spec_rounds", "draft_tokens",
               "accepted_tokens", "rounds", "peak_bytes", "pages_allocated",
               "prefix_hit_pages", "cow_copies", "preemptions",
               "pool_pages_peak", "cache_bytes_peak", "max_inflight_seen")


def _write(tmp_path_factory, name, num_layers, key):
    jcfg = get_config("gpt2_base").with_(
        **dict(GEOM, num_layers=num_layers), name=name)
    tcfg = torch_get("gpt2_base").with_(
        **dict(GEOM, num_layers=num_layers), name=name)
    path = tmp_path_factory.mktemp("ckpt") / name
    partition_and_save(jax_init(jax.random.PRNGKey(key), jcfg), jcfg, path)
    return jcfg, tcfg, path


@pytest.fixture(scope="module")
def gpt2s(tmp_path_factory):
    """The small GPT-2-geometry target: (jax cfg, torch cfg, path)."""
    return _write(tmp_path_factory, "gpt2s", 3, 0)


@pytest.fixture(scope="module")
def draft1(tmp_path_factory):
    """A deliberately WEAK draft: one layer over the same vocabulary, its
    own weights, so verify rejects most proposals."""
    return _write(tmp_path_factory, "gpt2s-d1", 1, 1)


def _mem(path, cfg):
    man = load_manifest(path)
    layer_b = man["layer_bytes"] // cfg.num_layers
    return layer_b, man["total_bytes"] - man["layer_bytes"]


# ---------------------------------------------------------------------------
# the single-request draft/verify loop
# ---------------------------------------------------------------------------
def _engine_budget(target, draft, s0, new, ps, depth):
    """The engine's own feasibility floor for this run: the shards other
    than layers, one streaming layer, the worst mapped pages and the
    draft with its cache.  It admits one streaming layer at a time, so
    the ledger peak does not depend on when the loaders drop a layer."""
    jcfg, _, path = target
    djcfg, _, dpath = draft
    layer_b, other = _mem(path, jcfg)
    total = s0 + new
    page_b = jcfg.num_layers * jcfg.cache_bytes(1, ps)
    pages = pages_for(total, ps) + pages_for(depth + 1, ps) + 1
    draft_b = load_manifest(dpath)["total_bytes"]
    return (other + layer_b + pages * page_b + draft_b
            + djcfg.num_layers * djcfg.cache_bytes(1, total))


def _both_engines(target, prompt, new, *, page_size=None, draft=None,
                  depth=4, budget=None):
    """(jax (tokens, stats), port (tokens, stats)) of one generation."""
    jcfg, tcfg, path = target
    kw = dict(mode="pipeload", num_agents=2, page_size=page_size,
              budget_bytes=budget)
    jspec = tspec = None
    if draft is not None:
        jspec = JaxSpec(draft[2], draft[0], depth=depth)
        tspec = SpecConfig(draft[2], draft[1], depth=depth)
    with JaxEngine(path, jcfg, **kw) as je:
        jout, jst = je.run_generate(prompt, new, kv_cache=True,
                                    speculative=jspec)
    with PipeloadEngine(path, tcfg, device="cpu", **kw) as te:
        tout, tst = te.run_generate(prompt, new, kv_cache=True,
                                    speculative=tspec)
    return (np.asarray(jout), jst), (tout.numpy(), tst)


def _assert_same_run(jres, tres):
    (jt, jst), (tt, tst) = jres, tres
    np.testing.assert_array_equal(tt, jt)
    for f in ("spec_depth", "spec_rounds", "draft_tokens", "accepted_tokens",
              "new_tokens", "cache_bytes", "peak_bytes", "loads",
              "streamed_bytes"):
        assert getattr(tst, f) == getattr(jst, f), f
    assert tst.peak_breakdown == jst.peak_breakdown
    assert sum(tst.peak_breakdown.values()) == tst.peak_bytes


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("page_size", [5, 8])   # odd and power of two
def test_engine_self_draft_matches_jax(gpt2s, page_size, depth):
    """Self-speculation (draft == target) gives the JAX engine's tokens,
    which are the dense path's, with acceptance exactly 1.0 and the
    same rounds, counters and ledger peaks."""
    rng = np.random.default_rng(page_size)
    prompt = rng.integers(0, 300, (1, 6))
    new = 8
    budget = _engine_budget(gpt2s, gpt2s, 6, new, page_size, depth)
    jres, tres = _both_engines(gpt2s, prompt, new, page_size=page_size,
                               draft=gpt2s, depth=depth, budget=budget)
    _assert_same_run(jres, tres)
    tst = tres[1]
    assert tst.acceptance_rate == 1.0
    assert 0 < tst.spec_rounds < new
    assert tst.peak_breakdown["draft"] == load_manifest(
        gpt2s[2])["total_bytes"]
    # the port's dense path gives the same tokens
    with PipeloadEngine(gpt2s[2], gpt2s[1], num_agents=2,
                        device="cpu") as te:
        dense, _ = te.run_generate(prompt, new, kv_cache=True)
    np.testing.assert_array_equal(tres[0], dense.numpy())


def test_engine_weak_draft_matches_jax(gpt2s, draft1):
    """Correctness does not depend on the draft: a 1-layer random draft
    gives the JAX tokens (verify rejects, the bonus token progresses)."""
    prompt = np.random.default_rng(3).integers(0, 300, (1, 6))
    budget = _engine_budget(gpt2s, draft1, 6, 8, 5, 4)
    jres, tres = _both_engines(gpt2s, prompt, 8, page_size=5, draft=draft1,
                               depth=4, budget=budget)
    _assert_same_run(jres, tres)
    assert tres[1].spec_rounds >= 1
    assert tres[1].acceptance_rate < 1.0


def test_engine_spec_needs_paged_cache(gpt2s):
    _, tcfg, path = gpt2s
    with PipeloadEngine(path, tcfg, num_agents=2, device="cpu") as te:
        with pytest.raises(ValueError, match="paged KV"):
            te.run_generate(np.arange(6)[None], 4, kv_cache=True,
                            speculative=SpecConfig(path, tcfg, depth=2))


def test_draft_rejects_expert_split(tmp_path):
    """A draft must pin whole, so an expert-split manifest raises, with
    the reference's ValueError."""
    (tmp_path / "manifest.json").write_text(
        json.dumps({"expert_split": True, "shards": []}))
    with pytest.raises(ValueError, match="pin whole"):
        DraftModel(tmp_path, torch_get("gpt2_base").with_(**GEOM),
                   device="cpu")


def test_engine_spec_audit_drains(gpt2s, monkeypatch):
    """Under the audit the engine's own drain point checks stream,
    kv_pages, draft and spec_headroom; the draft's device copies go with
    its last pin's ledger bytes."""
    monkeypatch.setenv("REPRO_LEDGER_AUDIT", "1")
    _, tcfg, path = gpt2s
    with PipeloadEngine(path, tcfg, num_agents=2, page_size=4,
                        device="cpu") as te:
        _, st = te.run_generate(np.arange(7)[None], 5, kv_cache=True,
                                speculative=SpecConfig(path, tcfg, depth=2))
        draft = te._drafts[str(path)]
    assert st.spec_depth == 2 and st.new_tokens == 5
    assert set(st.peak_breakdown) >= {"draft", "spec_headroom", "kv_pages"}
    assert draft.weights is None and draft.device.type == "cpu"


def test_draft_pins_are_counted(draft1):
    """One draft pinned by two sessions keeps its device copies until the
    second unpin; each ledger is charged and drained on its own."""
    from repro_torch.core.engine import _Ledger
    _, dcfg, dpath = draft1
    draft = DraftModel(dpath, dcfg, device="cpu")
    first, second = _Ledger(None), _Ledger(None)
    draft.pin(first)
    weights = draft.weights
    draft.pin(second)
    assert draft.weights is weights               # copied once
    draft.unpin(first)
    assert draft.weights is weights               # the second pin holds it
    assert first.by_owner["draft"] == 0
    assert second.by_owner["draft"] == draft.total_bytes
    logits, _ = draft.prefill([[1, 2, 3]], 8)
    assert logits.shape == (1, dcfg.padded_vocab)
    draft.unpin(second)
    assert draft.weights is None and second.by_owner["draft"] == 0
    draft.pin()                                   # re-pins from the host
    assert draft.weights is not None
    draft.unpin()
    assert draft.weights is None


# ---------------------------------------------------------------------------
# speculative serving
# ---------------------------------------------------------------------------
def _serve_budget(target, draft, n_req, ps, depth, pages=None):
    """One streaming layer, the draft, one cache row per request in
    flight, and ``pages`` pages (by default every request's worst case
    and two more).  With one request left and its first two pages mapped,
    the room above one layer is still less than a layer, so the ledger
    peak does not depend on when the loaders drop a layer."""
    jcfg, _, path = target
    djcfg, _, dpath = draft
    layer_b, other = _mem(path, jcfg)
    page_b = jcfg.num_layers * jcfg.cache_bytes(1, ps)
    if pages is None:
        pages = n_req * pages_for(MAX_TOTAL + depth, ps) + 2
    row = djcfg.num_layers * djcfg.cache_bytes(1, MAX_TOTAL + depth)
    assert (n_req - 1) * row + (pages - 2) * page_b < layer_b
    return (other + layer_b + load_manifest(dpath)["total_bytes"]
            + n_req * row + pages * page_b)


def _serve_both(target, prompts, news, arrivals, *, draft=None, depth=0,
                budget=None, page_size=5, max_inflight=3, prefix_cache=True):
    """Serve through the reference and the port with one explicit
    (num_agents, pin_window, max_inflight)."""
    jcfg, tcfg, path = target
    ek = dict(mode="pipeload", num_agents=2, pin_window=0,
              budget_bytes=budget, page_size=page_size)
    sk = dict(max_inflight=max_inflight, max_total_len=MAX_TOTAL,
              spec_depth=depth, prefix_cache=prefix_cache)
    res = []
    for Eng, Sched, Draft, cfg_i, kw in (
            (JaxEngine, JaxScheduler, JaxDraft, 0, {}),
            (PipeloadEngine, BatchScheduler, DraftModel, 1,
             dict(device="cpu"))):
        d = (Draft(draft[2], draft[cfg_i], **kw) if draft is not None
             else None)
        sched = Sched(Eng(path, target[cfg_i], **ek, **kw), draft=d, **sk)
        rids = [sched.submit(p, n, arrival_round=a)
                for p, n, a in zip(prompts, news, arrivals)]
        outs, stats = sched.run()
        sched.close()
        res.append(([np.asarray(outs[r]) for r in rids], stats, sched))
    return res


def _spec_prompts():
    """4 requests behind a 4-token shared prefix, 2 in flight at most;
    the last arrives a round late, so admissions happen mid-flight."""
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, 300, (4, 8))
    prompts[:, :4] = prompts[0, :4]
    return list(prompts), [5] * 4, [0, 0, 0, 1]


@pytest.mark.parametrize("weak", [False, True], ids=["self", "weak"])
@pytest.mark.parametrize("depth", [2, 4])
def test_scheduler_spec_matches_jax(gpt2s, draft1, depth, weak):
    """Speculative serving at depths 2 and 4, self-draft and the weak
    draft, with a late arrival: the JAX scheduler's tokens (which are the
    plain schedule's), spec counters, rounds and pages exactly, ledger
    peak and its breakdown to the byte; the pool drains."""
    draft = draft1 if weak else gpt2s
    prompts, news, arrivals = _spec_prompts()
    budget = _serve_budget(gpt2s, draft, 2, 5, depth)
    (jt, jst, _), (tt, tst, tsched) = _serve_both(
        gpt2s, prompts, news, arrivals, draft=draft, depth=depth,
        budget=budget, max_inflight=2)
    for t, j in zip(tt, jt):
        np.testing.assert_array_equal(t, j)
    for f in SPEC_FIELDS:
        assert getattr(tst, f) == getattr(jst, f), f
    assert tst.peak_breakdown == jst.peak_breakdown
    assert [p[:3] for p in tst.policy] == [p[:3] for p in jst.policy]
    assert tst.spec_depth == depth and tst.spec_rounds > 0
    if not weak:
        assert tst.acceptance_rate == 1.0        # the self-draft ceiling
    assert tsched.pool.mapped_pages == 0
    assert tst.peak_breakdown["draft"] == load_manifest(
        draft[2])["total_bytes"]
    assert set(tst.peak_breakdown) <= set(LEDGER_OWNERS)
    assert tst.kernel_launches == dict.fromkeys(tst.kernel_launches, 0)
    # the port's own non-speculative paged serving gives the same tokens
    _, (base, _, _) = _serve_both(gpt2s, prompts, news, arrivals)
    for t, b in zip(tt, base):
        np.testing.assert_array_equal(t, b)


def test_spec_growth_preempts_where_reference_stalls(gpt2s):
    """Three self-drafted requests under a budget their 12 grown pages
    and 3 draft rows do not fit.  The reference's growth floor leaves the
    rows out, maps the pages, and its loaders then wait on S_stop for
    good (a run of the reference under a time limit stalls; this test
    does not run it).  The port's
    floor counts the rows, so it preempts the youngest request instead:
    every request finishes with the non-speculative tokens, and each
    request's tagged pages and draft row drain to zero under the
    audit."""
    _, tcfg, path = gpt2s
    budget = _serve_budget(gpt2s, gpt2s, 3, 5, 2, pages=9)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 300, (8,)) for _ in range(3)]
    sched = BatchScheduler(
        PipeloadEngine(path, tcfg, num_agents=2, budget_bytes=budget,
                       page_size=5, device="cpu"),
        max_inflight=3, max_total_len=MAX_TOTAL, spec_depth=2,
        draft=DraftModel(path, tcfg, device="cpu"))
    rids = [sched.submit(p, 8) for p in prompts]
    outs, stats = sched.run()
    assert stats.preemptions >= 1 and stats.peak_bytes <= budget
    for rid in rids:
        assert sched.ledger.audit_residue("kv_pages", f"req{rid}") == 0
        assert sched.ledger.audit_residue("spec_headroom",
                                          f"req{rid}") == 0
    sched.close()
    sched.ledger.audit_check_drained("stream", "kv_pages", "draft",
                                     "spec_headroom")
    plain = BatchScheduler(PipeloadEngine(path, tcfg, num_agents=2,
                                          page_size=5, device="cpu"),
                           max_inflight=3, max_total_len=MAX_TOTAL)
    prids = [plain.submit(p, 8) for p in prompts]
    pouts, _ = plain.run()
    plain.close()
    for rid, prid in zip(rids, prids):
        np.testing.assert_array_equal(outs[rid], pouts[prid])


def test_scheduler_spec_needs_paged(gpt2s):
    _, tcfg, path = gpt2s
    eng = PipeloadEngine(path, tcfg, num_agents=2, device="cpu")
    with pytest.raises(ValueError, match="paged KV"):
        BatchScheduler(eng, max_inflight=2, max_total_len=MAX_TOTAL,
                       draft=DraftModel(path, tcfg, device="cpu"),
                       spec_depth=4)
    with pytest.raises(ValueError, match="mutually exclusive"):
        BatchScheduler(eng, page_size=4, chunk_prefill=8,
                       draft=DraftModel(path, tcfg, device="cpu"),
                       spec_depth=2)
    eng.close()


def test_spec_audit_drains_under_faults(gpt2s, draft1, monkeypatch):
    """Transient load faults churn the stream owner; under the audit every
    request-scoped owner (stream, kv_pages, spec_headroom) drains at the
    end of ``run``, each request's tagged rows and pages to zero, and
    ``close`` drains the session's draft bytes too."""
    monkeypatch.setenv("REPRO_LEDGER_AUDIT", "1")
    monkeypatch.setenv("REPRO_PREFETCH_FAULT_RATE", "0.2")
    monkeypatch.setenv("REPRO_PREFETCH_FAULT_SEED", "3")
    monkeypatch.setenv("REPRO_PREFETCH_RETRIES", "6")
    _, tcfg, path = gpt2s
    draft = DraftModel(draft1[2], draft1[1], device="cpu")
    sched = BatchScheduler(
        PipeloadEngine(path, tcfg, num_agents=2, page_size=4, device="cpu"),
        max_inflight=3, max_total_len=MAX_TOTAL, draft=draft, spec_depth=2)
    rng = np.random.default_rng(5)
    rids = [sched.submit(rng.integers(0, 300, (8,)), 4) for _ in range(3)]
    outs, stats = sched.run()
    assert stats.retries > 0                     # faults were exercised
    assert all(len(outs[r]) == 12 for r in rids)
    for owner in ("stream", "kv_pages", "spec_headroom"):
        assert sched.ledger.by_owner.get(owner, 0) == 0, owner
    for rid in rids:
        assert sched.ledger.audit_residue("spec_headroom",
                                          f"req{rid}") == 0
        assert sched.ledger.audit_residue("kv_pages", f"req{rid}") == 0
    assert sched.ledger.by_owner["draft"] == draft.total_bytes
    sched.close()
    assert sched.ledger.by_owner["draft"] == 0
    sched.ledger.audit_check_drained("stream", "kv_pages", "draft",
                                     "spec_headroom")
    sched.close()                                # idempotent


# ---------------------------------------------------------------------------
# planner: the speculative depth dimension (tests/test_spec_decode.py's)
# ---------------------------------------------------------------------------
def _profile(n_layers=4, layer_b=1000, other=500):
    shards = [{"name": f"L{i}", "kind": "layer", "bytes": layer_b,
               "t_load": 1e-3, "t_comp": 1e-4, "t_decode": 1e-5}
              for i in range(n_layers)]
    return {"num_layers": n_layers, "layer_bytes": layer_b,
            "other_bytes": other, "shards": shards, "seq": 8,
            "quant": None}


def _plan_both(prof, budgets, **kw):
    """The port's plan, checked field for field against the JAX
    package's."""
    mine = plan_generate(prof, budgets, **kw)
    theirs = jax_plan_generate(prof, budgets, **kw)
    assert [dataclasses.asdict(e) for e in mine] == [
        dataclasses.asdict(e) for e in theirs]
    return mine


def test_planner_spec_depth_amortises_load_bound_decode():
    prof = _profile()
    kw = dict(new_tokens=16, cache_bytes_per_layer=320, max_pin=0,
              page_sizes=(8,), total_len=32)
    draft = dict(bytes=100, cache_bytes=10, acceptance=1.0, t_token=0.0)
    plain = _plan_both(prof, [None], **kw)[0]
    spec = _plan_both(prof, [None], spec_depths=(2, 4), spec_draft=draft,
                      **kw)[0]
    assert spec.spec_depth == 4
    assert spec.draft_bytes > 0
    assert spec.predicted_latency_s < plain.predicted_latency_s
    assert plain.spec_depth == 0 and plain.draft_bytes == 0


def test_planner_spec_depth_zero_when_draft_busts_budget():
    prof = _profile()
    budget = prof["other_bytes"] + 3 * prof["layer_bytes"] + 4 * 320
    draft = dict(bytes=10 ** 9, cache_bytes=10, acceptance=1.0)
    e = _plan_both(prof, [budget], new_tokens=8, cache_bytes_per_layer=320,
                   max_pin=0, page_sizes=(8,), total_len=32,
                   spec_depths=(4,), spec_draft=draft)[0]
    assert e.feasible and e.spec_depth == 0 and e.draft_bytes == 0


def test_planner_spec_validation():
    prof = _profile()
    with pytest.raises(ValueError, match="spec_draft"):
        plan_generate(prof, [None], new_tokens=4, cache_bytes_per_layer=100,
                      page_sizes=(8,), total_len=16, spec_depths=(2,))
    with pytest.raises(ValueError, match="page_sizes"):
        plan_generate(prof, [None], new_tokens=4, cache_bytes_per_layer=100,
                      spec_depths=(2,),
                      spec_draft=dict(bytes=1, cache_bytes=1))


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------
def test_serve_cli_spec_on_cpu(tmp_path, monkeypatch, capsys):
    """``serve --page-size 4 --draft-arch gpt2_base --spec-depth 2`` on
    the CPU: the explicit depth is served on the planner's schedule, as
    the reference CLI serves it (a shared prompt prefix makes pages win
    the plan), the planner line names it and the summary prints the spec
    rows."""
    monkeypatch.setattr(serve, "CKPT_ROOT", tmp_path)
    serve.main(["--device", "cpu", "--page-size", "4", "--draft-arch",
                "gpt2_base", "--spec-depth", "2", "--requests", "3",
                "--prompt-len", "16", "--shared-prefix", "12",
                "--new-tokens", "6"])
    out = capsys.readouterr().out
    assert "page size 4, spec depth 2" in out
    assert re.search(r"spec_depth\s+2", out)
    assert re.search(r"spec_accepted\s+\d+/\d+ \(\d+%\) over \d+ verify "
                     r"rounds", out)
    assert re.search(r"draft\s+[\d,]+", out)      # the peak's draft share
    assert (tmp_path / "gpt2-base-smoke-draft" / "manifest.json").exists()


def test_serve_cli_spec_needs_a_paged_plan(tmp_path, monkeypatch):
    """Where the planner keeps dense KV (no shared prefix here), an
    explicit ``--spec-depth`` meets the scheduler's "needs paged KV"
    refusal, as in the reference CLI, which serves the depth on the
    planner's schedule."""
    monkeypatch.setattr(serve, "CKPT_ROOT", tmp_path)
    with pytest.raises(ValueError, match="needs paged KV"):
        serve.main(["--device", "cpu", "--page-size", "4", "--draft-arch",
                    "gpt2_base", "--spec-depth", "2", "--requests", "3",
                    "--prompt-len", "12", "--new-tokens", "6"])


@pytest.mark.parametrize("flags, msg", [
    (["--draft-arch", "gpt2_base"], "needs --page-size"),
    (["--draft-arch", "gpt2_base", "--page-size", "4", "--chunk-prefill",
      "8"], "incompatible"),
])
def test_serve_cli_spec_flag_errors(tmp_path, monkeypatch, flags, msg):
    monkeypatch.setattr(serve, "CKPT_ROOT", tmp_path)
    with pytest.raises(SystemExit, match=msg):
        serve.main(["--device", "cpu"] + flags)
