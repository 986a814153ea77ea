"""The port's SLO multi-tenant serving tier (priority preemption, per-tenant
prefix namespaces, SLO shedding, trace replay) against the JAX package's,
on one checkpoint the JAX package wrote, at ``tests/test_serve_slo.py``'s
geometry: the same traces from the same seeds, the golden policy trace
reproduced exactly, and on every scenario of the reference suite the
same policy log, tokens, ledger peaks and peak breakdowns to the byte.
Also ``Hermes.scheduler``'s seconds-to-rounds SLO, the tier with a
speculative draft, its telemetry, and the serve CLI's tier flags."""
import dataclasses
import json
import re
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
from helpers.traces import tiny_trace

from repro.checkpoint import load_manifest, partition_and_save
from repro.configs import get_config
from repro.core import BatchScheduler as JaxScheduler
from repro.core import Hermes as JaxHermes
from repro.core import PipeloadEngine as JaxEngine
from repro.core.engine import DraftModel as JaxDraft
from repro.core.scheduler import SLO as JaxSLO
from repro.data import traces as jtraces
from repro.models.dense_lm import init_params as jax_init
from repro_torch.configs import get as torch_get
from repro_torch.core import SLO, BatchScheduler, Hermes, PipeloadEngine
from repro_torch.core import telemetry as tele
from repro_torch.core.engine import DraftModel
from repro_torch.data import traces
from repro_torch.launch import serve

# tests/test_serve_slo.py's geometry
GEOM = dict(num_layers=3, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
            d_ff=128, vocab_size=300, vocab_pad_to=4, remat=False)
MAX_TOTAL = 26
GOLDEN = Path(__file__).parent / "golden" / "serve_slo_trace.json"
STATS = ("rounds", "requests", "new_tokens", "max_inflight_seen",
         "peak_bytes", "cache_bytes_peak", "page_size", "pages_allocated",
         "page_reuses", "prefix_hit_pages", "cow_copies", "preemptions",
         "pool_pages_peak", "chunk_size", "chunk_jobs", "tenants",
         "ttft_p50_rounds", "ttft_p99_rounds", "tpot_p50_rounds",
         "tpot_p99_rounds", "slo_attained", "goodput_tokens",
         "slo_rejections", "spec_depth", "spec_rounds", "draft_tokens",
         "accepted_tokens", "peak_breakdown")
REQUEST = ("priority", "tenant", "born_round", "arrival_round",
           "admitted_round", "finished_round", "first_token_round",
           "generated", "rejected")


def _write(tmp_path_factory, name, num_layers, key):
    jcfg = get_config("gpt2_base").with_(**dict(GEOM, num_layers=num_layers),
                                         name=name)
    tcfg = torch_get("gpt2_base").with_(**dict(GEOM, num_layers=num_layers),
                                        name=name)
    path = tmp_path_factory.mktemp("ckpt") / name
    partition_and_save(jax_init(jax.random.PRNGKey(key), jcfg), jcfg, path)
    man = load_manifest(path)
    return jcfg, tcfg, path, man


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The reference suite's 3-layer checkpoint: (jax cfg, torch cfg, path,
    layer bytes, bytes other than layers)."""
    jcfg, tcfg, path, man = _write(tmp_path_factory, "tiny", 3, 0)
    layer_b = man["layer_bytes"] // jcfg.num_layers
    return jcfg, tcfg, path, layer_b, man["total_bytes"] - man["layer_bytes"]


def _per_req(cfg):
    return cfg.num_layers * cfg.cache_bytes(1, MAX_TOTAL)


def _page_bytes(cfg, page):
    return cfg.num_layers * cfg.cache_bytes(1, page)


def _one_layer_budget(tiny, kv_bytes):
    """The shards other than layers, one streaming layer and ``kv_bytes``
    of cache.  The cache is smaller than a layer, so the loaders never
    hold two streaming layers at once and the ledger peak (and its
    breakdown) does not depend on when they drop a round's layers."""
    _, _, _, layer_b, other = tiny
    assert kv_bytes < layer_b
    return other + layer_b + kv_bytes


def _port_trace(n, *, seed, tenants=2, max_total=MAX_TOTAL, prefix_len=0):
    """``helpers.traces.tiny_trace`` through the port's own generator."""
    return traces.make_trace(n, tenants=tenants, seed=seed, vocab=300,
                             arrival_rate=1.5, prompt_mean=8,
                             max_prompt=max_total - 4, new_mean=2,
                             max_new=4, prefix_len=prefix_len,
                             share_prefix=0.5)


def _both(tiny, feed, *, budget=None, page_size=None, drafts=(None, None),
          slo=None, **sk):
    """Serve ``feed(sched) -> {key: rid}`` through the reference and the
    port with one engine and scheduler setting (``drafts``: each
    package's draft model; ``slo``: the port's ``SLO``, handed to the
    reference as its own).  Returns [(outs by key, stats, sched)] for
    (reference, port)."""
    jcfg, tcfg, path = tiny[:3]
    ek = dict(mode="pipeload", num_agents=2, budget_bytes=budget,
              page_size=page_size)
    sk = dict(max_total_len=MAX_TOTAL, page_size=page_size, **sk)
    jslo = None if slo is None else JaxSLO(**dataclasses.asdict(slo))
    out = []
    for eng, sched_cls, draft, s in (
            (JaxEngine(path, jcfg, **ek), JaxScheduler, drafts[0], jslo),
            (PipeloadEngine(path, tcfg, device="cpu", **ek), BatchScheduler,
             drafts[1], slo)):
        sched = sched_cls(eng, draft=draft, slo=s, **sk)
        keys = feed(sched)
        outs, stats = sched.run()
        sched.close()
        out.append(({k: np.asarray(outs[r]) for k, r in keys.items()},
                    stats, sched))
    return out


def _assert_same(jout, tout):
    """Policy log, tokens, every counter, the ledger peak and its
    breakdown to the byte, and each request's rounds."""
    (jo, jst, js), (to, tst, ts) = jout, tout
    assert [p[:3] for p in tst.policy] == [p[:3] for p in jst.policy]
    assert set(to) == set(jo)
    for k in jo:
        np.testing.assert_array_equal(to[k], jo[k])
    for f in STATS:
        assert getattr(tst, f) == getattr(jst, f), f
    assert sum(tst.peak_breakdown.values()) == tst.peak_bytes
    assert sorted(ts.done) == sorted(js.done)
    for rid, jr in js.done.items():
        for f in REQUEST:
            assert getattr(ts.done[rid], f) == getattr(jr, f), (rid, f)
    assert tst.kernel_launches == dict.fromkeys(tst.kernel_launches, 0)
    if ts.page_size:
        assert ts.pool.mapped_pages == 0               # drained


def _feed_trace(trace, priorities=True):
    def feed(sched):
        mod = traces if isinstance(sched, BatchScheduler) else jtraces
        return mod.submit_trace(sched, trace, priorities=priorities)
    return feed


def _feed(prompts, news, arrivals=None, **per_req):
    """Submit the prompts; ``per_req`` maps a submit keyword to a list."""
    arrivals = arrivals or [0] * len(prompts)

    def feed(sched):
        return {i: sched.submit(p, n, arrival_round=a,
                                **{k: v[i] for k, v in per_req.items()})
                for i, (p, n, a) in enumerate(zip(prompts, news, arrivals))}
    return feed


# ---------------------------------------------------------------------------
# the traces: one generator, two packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,tenants,prefix_len",
                         [(0, 1, 0), (3, 2, 5), (42, 2, 5), (7, 3, 8),
                          (11, 4, 0)])
def test_traces_match_reference(seed, tenants, prefix_len, tmp_path):
    kw = dict(tenants=tenants, seed=seed, vocab=300, arrival_rate=1.5,
              prompt_mean=8, max_prompt=22, new_mean=2, max_new=4,
              prefix_len=prefix_len, share_prefix=0.5)
    got = traces.make_trace(12, **kw)
    want = jtraces.make_trace(12, **kw)
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in want]
    assert _port_trace(8, seed=seed, tenants=tenants,
                       prefix_len=prefix_len) == [
        traces.TraceRequest(**dataclasses.asdict(r)) for r in tiny_trace(
            8, seed=seed, tenants=tenants, prefix_len=prefix_len)]
    for t in range(tenants):
        assert traces.tenant_prefix(f"t{t}", 6, 300, seed) == \
            jtraces.tenant_prefix(f"t{t}", 6, 300, seed)
    assert traces.trace_max_len(got) == jtraces.trace_max_len(want)
    path = traces.save_trace(got, tmp_path / "trace.json")
    assert traces.load_trace(path) == got
    # one file format: each package reads the other's
    assert [dataclasses.asdict(r) for r in jtraces.load_trace(path)] == \
        [dataclasses.asdict(r) for r in got]


# ---------------------------------------------------------------------------
# golden trace: the policy sequence the reference pins
# ---------------------------------------------------------------------------
def test_golden_trace_policy_sequence(tiny):
    """``tests/test_serve_slo.py``'s golden replay on the port: priorities,
    chunked prefill and per-tenant prefixes, slot-bound, reproduce
    ``tests/golden/serve_slo_trace.json`` exactly (read, never written)."""
    _, tcfg, path = tiny[:3]
    trace = _port_trace(8, seed=42, tenants=2, prefix_len=5)
    eng = PipeloadEngine(path, tcfg, mode="pipeload", num_agents=2,
                         page_size=5, device="cpu")
    sched = BatchScheduler(eng, max_total_len=MAX_TOTAL, page_size=5,
                           max_inflight=2, chunk_prefill=10,
                           slo=SLO(ttft_rounds=30))
    rids = traces.submit_trace(sched, trace)
    _, stats = sched.run()
    sched.close()
    got = {
        "policy": [[k, rid, rnd] for k, rid, rnd, _ in stats.policy],
        "requests": {
            str(t.rid): {
                "tenant": t.tenant, "priority": t.priority,
                "born": sched.done[rids[t.rid]].born_round,
                "admitted": sched.done[rids[t.rid]].admitted_round,
                "finished": sched.done[rids[t.rid]].finished_round,
                "generated": sched.done[rids[t.rid]].generated,
            } for t in trace},
        "stats": {
            "rounds": stats.rounds,
            "preemptions": stats.preemptions,
            "slo_rejections": stats.slo_rejections,
            "chunk_jobs": stats.chunk_jobs,
            "prefix_hit_pages": stats.prefix_hit_pages,
            "goodput_tokens": stats.goodput_tokens,
            "ttft_p99_rounds": stats.ttft_p99_rounds,
            "tenants": stats.tenants,
        },
    }
    assert got == json.loads(GOLDEN.read_text())
    assert stats.chunk_jobs > 0 and stats.prefix_hit_pages > 0


# ---------------------------------------------------------------------------
# priority preemption under a budget: the reference's safety properties,
# and the same decisions to the byte
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,max_inflight,slots,paged", [
    (0, 1, 1, False), (1, 2, 1, False), (2, 3, 2, False),
    (3, 1, 2, True), (4, 2, 2, True), (5, 3, 2, True), (6, 3, 3, True)])
def test_preemption_never_deadlocks_never_overruns(tiny, seed, max_inflight,
                                                   slots, paged):
    """A priority trace under a budget of ``slots`` caches and one
    streaming layer: the run completes, the budget holds, the ledger
    drains exactly, every preempted request retires with its tokens, and
    the port decides, computes and charges as the reference does."""
    _, tcfg, _, _, other = tiny
    budget = _one_layer_budget(tiny, slots * _per_req(tcfg))
    trace = _port_trace(6, seed=seed)
    jout, tout = _both(tiny, _feed_trace(trace), budget=budget,
                       page_size=5 if paged else None,
                       max_inflight=max_inflight)
    _assert_same(jout, tout)
    outs, stats, sched = tout
    assert stats.requests == len(trace)
    for t in trace:
        assert sched.done[t.rid].generated == t.new_tokens
        assert len(outs[t.rid]) == len(t.prompt) + t.new_tokens
    assert stats.peak_bytes <= budget
    assert not sched.inflight and not sched.queue
    assert sched._cache_resident == 0 and sched.ledger.resident == other
    preempted = {rid for kind, rid, _, _ in stats.policy
                 if kind == "preempt"}
    assert all(sched.done[rid].finished_round >= 0 for rid in preempted)
    horizon = (max(t.arrival_round for t in trace)
               + sum(t.new_tokens for t in trace) + len(trace)
               + len(preempted) * (MAX_TOTAL + 1) + 2)
    assert stats.rounds <= horizon


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("bounce", ["slot", "room"])
def test_priority_arrival_preempts_lowest_youngest(tiny, paged, bounce):
    """A priority-2 arrival bounces the priority-0 request in flight, for
    the one concurrency slot or (two slots, one request's room) for cache
    room, in paged and dense mode: it serves first, the victim's TTFT
    keeps its first arrival, and its re-prefilled continuation equals a
    solo run's.  The reference decides and charges the same."""
    _, tcfg, path = tiny[:3]
    rng = np.random.default_rng(7)
    p_low = rng.integers(0, 300, (10,))
    p_high = rng.integers(0, 300, (6,))
    page = 5 if paged else None
    budget = _one_layer_budget(tiny, _per_req(tcfg))
    inflight = 1 if bounce == "slot" else 2
    jout, tout = _both(tiny, _feed([p_low, p_high], [8, 2], [0, 2],
                                   priority=[0, 2]),
                       budget=budget, page_size=page, max_inflight=inflight)
    _assert_same(jout, tout)
    outs, stats, sched = tout
    assert [p[:3] for p in stats.policy if p[0] == "preempt"] == [
        ("preempt", 0, 2)]
    # as in the reference, ServeStats counts preemptions in paged mode only
    assert stats.preemptions == (1 if paged else 0)
    lo, hi = sched.done[0], sched.done[1]
    assert hi.finished_round < lo.finished_round
    assert lo.born_round == 0 and lo.arrival_round == 2
    solo = BatchScheduler(PipeloadEngine(path, tcfg, num_agents=2,
                                         page_size=page, device="cpu"),
                          max_inflight=1, max_total_len=MAX_TOTAL,
                          page_size=page)
    r = solo.submit(p_low, 8)
    ref = solo.run()[0][r]
    solo.close()
    np.testing.assert_array_equal(outs[0], ref)


def test_equal_priorities_never_bounce_at_admission(tiny):
    """Admission preemption flows downhill only: an equal-class arrival
    waits for the slot."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 300, (6,)) for _ in range(2)]
    jout, tout = _both(tiny, _feed(prompts, [6, 2], [0, 1],
                                   priority=[1, 1]),
                       budget=_one_layer_budget(tiny, _per_req(tiny[1])),
                       page_size=5, max_inflight=1)
    _assert_same(jout, tout)
    assert tout[1].preemptions == 0
    assert [p[:3] for p in tout[1].policy] == [
        ("admit", 0, 0), ("retire", 0, 5), ("admit", 1, 6),
        ("retire", 1, 7)]


# ---------------------------------------------------------------------------
# tenant namespaces: share within, never across
# ---------------------------------------------------------------------------
def test_tenant_namespaces_isolate_identical_prompts(tiny):
    """Two tenants submit the SAME system prompt: pages share within each
    tenant, never across, and one tenant's retirement never frees the
    other's pages (outputs equal the unshared run's)."""
    _, tcfg, _, _, _ = tiny
    rng = np.random.default_rng(11)
    system = rng.integers(0, 300, (10,))          # two full pages at 5
    prompts = [np.concatenate([system, rng.integers(0, 300, (4,))])
               for _ in range(4)]
    news = [2, 6, 2, 6]          # t0's requests retire while t1 decodes
    tenants = [f"t{i % 2}" for i in range(4)]
    budget = _one_layer_budget(tiny, 16 * _page_bytes(tcfg, 5))
    feed = _feed(prompts, news, tenant=tenants)
    jout, tout = _both(tiny, feed, budget=budget, page_size=5,
                       max_inflight=4)
    _assert_same(jout, tout)
    _, unshared = _both(tiny, feed, budget=budget, page_size=5,
                        max_inflight=4, prefix_cache=False)
    outs, stats, sched = tout
    for k in outs:
        np.testing.assert_array_equal(outs[k], unshared[0][k])
    assert sched.tree.hits_by_tenant() == {"t0": 2, "t1": 2}
    assert stats.prefix_hit_pages == 4
    assert unshared[2].pool.stats.allocs - sched.pool.stats.allocs == 4
    assert sched.pool.stats.shares == 4


# ---------------------------------------------------------------------------
# SLO shedding
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chunk", [0, 5])
def test_slo_shed_rejects_stale_admissions(tiny, chunk):
    """``SLO(shed=True)``: a burst beyond what the TTFT target allows is
    rejected at admission (a reject policy entry, the counter and no
    token), everyone else completes in full; with chunked prefill the
    shed check counts the chunk rounds."""
    _, tcfg, _, _, _ = tiny
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 300, (8,)) for _ in range(5)]
    kw = dict(budget=_one_layer_budget(tiny, _per_req(tcfg)), page_size=5,
              max_inflight=1, chunk_prefill=chunk)
    # without shedding every request is served
    jout, tout = _both(tiny, _feed(prompts, [4] * 5), **kw)
    _assert_same(jout, tout)
    assert tout[1].slo_rejections == 0 and tout[1].new_tokens == 20
    tele.metrics().reset()
    jout, tout = _both(tiny, _feed(prompts, [4] * 5),
                       slo=SLO(ttft_rounds=3, shed=True), **kw)
    _assert_same(jout, tout)
    outs, stats, sched = tout
    shed = sorted(r for r, q in sched.done.items() if q.rejected)
    served = sorted(r for r, q in sched.done.items() if not q.rejected)
    assert stats.slo_rejections == len(shed) > 0 and served
    for r in served:
        assert sched.done[r].generated == 4
    for r in shed:
        assert sched.done[r].generated == 0 and len(outs[r]) == 0
    assert sorted(rid for k, rid, _, _ in stats.policy
                  if k == "reject") == shed
    # the port's own registry counts its own rejections
    assert tele.metrics().snapshot()["counters"]["sched.rejections"] == \
        len(shed)
    met = [q for q in sched.done.values() if sched._req_slo(q)[2]]
    assert stats.goodput_tokens == sum(q.generated for q in met)
    assert stats.slo_attained == len(met) / 5


def test_traced_slo_serve_exports_loadable_json(tiny, tmp_path):
    """A traced SLO serve: the ``reject``, ``admit``, ``preempt`` and
    ``retire`` instants land in a Chrome trace that loads back."""
    _, tcfg, path = tiny[:3]
    rng = np.random.default_rng(3)
    tele.metrics().reset()
    tele.enable()
    try:
        sched = BatchScheduler(PipeloadEngine(path, tcfg, num_agents=2,
                                              page_size=5, device="cpu"),
                               max_total_len=MAX_TOTAL, page_size=5,
                               max_inflight=1,
                               slo=SLO(ttft_rounds=6, shed=True))
        for i in range(5):
            sched.submit(rng.integers(0, 300, (8,)), 4,
                         arrival_round=min(i, 2), priority=i % 3)
        _, stats = sched.run()
        sched.close()
        trace = tele.export_chrome_trace(tmp_path / "trace.json")
    finally:
        tele.disable()
    loaded = json.loads((tmp_path / "trace.json").read_text())
    assert loaded == trace and loaded["displayTimeUnit"] == "ms"
    instants = [e for e in loaded["traceEvents"] if e["ph"] == "i"]
    for kind in ("admit", "preempt", "retire", "reject"):
        want = sum(1 for p in stats.policy if p[0] == kind)
        assert want > 0, kind
        assert sum(1 for e in instants if e["name"] == kind) == want, kind
    counters = tele.metrics().snapshot()["counters"]
    assert counters["sched.rejections"] == stats.slo_rejections
    assert counters["sched.preemptions"] == stats.preemptions


# ---------------------------------------------------------------------------
# chunked prefill under the tier: deterministic identity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,chunk,page", [(1, 5, 5), (2, 10, 5),
                                             (3, 8, 8), (4, 5, 8)])
def test_chunked_prefill_token_identity(tiny, seed, chunk, page):
    """Fixed multi-tenant traces whose prompts run past the chunk: the
    port's chunked serving gives its monolithic serving's tokens, and its
    chunk schedule is the reference's (``tests/test_serve_slo.py``'s
    version draws shapes that sometimes chunk nothing)."""
    trace = [t for t in _port_trace(8, seed=seed, prefix_len=6)]
    assert max(len(t.prompt) for t in trace) > chunk
    feed = _feed_trace(trace, priorities=False)
    # pages below one layer's bytes: one layer streams at a time, so the
    # peak does not depend on how far the loaders run ahead
    pages = (tiny[3] - 1) // _page_bytes(tiny[1], page)
    kw = dict(budget=_one_layer_budget(tiny, pages * _page_bytes(tiny[1],
                                                                 page)),
              page_size=page, max_inflight=3)
    _, (mono, _, _) = _both(tiny, feed, **kw)
    jout, tout = _both(tiny, feed, chunk_prefill=chunk, **kw)
    _assert_same(jout, tout)
    assert tout[1].chunk_jobs > 0
    assert tout[1].chunk_size % page == 0
    for k, toks in tout[0].items():
        np.testing.assert_array_equal(toks, mono[k])


# ---------------------------------------------------------------------------
# the facade: seconds -> rounds through the planned round latency
# ---------------------------------------------------------------------------
def test_hermes_scheduler_slo_rounds_match_reference(tiny, tmp_path):
    """Both packages plan from one profile: ``Hermes.scheduler(slo_ttft_s,
    slo_tpot_s)`` builds the reference's rounds-based SLO, and the trace
    served under it decides as the reference does."""
    jcfg, tcfg, path = tiny[:3]
    local = tmp_path / "ckpt"
    shutil.copytree(path, local)
    jh = JaxHermes(local, jcfg)
    prof = jh.profile(batch=1, seq=8, force=True)
    shutil.copy(local / "profile.json", local / "profile_torch_cpu.json")
    th = Hermes(local, tcfg, device="cpu")
    rl = prof["layer_t_decode"] * jcfg.num_layers
    kw = dict(budget_bytes=_one_layer_budget(tiny, 2 * _per_req(tcfg)),
              max_inflight=2, prompt_len=16, new_tokens=4,
              max_total_len=MAX_TOTAL, page_sizes=(5,), num_agents=2,
              pin_window=0, slo_ttft_s=7.5 * rl, slo_tpot_s=2.5 * rl)
    js, ts = jh.scheduler(**kw), th.scheduler(**kw)
    assert ts.slo is not None and not ts.slo.shed
    assert dataclasses.asdict(ts.slo) == dataclasses.asdict(js.slo)
    assert ts.slo.ttft_rounds >= 1 and ts.slo.tpot_rounds > 0
    # an explicit rounds SLO wins over the seconds targets
    assert th.scheduler(**kw, slo=SLO(ttft_rounds=2)).slo == \
        SLO(ttft_rounds=2)
    trace = _port_trace(6, seed=5)
    outs = []
    for sched, mod in ((js, jtraces), (ts, traces)):
        rids = mod.submit_trace(sched, trace)
        o, st = sched.run()
        sched.close()
        outs.append(({k: o[r] for k, r in rids.items()}, st, sched))
    _assert_same(*outs)


# ---------------------------------------------------------------------------
# the tier with a speculative draft
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def draft1(tmp_path_factory):
    """A weak 1-layer draft over the same vocabulary (its own weights)."""
    jcfg, tcfg, path, _ = _write(tmp_path_factory, "tiny-d1", 1, 1)
    return jcfg, tcfg, path


def test_preempted_spec_request_drains_spec_headroom(tiny, draft1):
    """A priority arrival bounces a speculative request: its draft-cache
    row and its ``spec_headroom`` bytes go with it (the ledger audit checks
    the drain), it re-prefills its draft row on re-admission, and the port
    decides, proposes and charges as the reference does."""
    _, tcfg, _, layer_b, other = tiny
    djcfg, dtcfg, dpath = draft1
    depth = 2
    drafts = (JaxDraft(dpath, djcfg), DraftModel(dpath, dtcfg, device="cpu"))
    row = drafts[1].cache_bytes(1, MAX_TOTAL + depth)
    # one request's worst pages and growth window, two spare pages and a
    # spare draft row: below a layer, so one layer streams at a time
    pages = -(-(MAX_TOTAL + depth) // 5) + -(-(depth + 1) // 5) + 2
    kv = 2 * row + pages * _page_bytes(tcfg, 5)
    assert kv < layer_b
    budget = other + layer_b + drafts[1].total_bytes + kv
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 300, (s,)) for s in (9, 6, 7)]
    jout, tout = _both(tiny, _feed(prompts, [10, 3, 4], [0, 2, 3],
                                   priority=[0, 2, 1], tenant=["a", "b", "a"]),
                       budget=budget, page_size=5, max_inflight=1,
                       drafts=drafts, spec_depth=depth,
                       slo=SLO(ttft_rounds=20))
    _assert_same(jout, tout)
    outs, stats, sched = tout
    assert stats.preemptions >= 1 and stats.spec_rounds > 0
    assert stats.peak_breakdown["spec_headroom"] == row
    # closed: the pages, the rows and the draft itself are off the ledger
    assert sched.ledger.resident == other
    assert stats.tenants == 2 and stats.slo_rejections == 0


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------
SLO_ROWS = ("ttft_p50_p99_rounds", "tpot_p50_p99_rounds", "slo_attained",
            "goodput_tokens", "shed", "tenants")


def _slo_rows(out):
    return {row: re.search(rf"^\s+{row}\s+(.*)$", out, re.M).group(1)
            for row in SLO_ROWS}


def test_serve_cli_tenants_slo_shed(tmp_path, monkeypatch, capsys):
    """``serve --tenants 2 --slo-ttft-ms --slo-shed``: the reference CLI's
    ``planner(slo)`` line and SLO summary rows, one line per request with
    its tenant and class, shed requests marked; the run's trace and
    metrics export with the reject counter."""
    monkeypatch.setattr(serve, "CKPT_ROOT", tmp_path)
    out_trace, out_metrics = tmp_path / "t.json", tmp_path / "m.json"
    serve.main(["--device", "cpu", "--tenants", "2", "--requests", "6",
                "--prompt-len", "16", "--new-tokens", "4",
                "--shared-prefix", "8", "--page-size", "4",
                "--max-inflight", "1",
                "--budget-mb", "10", "--arrival-rate", "1.5",
                "--slo-ttft-ms", "1", "--slo-shed", "--seed", "3",
                "--trace-out", str(out_trace),
                "--metrics-out", str(out_metrics)])
    out = capsys.readouterr().out
    assert re.search(r"^planner\(slo\): predicted ttft \d+ms / tpot "
                     r"[\d.]+ms -> (MEETS|MISSES) the target", out, re.M)
    rows = _slo_rows(out)
    assert rows["tenants"] == "2"
    assert re.fullmatch(r"[\d.]+ / [\d.]+", rows["ttft_p50_p99_rounds"])
    assert re.fullmatch(r"\d+% ", rows["slo_attained"] + " ")
    assert re.fullmatch(r"\d+ \([\d.]+ tok/s\)", rows["goodput_tokens"])
    lines = re.findall(r"^  req\d+ \[(t\d) p(\d)\]: arrived r\d+ (.*)$", out,
                       re.M)
    assert len(lines) == 6
    shed = sum(1 for *_, state in lines if state == "SHED")
    assert int(rows["shed"]) == shed
    # a 1 ms target is one round: with one request in flight, an arrival
    # that waits a round is shed
    assert shed > 0
    assert json.loads(out_metrics.read_text())["counters"][
        "sched.rejections"] == shed
    events = json.loads(out_trace.read_text())["traceEvents"]
    assert sum(1 for e in events
               if e["ph"] == "i" and e["name"] == "reject") == shed


def test_serve_cli_replays_a_saved_trace(tmp_path, monkeypatch, capsys):
    """``serve --trace FILE`` serves the saved requests verbatim: their
    tenants, classes and arrivals."""
    monkeypatch.setattr(serve, "CKPT_ROOT", tmp_path)
    vocab = torch_get("gpt2_base").reduced().vocab_size
    trace = traces.make_trace(5, tenants=3, seed=9, vocab=vocab,
                              arrival_rate=1.0, prompt_mean=6,
                              max_prompt=12, new_mean=2, max_new=3,
                              prefix_len=4)
    path = traces.save_trace(trace, tmp_path / "trace.json")
    serve.main(["--device", "cpu", "--trace", str(path), "--prompt-len",
                "12", "--new-tokens", "3", "--max-inflight", "2",
                "--page-size", "4", "--budget-mb", "10"])
    out = capsys.readouterr().out
    assert re.search(r"served 5 reqs x 3 tokens in \d+ rounds", out)
    lines = re.findall(r"^  req(\d+) \[(t\d) p(\d)\]: arrived r(\d+) "
                       r"admitted r\d+ finished r\d+$", out, re.M)
    assert [(int(r), t, int(p), int(a)) for r, t, p, a in lines] == [
        (t.rid, t.tenant, t.priority, t.arrival_round) for t in trace]
    assert _slo_rows(out)["shed"] == "0"
    assert int(_slo_rows(out)["tenants"]) == len({t.tenant for t in trace})


def test_serve_cli_trace_needs_kv_cache():
    with pytest.raises(SystemExit, match="need the KV-cache scheduler"):
        serve.main(["--device", "cpu", "--tenants", "2", "--no-kv-cache"])


def test_serve_cli_without_a_card_raises(tmp_path, monkeypatch):
    """Without ``--device cpu`` the tier's CLI needs the card, and says so
    before it writes anything."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(serve, "CKPT_ROOT", tmp_path)
    with pytest.raises(RuntimeError, match="is_available"):
        serve.main(["--tenants", "2", "--slo-ttft-ms", "100"])
    assert list(tmp_path.iterdir()) == []
