"""The port's paged continuous batching (prefix sharing, copy-on-write,
growth preemption) and chunked prefill against the JAX package's, on one
checkpoint the JAX package wrote: identical tokens, the same page
counters, and ledger peaks equal to the byte on the same schedule.  Also
the serve CLI's paged and chunked flags on the CPU."""
import re
import shutil

import jax
import numpy as np
import pytest

from repro.checkpoint import load_manifest, partition_and_save
from repro.configs import get_config
from repro.core import BatchScheduler as JaxScheduler
from repro.core import Hermes as JaxHermes
from repro.core import PipeloadEngine as JaxEngine
from repro.models.dense_lm import init_params as jax_init
from repro_torch.configs import get as torch_get
from repro_torch.core import BatchScheduler, Hermes, PipeloadEngine
from repro_torch.launch import serve

# reduced gpt2_base, as tests/test_kv_pages.py cuts it
GEOM = dict(num_layers=3, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
            d_ff=128, vocab_size=300, vocab_pad_to=4, remat=False)
MAX_TOTAL = 16
PAGED_FIELDS = ("page_size", "pages_allocated", "page_reuses",
                "prefix_hit_pages", "cow_copies", "preemptions",
                "pool_pages_peak", "cache_bytes_peak", "peak_bytes",
                "rounds", "max_inflight_seen", "chunk_size", "chunk_jobs")


@pytest.fixture(scope="module")
def gpt2s(tmp_path_factory):
    jcfg = get_config("gpt2_base").with_(**GEOM)
    tcfg = torch_get("gpt2_base").with_(**GEOM)
    path = tmp_path_factory.mktemp("ckpt") / "gpt2s"
    partition_and_save(jax_init(jax.random.PRNGKey(0), jcfg), jcfg, path)
    man = load_manifest(path)
    layer_b = man["layer_bytes"] // jcfg.num_layers
    other = man["total_bytes"] - man["layer_bytes"]
    return jcfg, tcfg, path, layer_b, other


def _run(sched, prompts, news, arrivals=None):
    arrivals = arrivals or [0] * len(prompts)
    rids = [sched.submit(p, n, arrival_round=a)
            for p, n, a in zip(prompts, news, arrivals)]
    outs, stats = sched.run()
    sched.close()
    return [np.asarray(outs[r]) for r in rids], stats, sched


def _both(gpt2s, prompts, news, *, arrivals=None, page_size=None,
          budget=None, pin=0, max_inflight=4, max_total=MAX_TOTAL, **sk):
    """Serve the same requests through the reference and the port with the
    same engine and scheduler settings."""
    jcfg, tcfg, path = gpt2s[:3]
    ek = dict(mode="pipeload", num_agents=2, budget_bytes=budget,
              pin_window=pin, page_size=page_size)
    sk = dict(max_inflight=max_inflight, max_total_len=max_total, **sk)
    jout = _run(JaxScheduler(JaxEngine(path, jcfg, **ek), **sk), prompts,
                news, arrivals)
    tout = _run(BatchScheduler(PipeloadEngine(path, tcfg, device="cpu",
                                              **ek), **sk),
                prompts, news, arrivals)
    return jout, tout


def _assert_same(jout, tout):
    (jt, jst, _), (tt, tst, tsched) = jout, tout
    for t, j in zip(tt, jt):
        np.testing.assert_array_equal(t, j)
    for f in PAGED_FIELDS:
        assert getattr(tst, f) == getattr(jst, f), f
    assert [p[:3] for p in tst.policy] == [p[:3] for p in jst.policy]
    assert sum(tst.peak_breakdown.values()) == tst.peak_bytes
    if tsched.page_size:
        assert tsched.pool.mapped_pages == 0          # drained
        _assert_pool_is_mapped_peak(tsched, tst)
    assert tst.kernel_launches == dict.fromkeys(tst.kernel_launches, 0)


def _assert_pool_is_mapped_peak(sched, stats):
    """The physical pools hold one row per page id handed out, which is
    the mapped high-water mark: their bytes are the ledger's peak charge
    for pages, not a worst-case buffer beside it."""
    rows = {a.shape[0] for c in sched._pools.values() for a in c.values()}
    assert rows == {stats.pool_pages_peak}
    assert sum(a.nbytes for c in sched._pools.values()
               for a in c.values()) == stats.cache_bytes_peak


def _one_layer_budget(gpt2s, n_req, *, pin=0, page=4, max_total=MAX_TOTAL):
    """A budget that admits the pinned layers, one streaming layer, and
    the KV of ``n_req`` requests at ``max_total`` tokens (whole pages)
    plus one page of admission headroom.  The KV is smaller than a layer,
    so the loaders never hold two streaming layers at once, and the ledger
    peak does not depend on when they drop the last round's layers."""
    _, tcfg, _, layer_b, other = gpt2s
    page_b = tcfg.num_layers * tcfg.cache_bytes(1, page)
    kv = (n_req * -(-max_total // page) + 1) * page_b
    assert kv < layer_b
    return other + (pin + 1) * layer_b + kv


def _shared_prompts(seed, n, shared_len, tail):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 300, (shared_len,))
    return [np.concatenate([shared, rng.integers(0, 300, (tail,))])
            for _ in range(n)]


# ---------------------------------------------------------------------------
# paged serving == the reference's paged serving
# ---------------------------------------------------------------------------
def test_shared_prefixes_match_jax(gpt2s):
    prompts = _shared_prompts(1, 3, 8, 4)
    budget = _one_layer_budget(gpt2s, 3)
    jout, tout = _both(gpt2s, prompts, [4, 2, 3], page_size=4,
                       budget=budget)
    _assert_same(jout, tout)
    assert tout[1].prefix_hit_pages > 0
    # and the same tokens as the port's own dense serving
    _, (dense, dst, _) = _both(gpt2s, prompts, [4, 2, 3], budget=budget)
    for a, b in zip(tout[0], dense):
        np.testing.assert_array_equal(a, b)
    assert tout[1].cache_bytes_peak < dst.cache_bytes_peak


def test_odd_page_size_matches_jax(gpt2s):
    """A page size that does not divide max_total_len."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 300, (7,)) for _ in range(2)]
    _assert_same(*_both(gpt2s, prompts, [4, 4], page_size=5,
                        budget=_one_layer_budget(gpt2s, 2, page=5)))


def test_pinned_window_matches_jax(gpt2s):
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 300, (8,)) for _ in range(2)]
    _assert_same(*_both(gpt2s, prompts, [3, 3], page_size=4, pin=2,
                        budget=_one_layer_budget(gpt2s, 2, pin=2)))


def test_prefix_cache_off_matches_jax(gpt2s):
    p = np.random.default_rng(4).integers(0, 300, (8,))
    jout, tout = _both(gpt2s, [p, p], [3, 3], page_size=4,
                       budget=_one_layer_budget(gpt2s, 2),
                       prefix_cache=False)
    _assert_same(jout, tout)
    assert tout[1].prefix_hit_pages == 0


def test_cow_on_identical_prompts_matches_jax(gpt2s):
    """Identical prompts share even the partial last page; the first
    divergent decode write copies it."""
    p = np.random.default_rng(6).integers(0, 300, (10,))
    jout, tout = _both(gpt2s, [p, p], [4, 4], page_size=4,
                       budget=_one_layer_budget(gpt2s, 2))
    _assert_same(jout, tout)
    assert tout[1].cow_copies >= 1
    np.testing.assert_array_equal(tout[0][0], tout[0][1])


def test_growth_preemption_matches_jax(gpt2s):
    """Room for exactly 7 pages above one streaming layer: three 1-page
    prompts admit, their growth outruns the budget and the youngest is
    preempted, re-queued and finished later."""
    _, tcfg, _, layer_b, other = gpt2s
    page_b = tcfg.num_layers * tcfg.cache_bytes(1, 4)
    budget = other + 7 * page_b + layer_b
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 300, (4,)) for _ in range(3)]
    jout, tout = _both(gpt2s, prompts, [12] * 3, page_size=4, budget=budget,
                       max_inflight=3)
    _assert_same(jout, tout)
    assert tout[1].preemptions >= 1 and tout[1].peak_bytes <= budget


def test_pool_rows_track_mapped_peak(gpt2s):
    """Two waves through two slots: the second wave reuses the first's
    freed ids, so the pools stop at the mapped peak, below the pages
    handed out, and below the worst case of max_inflight full tables."""
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, 300, (6,)) for _ in range(4)]
    jout, tout = _both(gpt2s, prompts, [5] * 4, page_size=4, max_inflight=2,
                       budget=_one_layer_budget(gpt2s, 2))
    _assert_same(jout, tout)
    _, stats, sched = tout
    assert stats.page_reuses > 0
    assert stats.pool_pages_peak < stats.pages_allocated
    assert stats.pool_pages_peak < 2 * -(-MAX_TOTAL // 4)


def test_preemption_victim_is_youngest_matches_jax(gpt2s):
    _, tcfg, _, layer_b, other = gpt2s
    page_b = tcfg.num_layers * tcfg.cache_bytes(1, 4)
    budget = other + 6 * page_b + layer_b
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, 300, (4,)) for _ in range(2)]
    jout, tout = _both(gpt2s, prompts, [12, 12], arrivals=[0, 1],
                       page_size=4, budget=budget, max_inflight=2)
    _assert_same(jout, tout)
    assert {e[2] for e in tout[1].event_log(["preempt"])} == {"req1"}


def test_paged_admits_more_than_dense_matches_jax(gpt2s):
    _, tcfg, _, layer_b, other = gpt2s
    per_req = tcfg.num_layers * tcfg.cache_bytes(1, MAX_TOTAL)
    budget = other + layer_b + int(2.5 * per_req)
    prompts = _shared_prompts(7, 4, 12, 1)
    jd, td = _both(gpt2s, prompts, [3] * 4, budget=budget)
    jp, tp = _both(gpt2s, prompts, [3] * 4, budget=budget, page_size=4)
    _assert_same(jd, td)
    _assert_same(jp, tp)
    assert td[1].max_inflight_seen == 2
    assert tp[1].max_inflight_seen > td[1].max_inflight_seen
    assert tp[1].peak_bytes <= budget


@pytest.mark.parametrize("extra_pages,ok", [(0, False), (1, True)])
def test_submit_headroom_matches_jax(gpt2s, extra_pages, ok):
    """A budget fitting a request's pages but not the one-page admission
    headroom is rejected at submit() by both; one page more serves."""
    jcfg, tcfg, path, layer_b, other = gpt2s
    page_b = tcfg.num_layers * tcfg.cache_bytes(1, 8)
    budget = other + layer_b + (1 + extra_pages) * page_b
    ek = dict(mode="pipeload", num_agents=2, budget_bytes=budget,
              page_size=8)
    scheds = [JaxScheduler(JaxEngine(path, jcfg, **ek), max_inflight=2,
                           max_total_len=MAX_TOTAL),
              BatchScheduler(PipeloadEngine(path, tcfg, device="cpu", **ek),
                             max_inflight=2, max_total_len=MAX_TOTAL)]
    if not ok:
        for s in scheds:
            with pytest.raises(ValueError, match="KV decode floor"):
                s.submit(np.arange(6), 2)
            s.close()
        return
    (jt, jst, _), (tt, tst, _) = [_run(s, [np.arange(6)], [2])
                                  for s in scheds]
    np.testing.assert_array_equal(tt[0], jt[0])
    assert tst.peak_bytes == jst.peak_bytes


def test_hermes_facade_paged_matches_jax(gpt2s, tmp_path):
    """profile -> plan_generate(page_sizes) -> engine -> scheduler, both
    packages planning from one measured profile."""
    jcfg, tcfg, path, layer_b, other = gpt2s
    local = tmp_path / "ckpt"
    shutil.copytree(path, local)
    jh = JaxHermes(local, jcfg)
    jh.profile(batch=1, seq=8, force=True)
    shutil.copy(local / "profile.json", local / "profile_torch_cpu.json")
    th = Hermes(local, tcfg, device="cpu")
    page_b = tcfg.num_layers * tcfg.cache_bytes(1, 4)
    budget = other + 14 * page_b + 3 * layer_b
    kw = dict(budget_bytes=budget, max_inflight=3, prompt_len=8,
              new_tokens=4, page_sizes=(4,), shared_prefix_len=8, seed=7)
    shared = np.random.default_rng(11).integers(0, 300, (8,))
    jt, jst, _ = _run(jh.scheduler(**kw), [shared] * 3, [4] * 3)
    tt, tst, tsched = _run(th.scheduler(**kw), [shared] * 3, [4] * 3)
    _assert_same((jt, jst, None), (tt, tst, tsched))
    assert tst.page_size == 4 and tst.peak_bytes <= budget
    assert tst.seed == 7


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("page", [5, 8])
@pytest.mark.parametrize("chunk", [5, 8, 10])
def test_chunked_prefill_token_identity(gpt2s, chunk, page):
    """Splitting long prompts into chunk-joined rounds changes no token of
    the port's monolithic paged serving, and the chunk schedule (jobs,
    rounds, pages, ledger peak) is the reference's."""
    rng = np.random.default_rng(chunk * 10 + page)
    lens = rng.integers(12, 21, 3).tolist()       # all exceed the chunk
    news = [int(min(n, 26 - lens[i]))
            for i, n in enumerate(rng.integers(2, 5, 3))]
    prompts = [rng.integers(0, 300, (s,)) for s in lens]
    arrivals = rng.integers(0, 4, 3).tolist()
    kw = dict(arrivals=arrivals, page_size=page, max_inflight=3,
              max_total=26)
    _, (mono, _, _) = _both(gpt2s, prompts, news, **kw)
    jout, tout = _both(gpt2s, prompts, news, chunk_prefill=chunk, **kw)
    _assert_same(jout, tout)
    assert tout[1].chunk_jobs > 0
    assert tout[1].chunk_size % page == 0          # page-aligned rounding
    for a, b in zip(tout[0], mono):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# serve CLI on the CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("flags,rows", [
    # 12 shared tokens = 3 shared pages: with fewer the planner keeps the
    # dense reservation at this shape
    (["--page-size", "4", "--shared-prefix", "12"],
     ["page_size", "prefix_hit_pages", "cow_copies", "preemptions"]),
    (["--page-size", "4", "--chunk-prefill", "8"],
     ["page_size", "chunk_prefill"])])
def test_serve_cli_paged_on_cpu(tmp_path, monkeypatch, capsys, flags, rows):
    """A budget under which the planner picks the paged reservation: the
    summary grows the paged-KV rows."""
    monkeypatch.setattr(serve, "CKPT_ROOT", tmp_path)
    serve.main(["--device", "cpu", "--requests", "3", "--prompt-len", "16",
                "--new-tokens", "3", "--max-inflight", "3",
                "--budget-mb", "10", "--seed", "4"] + flags)
    out = capsys.readouterr().out
    assert "page size 4" in out
    assert re.search(r"served 3 reqs x 3 tokens in \d+ rounds", out)
    for row in rows:
        assert re.search(rf"^\s+{row}\s", out, re.M), row
    if "--shared-prefix" in flags:
        hits = re.search(r"prefix_hit_pages\s+(\d+)", out)
        assert int(hits.group(1)) > 0


def test_serve_cli_chunk_needs_page_size():
    with pytest.raises(SystemExit, match="needs --page-size"):
        serve.main(["--device", "cpu", "--chunk-prefill", "8"])
