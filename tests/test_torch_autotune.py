"""The port's kernel autotune (``repro_torch.kernels.autotune``) and its
streamed matmul wrapper (``ops.matmul``) against the JAX package's: the
same candidate tiles, cache keys and file format, the same tile
resolution, and on the CPU the same products as the Pallas kernel run in
interpret mode.  Also how a selection reaches the serving path
(``ops.paged_decode``'s route, ``Hermes.autotune``
and ``serve --autotune``)."""
import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from repro.configs import get_config
from repro.kernels import autotune as jautotune
from repro.kernels import ops as jops
from repro_torch.core.modules import resolve_attn_impl
from repro_torch.kernels import autotune, ops, ref
from repro_torch.kernels.autotune import AutotuneCache, _fit, _tile_candidates
from repro_torch.kernels.streamed_matmul import cta_tile
from repro_torch.launch import serve

# ``tests/test_kernels.py``'s matmul tolerance, per dtype, times sqrt(K)
ATOL = {"float32": 2e-4, "bfloat16": 6e-2}
SHAPES = [(8, 64, 128), (256, 768, 3072), (256, 1024, 4096), (100, 70, 30),
          (8, 70, 64), (384, 256, 512), (1, 1, 1), (192, 300, 96)]


@pytest.fixture(autouse=True)
def _clean_tuned():
    """Every test starts and ends with no installed selections in either
    package (the tuned defaults are process-wide)."""
    ops.set_tuned()
    jops.set_tuned()
    yield
    ops.set_tuned()
    jops.set_tuned()


@pytest.fixture
def cache_env(tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    monkeypatch.setenv(autotune.CACHE_ENV, str(path))
    return path


# ---------------------------------------------------------------------------
# the reference's autotune tests, on the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_fit_and_candidates_match_reference(m, k, n):
    for block in (1, 7, 64, 96, 128, 256, 512):
        for dim in (m, k, n):
            assert _fit(block, dim) == jautotune._fit(block, dim)
    for bits in (None, 8, 4):
        cands = _tile_candidates(m, k, n, bits)
        assert cands == jautotune._tile_candidates(m, k, n, bits)
        for bm, bn, bk in cands:
            assert m % bm == 0 and n % bn == 0 and k % bk == 0
            assert bits != 4 or bk % 2 == 0
    assert len(_tile_candidates(256, 1024, 4096, None)) == 27


@given(st.integers(1, 1024), st.integers(1, 16384), st.integers(1, 16384),
       st.sampled_from([None, 8, 4]))
@example(256, 1024, 4096, None)       # gpt2_base's autotune shape
@example(256, 768, 3072, 8)
@example(256, 4096, 16384, None)      # gpt_j's
@settings(max_examples=200, deadline=None)
def test_candidates_are_distinct_launches(m, k, n, bits):
    """Every tile the sweep times selects its own launch on the card
    (output region, register tile, K stage), so no kernel is timed twice
    under two names."""
    cands = _tile_candidates(m, k, n, bits)
    launches = [cta_tile(*t) for t in cands]
    assert len(set(launches)) == len(cands)
    for (bm, bn, _), (rm, rn, tm, tn, kc) in zip(cands, launches):
        assert (rm, rn) == (bm, bn)
        assert tm in (64, 128) and tn in (64, 128) and kc in (8, 16, 32)


def test_cache_keys_roundtrip_and_versioning(tmp_path):
    for kw in (dict(arch="cpu", dtype="float32"),
               dict(arch="sm90", dtype="int4", page_size=16),
               dict(arch="cpu", dtype="float16", page_size=0)):
        for kernel in ("matmul", "quant_matmul8", "paged_decode"):
            assert (AutotuneCache.key(kernel, **kw)
                    == jautotune.AutotuneCache.key(kernel, **kw))
    assert AutotuneCache.key("matmul", arch="cpu", dtype="float32") == \
        "matmul|cpu|float32|page=-"
    path = tmp_path / "at.json"
    c = AutotuneCache(path)
    entry = {"block_m": 64, "block_n": 64, "block_k": 128, "t_us": 10.0}
    c.put("matmul", entry, arch="cpu", dtype="float32")
    c.save()
    again = AutotuneCache(path)
    assert again.get("matmul", arch="cpu", dtype="float32") == entry
    assert again.get("matmul", arch="sm90", dtype="float32") is None
    # the reference reads the port's file (one format and version) ...
    assert jautotune.AutotuneCache(path).entries == again.entries
    # ... and a version bump discards stale entries instead of misusing
    blob = json.loads(path.read_text())
    blob["version"] = autotune.VERSION + 1
    path.write_text(json.dumps(blob))
    assert AutotuneCache(path).entries == {}
    assert autotune.VERSION == jautotune.VERSION


def test_default_cache_path_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv(autotune.CACHE_ENV, raising=False)
    monkeypatch.delenv(jautotune.CACHE_ENV, raising=False)
    assert autotune.default_cache_path() != jautotune.default_cache_path()
    assert autotune.default_cache_path().parts[-2:] == ("repro_torch",
                                                       "autotune.json")
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "x.json"))
    assert autotune.default_cache_path() == tmp_path / "x.json"
    assert autotune.device_arch("cpu") == "cpu"


def test_entry_points_without_a_device_need_the_card(tmp_path, monkeypatch):
    """With no ``device`` every entry point tunes on the card, and without
    one it raises rather than timing the plain versions on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cache = AutotuneCache(tmp_path / "at.json")
    cfg = get_config("gpt2_base")
    calls = [lambda: autotune.device_arch(),
             lambda: autotune.tune_matmul(8, 64, 128, cache=cache, reps=1),
             lambda: autotune.tune_paged_decode(4, cache=cache, reps=1),
             lambda: autotune.tune_for_model(cfg, cache_path=tmp_path / "m",
                                             reps=1)]
    for call in calls:
        with pytest.raises(RuntimeError, match="is_available"):
            call()
    assert cache.entries == {} and not (tmp_path / "at.json").exists()
    assert autotune.device_arch("cpu") == "cpu"


def test_tune_matmul_caches_winner(tmp_path, monkeypatch):
    cache = AutotuneCache(tmp_path / "at.json")
    calls = {"n": 0}
    real = autotune._median_time

    def counting(fn, reps=3):
        calls["n"] += 1
        return real(fn, reps=1)
    monkeypatch.setattr(autotune, "_median_time", counting)
    entry = autotune.tune_matmul(8, 64, 128, cache=cache, reps=1,
                                 device="cpu")
    assert (entry["block_m"], entry["block_n"], entry["block_k"]) in \
        _tile_candidates(8, 64, 128, None)
    assert entry["shape"] == [8, 64, 128] and entry["t_us"] > 0
    assert calls["n"] == len(_tile_candidates(8, 64, 128, None))
    assert (tmp_path / "at.json").exists()
    # second call: served from the cache, no timing sweep
    calls["n"] = 0
    hit = autotune.tune_matmul(8, 64, 128, cache=cache, reps=1,
                               device="cpu")
    assert hit == entry and calls["n"] == 0
    # force re-runs the sweep
    autotune.tune_matmul(8, 64, 128, cache=cache, reps=1, force=True,
                         device="cpu")
    assert calls["n"] > 0


def test_tune_quant_matmul_int4(tmp_path):
    cache = AutotuneCache(tmp_path / "at.json")
    entry = autotune.tune_matmul(8, 64, 64, bits=4, dtype="int4",
                                 cache=cache, reps=1, device="cpu")
    assert min(entry["block_k"], 64) % 2 == 0
    assert cache.get("quant_matmul4", arch="cpu", dtype="int4") == entry


def test_tune_paged_decode_picks_a_route(tmp_path):
    cache = AutotuneCache(tmp_path / "at.json")
    entry = autotune.tune_paged_decode(4, kv_heads=2, groups=2,
                                       head_dim=8, cache=cache, reps=1,
                                       device="cpu")
    assert entry["impl"] in ("paged", "gather")
    assert entry["t_us"] <= entry["t_us_other"]
    assert cache.get("paged_decode", arch="cpu", dtype="float32",
                     page_size=4) == entry


@pytest.mark.parametrize("tuned", [None,
                                   {"block_m": 64, "block_n": 128,
                                    "block_k": 256},
                                   {"block_m": 7, "block_n": 30,
                                    "block_k": 70}])
@pytest.mark.parametrize("m,k,n", SHAPES + [(256, 512, 256)])
@pytest.mark.parametrize("explicit", [(None, None, None), (32, None, None),
                                      (None, None, 64)])
def test_resolve_tiles_matches_reference(tuned, m, k, n, explicit):
    ops.set_tuned(matmul=tuned, quant_matmul=tuned)
    jops.set_tuned(matmul=tuned, quant_matmul=tuned)
    for kernel in ("matmul", "quant_matmul"):
        assert (ops._resolve_tiles(kernel, m, k, n, *explicit)
                == jops._resolve_tiles(kernel, m, k, n, *explicit))
    assert ops._DEFAULT_TILES == jops._DEFAULT_TILES


def test_apply_tuning_drives_paged_route(monkeypatch):
    """A selection installs the tiles and the paged route; "auto" keeps
    its device rule (the kernels on the card, the plain versions on the
    CPU), and ``ops.paged_decode`` follows the tuned route when the call
    names none."""
    routes = []
    monkeypatch.setattr(ops, "decode_gqa",
                        lambda *a: routes.append("gather") or a[0])
    monkeypatch.setattr(ref, "paged_decode_ref",
                        lambda *a: routes.append("paged") or a[0])
    args = (torch.zeros(1, 1, 1, 4), torch.zeros(2, 4, 1, 4),
            torch.zeros(2, 4, 1, 4), torch.zeros(1, 2, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32))
    autotune.apply_tuning({"matmul": {"block_m": 64, "block_n": 64,
                                      "block_k": 128},
                           "paged_decode": {"impl": "paged"}})
    assert ops.tuned_paged_impl() == "paged"
    assert ops._TUNED["matmul"]["block_k"] == 128
    ops.paged_decode(*args)
    autotune.apply_tuning({"paged_decode": {"impl": "gather"}})
    assert ops.tuned_paged_impl() == "gather"
    assert ops._TUNED["matmul"] is None
    ops.paged_decode(*args)
    ops.paged_decode(*args, impl="paged")     # an explicit route wins
    # tuned or not, "auto" follows the device and None stays plain
    assert resolve_attn_impl("auto", "cpu") is None
    assert resolve_attn_impl("auto", "cuda") == "cuda"
    assert resolve_attn_impl(None, "cuda") is None
    autotune.apply_tuning({})
    assert ops.tuned_paged_impl() is None
    assert resolve_attn_impl("auto", "cpu") is None
    ops.paged_decode(*args)                   # untuned: the block tables
    assert routes == ["paged", "gather", "paged", "paged"]
    with pytest.raises(ValueError, match="unknown paged impl"):
        ops.set_tuned(paged_impl="pallas")


def test_tune_for_model_seeds_and_applies(tmp_path):
    cfg = get_config("gpt2_base").with_(d_model=64, d_ff=128, n_heads=2,
                                        n_kv_heads=2, head_dim=8)
    profile = {"ckpt_dtype": "float32", "layer_t_comp": 0.01,
               "layer_t_load": 0.02}
    out = autotune.tune_for_model(cfg, profile, page_size=4,
                                  cache_path=tmp_path / "at.json",
                                  tokens=8, reps=1, device="cpu")
    assert out["arch"] == "cpu" and out["dtype"] == "float32"
    assert out["matmul"]["seed"] == {"layer_t_comp": 0.01,
                                     "layer_t_load": 0.02}
    assert out["matmul"]["shape"] == [8, 64, 128]
    assert out["paged_decode"]["impl"] in ("paged", "gather")
    assert ops._TUNED["matmul"] is not None                 # applied
    assert ops.tuned_paged_impl() == out["paged_decode"]["impl"]
    blob = json.loads((tmp_path / "at.json").read_text())
    key = AutotuneCache.key("matmul", arch="cpu", dtype="float32")
    assert blob["entries"][key]["seed"]["layer_t_load"] == 0.02


# ---------------------------------------------------------------------------
# ops.matmul on the CPU vs the Pallas streamed matmul (interpret mode)
# ---------------------------------------------------------------------------
def _pair(rng, shape, dtype):
    a = rng.standard_normal(shape).astype(np.float32)
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,bm,bn,bk", [
    (128, 128, 128, 128, 128, 128),     # single tile
    (256, 512, 128, 128, 128, 128),     # multi-tile K streaming
    (384, 256, 512, 128, 256, 256),     # uneven grid
])
def test_matmul_matches_pallas_interpret(m, k, n, bm, bn, bk, dtype):
    rng = np.random.default_rng(m + n + k)
    jx, tx = _pair(rng, (m, k), dtype)
    jw, tw = _pair(rng, (k, n), dtype)
    want = jops.matmul(jx, jw, block_m=bm, block_n=bn, block_k=bk)
    got = ops.matmul(tx, tw, block_m=bm, block_n=bn, block_k=bk)
    assert got.dtype == tx.dtype and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=ATOL[dtype] * np.sqrt(k), rtol=1e-2)
    np.testing.assert_array_equal(got.float().numpy(),
                                  ref.matmul_ref(tx, tw).float().numpy())


@settings(max_examples=12, deadline=None)
@given(mi=st.integers(1, 3), ki=st.integers(1, 4), ni=st.integers(1, 3),
       seed=st.integers(0, 2**30))
def test_matmul_property(mi, ki, ni, seed):
    m, k, n = 64 * mi, 64 * ki, 64 * ni
    rng = np.random.default_rng(seed)
    jx, tx = _pair(rng, (m, k), "float32")
    jw, tw = _pair(rng, (k, n), "float32")
    got = ops.matmul(tx, tw, block_m=64, block_n=64, block_k=64)
    want = jops.matmul(jx, jw, block_m=64, block_n=64, block_k=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                               rtol=1e-3)


@pytest.mark.parametrize("shape,tiles", [
    ((100, 70, 30), dict(block_m=64)),
    ((128, 128, 96), dict(block_n=64)),
    ((64, 96, 64), dict(block_k=64)),
    ((100, 70, 30), {})])                # the defaults clamp and divide
def test_matmul_divisibility_matches_reference(shape, tiles):
    m, k, n = shape
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng, (m, k), "float32")
    jw, tw = _pair(rng, (k, n), "float32")
    if not tiles:
        np.testing.assert_allclose(ops.matmul(tx, tw).numpy(),
                                   np.asarray(jops.matmul(jx, jw)),
                                   atol=1e-4, rtol=1e-4)
        return
    with pytest.raises(AssertionError):
        jops.matmul(jx, jw, **tiles)
    with pytest.raises(ValueError, match="do not divide"):
        ops.matmul(tx, tw, **tiles)


def test_tuned_tile_that_does_not_divide_falls_back():
    """Tuning never breaks a call: a tuned tile that does not divide the
    shape falls back to the defaults, in both packages."""
    tile = {"block_m": 64, "block_n": 64, "block_k": 128}
    ops.set_tuned(matmul=tile)
    jops.set_tuned(matmul=tile)
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng, (100, 70), "float32")
    jw, tw = _pair(rng, (70, 30), "float32")
    np.testing.assert_allclose(ops.matmul(tx, tw).numpy(),
                               np.asarray(jops.matmul(jx, jw)), atol=1e-4,
                               rtol=1e-4)


def test_quant_matmul_explicit_tiles_follow_the_contract():
    """Tiles a caller passes to ``quant_matmul`` are held to the
    reference's contract where the reference raises (a tile that does not
    divide; int4 with an odd block_k even after the default's fallback);
    without tiles any shape is taken, as the serving path needs."""
    scale = np.ones(30, np.float32)
    w8 = np.ones((70, 30), np.int8)
    x = np.ones((100, 70), np.float32)
    args = lambda *a: [torch.from_numpy(v) for v in a]  # noqa: E731
    jargs = lambda *a: [jnp.asarray(v) for v in a]  # noqa: E731
    with pytest.raises(AssertionError):
        jops.quant_matmul(*jargs(x, w8, scale), bits=8, block_m=64)
    with pytest.raises(ValueError, match="do not divide"):
        ops.quant_matmul(*args(x, w8, scale), 8, block_m=64)
    torch.testing.assert_close(ops.quant_matmul(*args(x, w8, scale), 8),
                               torch.full((100, 30), 70.0))
    # int4, K = 70: an odd block_k falls back to the default in both
    w4 = np.zeros((35, 30), np.uint8)
    np.testing.assert_array_equal(
        ops.quant_matmul(*args(x, w4, scale), 4, block_k=35).numpy(),
        np.asarray(jops.quant_matmul(*jargs(x, w4, scale), bits=4,
                                     block_k=35)))
    # int4, K = 35: no even block_k tiles it, so both raise
    x35, w18 = np.ones((100, 35), np.float32), np.zeros((18, 30), np.uint8)
    with pytest.raises(AssertionError):
        jops.quant_matmul(*jargs(x35, w18, scale), bits=4, block_k=35)
    with pytest.raises(ValueError, match="even block_k"):
        ops.quant_matmul(*args(x35, w18, scale), 4, block_k=35)


# ---------------------------------------------------------------------------
# the tuned paged route on the serving path (CPU: plain versions)
# ---------------------------------------------------------------------------
def test_gather_route_matches_paged_reference():
    rng = np.random.default_rng(5)
    b, kv, g, dh, page, nb = 3, 2, 2, 16, 4, 5
    q = torch.from_numpy(rng.standard_normal((b, kv, g, dh)).astype(
        np.float32))
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (b * nb + 1, page, kv, dh)).astype(np.float32)) for _ in range(2))
    tables = torch.from_numpy(rng.permutation(b * nb + 1)[:b * nb].reshape(
        b, nb).astype(np.int32))
    lengths = torch.tensor([1, 11, 20], dtype=torch.int32)
    want = ref.paged_decode_ref(q, kp, vp, tables, lengths)
    for impl in ("paged", "gather"):
        torch.testing.assert_close(
            ops.paged_decode(q, kp, vp, tables, lengths, impl=impl), want,
            atol=1e-5, rtol=1e-5)
    ops.set_tuned(paged_impl="gather")
    launches = dict(ops.LAUNCHES)
    torch.testing.assert_close(ops.paged_decode(q, kp, vp, tables, lengths),
                               want, atol=1e-5, rtol=1e-5)
    assert ops.LAUNCHES == launches           # CPU: plain versions


def test_serve_cli_autotune_on_cpu(tmp_path, monkeypatch, capsys,
                                   cache_env):
    """``--autotune`` tunes for the planner's winning dtype and page size,
    prints the selection, and a repeat serve hits the cache (no sweep);
    the tokens are those of an untuned serve."""
    monkeypatch.setattr(serve, "CKPT_ROOT", tmp_path)
    args = ["--device", "cpu", "--requests", "3", "--prompt-len", "16",
            "--new-tokens", "3", "--max-inflight", "3", "--budget-mb", "10",
            "--seed", "4", "--page-size", "4", "--shared-prefix", "12"]
    calls = {"n": 0}
    real = autotune._median_time

    def counting(fn, reps=3):
        calls["n"] += 1
        return real(fn, reps=1)
    monkeypatch.setattr(autotune, "_median_time", counting)
    outs, stats = serve.run("gpt2_base", budget_mb=10, requests=3,
                            prompt_len=16, new_tokens=3, max_inflight=3,
                            seed=4, page_size=4, shared_prefix=12,
                            device="cpu", autotune=True)
    out = capsys.readouterr().out
    m = re.search(r"autotune\(cpu\): matmul tiles (\d+)x(\d+)x(\d+), "
                  r"paged impl (paged|gather)", out)
    assert m, out
    n_cands = len(_tile_candidates(256, 256, 512, None))
    assert calls["n"] == n_cands + 2          # matmul tiles + two routes
    blob = json.loads(cache_env.read_text())
    assert set(blob["entries"]) == {"matmul|cpu|float32|page=-",
                                    "paged_decode|cpu|float32|page=4"}
    assert blob["entries"]["matmul|cpu|float32|page=-"]["seed"][
        "layer_t_comp"] > 0
    assert stats.page_size == 4
    assert stats.kernel_launches == dict.fromkeys(stats.kernel_launches, 0)
    calls["n"] = 0
    ops.set_tuned()
    serve.main(args + ["--autotune"])
    assert calls["n"] == 0                    # served from the cache
    assert "autotune(cpu)" in capsys.readouterr().out
    ops.set_tuned()
    plain, _ = serve.run("gpt2_base", budget_mb=10, requests=3,
                         prompt_len=16, new_tokens=3, max_inflight=3,
                         seed=4, page_size=4, shared_prefix=12,
                         device="cpu")
    for rid, toks in outs.items():
        np.testing.assert_array_equal(toks, plain[rid])


def test_hermes_scheduler_autotunes_after_planning(tmp_path, cache_env):
    """``Hermes.scheduler(autotune=True)`` tunes for the winning page size
    after planning, seeded by this checkpoint's profile, and serves."""
    from repro_torch.configs import get
    from repro_torch.core import Hermes
    cfg = get("gpt2_base").reduced().with_(num_layers=2)
    path = serve.ensure_checkpoint(cfg, root=tmp_path)
    hermes = Hermes(path, cfg, device="cpu")
    sched = hermes.scheduler(budget_bytes=10 * 2**20, max_inflight=2,
                             prompt_len=16, new_tokens=2, page_sizes=(4,),
                             shared_prefix_len=12, autotune=True)
    blob = json.loads(cache_env.read_text())["entries"]
    mat = blob["matmul|cpu|float32|page=-"]
    assert mat["shape"] == [256, cfg.d_model, cfg.d_ff]
    assert mat["seed"]["layer_t_load"] == hermes.profile()["layer_t_load"]
    if sched.page_size:
        assert f"paged_decode|cpu|float32|page={sched.page_size}" in blob
        assert ops.tuned_paged_impl() in ("paged", "gather")
    rng = np.random.default_rng(0)
    for _ in range(2):
        sched.submit(rng.integers(0, cfg.vocab_size, (16,)), 2)
    outs, _ = sched.run()
    sched.close()
    assert [len(o) for o in outs.values()] == [18, 18]
