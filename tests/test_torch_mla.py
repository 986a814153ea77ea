"""The port's MLA (multi-head latent attention) family against the JAX
package's: ``mla_prefill`` / ``mla_decode`` on the same weights, the
latent cache's widths, the MLA branches of the expert-streaming MoE
router fns, shards member for member, and continuous batching (dense and
paged, the latent {c, kr} leaves paged through the gather path) with
identical tokens and ledger peaks to the byte; ``mla_decode`` on int8 /
int4 shards against the reference's dequantized decode; plus the serve
CLI (``--quant`` against the JAX CLI's tokens and ledger peak) and the
refusals MLA keeps (speculation, chunked prefill).  fp32,
reduced configs, within 1e-5."""
import json
import re
import shutil

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
from repro.core.engine import DraftModel as JaxDraft
from repro.core.modules import build_module_fns as jax_fns
from repro.launch import serve as jax_serve
from repro.models import attention as jattn
from repro.models.dense_lm import init_params as jax_init
from repro_torch.checkpoint import partition as tp
from repro_torch.configs import get as torch_get
from repro_torch.core import BatchScheduler, Hermes, PipeloadEngine
from repro_torch.core.engine import DraftModel
from repro_torch.core.modules import build_module_fns as torch_fns
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import dense_lm

TOL = dict(atol=1e-5, rtol=1e-5)
# reduced minicpm3_4b as tests/test_kv_pages.py cuts it: qk 48 (32 nope +
# 16 rope), v 32, latent 32
GEOM = dict(num_layers=2, vocab_size=300, vocab_pad_to=4)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


@pytest.fixture(scope="module")
def mla():
    jcfg = get_config("minicpm3_4b").reduced()
    tcfg = torch_get("minicpm3_4b").reduced()
    params = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(7), jcfg))
    return jcfg, tcfg, params, tp.from_jax_params(params, device="cpu")


def test_mla_prefill_and_decode_match_jax(mla):
    """Prefill with the cache, then decode at one slot for the batch and
    at RAGGED per-row slots: outputs and the latent cache."""
    jcfg, tcfg, params, tparams = mla
    jp, tpp = _layer(params["layers"], 0)["attn"], \
        _layer(tparams["layers"], 0)["attn"]
    rng = np.random.default_rng(3)
    b, s, total = 3, 11, 16
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (b, s)).copy()
    jy, jc = jattn.mla_prefill(jp, jnp.asarray(x), jcfg, None,
                               jnp.asarray(pos))
    ty, tc = tattn.mla_prefill(tpp, torch.from_numpy(x), tcfg,
                               torch.as_tensor(pos))
    _close(ty, jy)
    assert set(tc) == set(jc) == {"c", "kr"}
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape
        _close(tc[key], jc[key])
    jc = {k: jnp.pad(a, ((0, 0), (0, total - s), (0, 0)))
          for k, a in jc.items()}
    tc = {k: torch.nn.functional.pad(a, (0, 0, 0, total - s))
          for k, a in tc.items()}
    for p in (s, np.asarray([s + 1, 4, 14])):
        x1 = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
        jy1, jc = jattn.mla_decode(jp, jnp.asarray(x1), jcfg, None, jc,
                                   jnp.asarray(p, jnp.int32))
        ty1, tc = tattn.mla_decode(tpp, torch.from_numpy(x1), tcfg, tc,
                                   p if np.ndim(p) == 0 else
                                   torch.as_tensor(p))
        _close(ty1, jy1)
        for key in jc:
            _close(tc[key], jc[key])


@pytest.mark.parametrize("arch,cut", [("minicpm3_4b", False),
                                      ("minicpm3_4b", True)])
def test_latent_cache_widths_match_reference(arch, cut):
    """288 features per token per layer at full width (576 B in fp16), and
    ``cache_bytes`` equal to the reference's at every shape."""
    jcfg, tcfg = get_config(arch), torch_get(arch)
    if cut:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    assert tcfg.kv_cache_dim == jcfg.kv_cache_dim
    assert tcfg.kv_cache_dim == tcfg.kv_lora_rank + tcfg.rope_head_dim
    for b, s in ((1, 1), (2, 40), (4, 72)):
        assert tcfg.cache_bytes(b, s) == jcfg.cache_bytes(b, s)
    if not cut:
        assert tcfg.kv_cache_dim == 288
        assert tcfg.with_(dtype="float16").cache_bytes(1, 1) == 576
    cache = tattn.empty_cache(tcfg, 2, 5)
    want = jattn.mla_empty_cache(jcfg, 2, 5)
    assert {k: tuple(a.shape) for k, a in cache.items()} == {
        k: a.shape for k, a in want.items()}


def test_mla_init_matches_reference_shapes():
    """The port's numpy init draws every MLA weight at the reference's
    shape and scale (1 / sqrt(fan_in)), at full width."""
    jcfg = get_config("minicpm3_4b").with_(dtype="float32")
    tcfg = torch_get("minicpm3_4b").with_(dtype="float32")
    want = jax.eval_shape(lambda k: jattn.mla_init(k, jcfg),
                          jax.random.PRNGKey(0))
    got = tattn.mla_init(np.random.default_rng(0), tcfg)
    assert sorted(got) == sorted(want)
    for k, a in got.items():
        assert (a.shape, a.dtype) == (want[k].shape, want[k].dtype), k
        if a.ndim == 2:
            assert abs(a.std() * np.sqrt(a.shape[0]) - 1) < 0.02, k
        else:
            np.testing.assert_array_equal(a, 1)
    tree = dense_lm.init_params(np.random.default_rng(0),
                                torch_get("minicpm3_4b").reduced())
    ref = jax_init(jax.random.PRNGKey(0), get_config("minicpm3_4b").reduced())
    assert jax.tree.structure(tree) == jax.tree.structure(ref)
    for a, r in zip(jax.tree.leaves(tree), jax.tree.leaves(ref)):
        assert a.shape == r.shape and a.dtype == r.dtype


def test_mla_moe_router_fns_match_jax():
    """The MLA branches of the expert-streaming router fns (a reduced MoE
    config with MLA attention; no public config runs them)."""
    jcfg = get_config("qwen3_moe_30b_a3b").reduced().with_(attention="mla")
    tcfg = torch_get("qwen3_moe_30b_a3b").reduced().with_(attention="mla")
    params = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(2), jcfg))
    jw = _layer(params["layers"], 0)
    tw = _layer(tp.from_jax_params(params, device="cpu")["layers"], 0)
    jf, tf = jax_fns(jcfg, attn_impl=None), torch_fns(tcfg, device="cpu")
    rng = np.random.default_rng(4)
    b, s, total = 2, 7, 12
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    for j, t in zip(jf["moe_router"](jw, jnp.asarray(x)),
                    tf["moe_router"](tw, torch.from_numpy(x))):
        _close(t, j)
    jout = jf["moe_router_cache"](jw, jnp.asarray(x), total)
    tout = tf["moe_router_cache"](tw, torch.from_numpy(x), total)
    jc, tc = jout[1], tout[1]
    assert set(tc) == set(jc) == {"c", "kr"}
    for j, t in zip(jout[:1] + jout[2:], tout[:1] + tout[2:]):
        _close(t, j)
    x1 = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
    pos = np.asarray([s, 3])
    jout = jf["moe_router_decode"](jw, jnp.asarray(x1), jc,
                                   jnp.asarray(pos, jnp.int32))
    tout = tf["moe_router_decode"](tw, torch.from_numpy(x1), tc,
                                   torch.as_tensor(pos))
    for key in jc:
        _close(tout[1][key], jout[1][key])
    for j, t in zip(jout[:1] + jout[2:], tout[:1] + tout[2:]):
        _close(t, j)


# ---------------------------------------------------------------------------
# shards and serving on one checkpoint the JAX package wrote
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mla_ckpt(tmp_path_factory):
    jcfg = get_config("minicpm3_4b").reduced().with_(**GEOM)
    tcfg = torch_get("minicpm3_4b").reduced().with_(**GEOM)
    params = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0), jcfg))
    path = tmp_path_factory.mktemp("mla") / "mla"
    partition_and_save(params, jcfg, path)
    return jcfg, tcfg, params, path


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_mla_shards_match_jax(mla_ckpt, tmp_path):
    """The port's writer on the same weights: the JAX package's manifest to
    the byte and every npz member equal."""
    _, tcfg, params, path = mla_ckpt
    got = tp.partition_and_save(tp.from_jax_params(params, device="cpu"),
                                tcfg, tmp_path)
    want = load_manifest(path)
    assert got == want
    assert json.loads((tmp_path / "manifest.json").read_text()) == want
    for name in tp.shard_names(want):
        a, b = _npz(tmp_path / f"{name}.npz"), _npz(path / f"{name}.npz")
        assert sorted(a) == sorted(b)
        for key in b:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key])
    layer = tp.load_shard(tmp_path, "layer_000")["attn"]
    assert sorted(layer) == sorted(jattn.mla_init(jax.random.PRNGKey(0),
                                                  mla_ckpt[0]))


def _serve(cls_eng, cls_sched, path, cfg, prompts, news, **ek):
    eng_kw = dict(mode="pipeload", num_agents=2, pin_window=0)
    eng_kw.update(ek)
    if cls_eng is PipeloadEngine:
        eng_kw["device"] = "cpu"
    sched = cls_sched(cls_eng(path, cfg, **eng_kw), max_inflight=3,
                      max_total_len=16)
    rids = [sched.submit(p, n) for p, n in zip(prompts, news)]
    outs, stats = sched.run()
    sched.close()
    return [np.asarray(outs[r]) for r in rids], stats


@pytest.mark.parametrize("page_size", [None, 4])
def test_mla_scheduler_matches_jax(mla_ckpt, page_size):
    """Dense and paged (page 4, the prompts' first 8 tokens shared): the
    same tokens, rounds, page counters and ledger peak as the JAX
    package's scheduler, and paged tokens equal to dense ones (as
    ``tests/test_kv_pages.py::test_paged_equals_dense_mla``)."""
    jcfg, tcfg, _, path = mla_ckpt
    rng = np.random.default_rng(12)
    shared = rng.integers(0, 300, (8,))
    prompts = [np.concatenate([shared, rng.integers(0, 300, (n,))])
               for n in (2, 3, 1)]
    news = [3, 4, 2]
    jt, jst = _serve(JaxEngine, JaxScheduler, path, jcfg, prompts, news,
                     page_size=page_size)
    tt, tst = _serve(PipeloadEngine, BatchScheduler, path, tcfg, prompts,
                     news, page_size=page_size)
    for t, j in zip(tt, jt):
        np.testing.assert_array_equal(t, j)
    for f in ("peak_bytes", "rounds", "cache_bytes_peak", "pages_allocated",
              "prefix_hit_pages", "cow_copies", "pool_pages_peak"):
        assert getattr(tst, f) == getattr(jst, f), f
    assert tst.peak_breakdown == jst.peak_breakdown
    if page_size:
        assert tst.prefix_hit_pages > 0
        dense, _ = _serve(PipeloadEngine, BatchScheduler, path, tcfg,
                          prompts, news)
        for a, b in zip(tt, dense):
            np.testing.assert_array_equal(a, b)


def test_mla_pools_hold_latent_leaves(mla_ckpt):
    """Paged MLA: one {c, kr} pool per layer, (rows, page, kv_lora_rank) and
    (rows, page, rope_head_dim), whose bytes are the ledger's kv_pages
    charge at its peak; no verify path, so speculation and chunked
    prefill are refused with the reference's words."""
    jcfg, tcfg, _, path = mla_ckpt
    eng = PipeloadEngine(path, tcfg, device="cpu", page_size=4)
    assert "layer_verify_paged" not in eng.fns
    sched = BatchScheduler(eng, max_inflight=2, max_total_len=16)
    sched.submit(np.arange(6), 3)
    _, stats = sched.run()
    shapes = {k: tuple(a.shape[2:]) for k, a in
              next(iter(sched._pools.values())).items()}
    assert shapes == {"c": (tcfg.kv_lora_rank,),
                      "kr": (tcfg.rope_head_dim,)}
    assert sum(a.nbytes for c in sched._pools.values()
               for a in c.values()) == stats.cache_bytes_peak
    sched.close()
    for kw in (dict(chunk_prefill=8), dict(spec_depth=2)):
        msgs = []
        for eng_cls, sched_cls, cfg in (
                (JaxEngine, JaxScheduler, jcfg),
                (PipeloadEngine, BatchScheduler, tcfg)):
            ek = {"device": "cpu"} if eng_cls is PipeloadEngine else {}
            e = eng_cls(path, cfg, page_size=4, **ek)
            extra = dict(kw)
            if "spec_depth" in kw:
                draft = (DraftModel(path, cfg, device="cpu")
                         if eng_cls is PipeloadEngine
                         else JaxDraft(path, cfg))
                extra["draft"] = draft
            with pytest.raises(ValueError) as err:
                sched_cls(e, page_size=4, **extra)
            msgs.append(str(err.value))
            e.close()
        assert msgs[0] == msgs[1]
        assert "lack layer_verify_paged" in msgs[1]


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("flags", [[], ["--page-size", "4",
                                        "--shared-prefix", "12"]])
def test_serve_cli_mla_on_cpu(tmp_path, monkeypatch, capsys, flags):
    monkeypatch.setattr(serve, "CKPT_ROOT", tmp_path)
    serve.main(["--device", "cpu", "--arch", "minicpm3_4b", "--requests",
                "3", "--prompt-len", "16", "--new-tokens", "3",
                "--max-inflight", "3", "--budget-mb", "10"] + flags)
    out = capsys.readouterr().out
    assert re.search(r"served 3 reqs x 3 tokens in \d+ rounds", out)
    if flags:
        assert "page size 4" in out
        assert int(re.search(r"prefix_hit_pages\s+(\d+)", out).group(1)) > 0


def serve_both(root, monkeypatch, **kw):
    """Serve one seeded reduced-minicpm3_4b workload through the JAX
    package's ``serve.run`` and then the port's on the CPU, the port on
    the checkpoints the JAX CLI wrote (its quantized siblings included)
    and its measured profile, so both planners see the same inputs:
    ((jax outs, stats), (port outs, stats))."""
    jroot, troot = root / "jax", root / "torch"
    monkeypatch.setattr(jax_serve, "CKPT_ROOT", jroot)
    want = jax_serve.run("minicpm3_4b", **kw)
    troot.mkdir()
    for d in jroot.iterdir():
        shutil.copytree(d, troot / d.name)
        if (d / "profile.json").exists():
            shutil.copy(d / "profile.json",
                        troot / d.name / "profile_torch_cpu.json")
    return want, serve.run("minicpm3_4b", device="cpu", ckpt_root=troot,
                           **kw)


def assert_same_serving(want, got) -> None:
    """The same tokens per request and the same ledger peak."""
    (jouts, jstats), (touts, tstats) = want, got
    assert sorted(touts) == sorted(jouts)
    for rid in jouts:
        assert list(map(int, touts[rid])) == list(map(int, jouts[rid])), rid
    assert tstats.peak_bytes == jstats.peak_bytes


QUANT_SERVE = dict(requests=2, prompt_len=16, new_tokens=3, max_inflight=2,
                   budget_mb=10)
PAGED = dict(page_size=4, shared_prefix=12)


@pytest.mark.parametrize("paged", [False, True])
def test_serve_cli_mla_int8_matches_jax_cli(tmp_path, monkeypatch, paged):
    """``serve --arch minicpm3_4b --quant int8``, dense and paged: the JAX
    CLI's tokens and ledger peak on its checkpoint, transcode and
    profile."""
    want, got = serve_both(tmp_path, monkeypatch, quant="int8",
                           **QUANT_SERVE, **(PAGED if paged else {}))
    assert_same_serving(want, got)
    assert got[1].page_size == (4 if paged else 0)
    assert (tmp_path / "torch" / "minicpm3-4b-smoke-int8").is_dir()


@pytest.mark.parametrize("quant", ["int4", "auto"])
def test_serve_cli_mla_quant_exits_before_writing(quant, tmp_path,
                                                  monkeypatch, capsys):
    """``serve --quant int4|auto`` with MLA attention, once refused, now
    serves: dense and paged, the tokens and ledger peak of the JAX
    package's CLI on the same checkpoints and profile; both planners name
    the same dtype.  ``auto`` runs under 2.5 MB, which one fp32 layer
    (1.8 MB) beside the fp32 embed and head (1 MB) does not fit, so its
    pick is a quantized dtype whatever the profile's timings."""
    kw = dict(QUANT_SERVE, budget_mb=2.5) if quant == "auto" else QUANT_SERVE
    for page in ({}, PAGED):
        want, got = serve_both(tmp_path / f"p{len(page)}", monkeypatch,
                               quant=quant, **kw, **page)
        assert_same_serving(want, got)
        assert got[1].page_size == (4 if page else 0)
        dtypes = re.findall(r"planner\(serve\): .*dtype=(\w+)",
                            capsys.readouterr().out)
        assert len(dtypes) == 2 and dtypes[0] == dtypes[1]
        assert dtypes[0] == quant if quant != "auto" else dtypes[0] in (
            "int8", "int4")


def test_mla_decode_on_quantized_shards_matches_reference():
    """``mla_decode`` on int8 / int4 ``QuantizedTensor`` leaves (the
    absorbed W_uk / W_uv through the batched quantized matmul's plain
    version, the kernel route on CPU tensors included) against the
    reference's ``mla_decode`` on the same weights dequantized, at one
    slot and at ragged slots."""
    from repro.checkpoint import quant as jqz
    from repro_torch.checkpoint import quant as qz
    from repro_torch.models.attention import KERNEL
    jcfg = get_config("minicpm3_4b").reduced()
    tcfg = torch_get("minicpm3_4b").reduced()
    params = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(5), jcfg))
    attn_p = _layer(params["layers"], 0)["attn"]
    rng = np.random.default_rng(6)
    b, total = 3, 12
    c = rng.standard_normal((b, total, jcfg.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((b, total, jcfg.rope_head_dim)).astype(
        np.float32)
    for quant in ("int8", "int4"):
        jp = {k: (jqz.quantize_array(a, quant).dequantize()
                  if a.ndim == 2 else jnp.asarray(a))
              for k, a in attn_p.items()}
        tpp = {k: (qz.quantize_array(a, quant) if a.ndim == 2
                   else torch.from_numpy(np.array(a)))
               for k, a in attn_p.items()}
        assert isinstance(tpp["w_uk"], qz.QuantizedTensor)
        for pos in (7, np.asarray([9, 3, 11])):
            x = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
            jy, jc = jattn.mla_decode(jp, jnp.asarray(x), jcfg, None,
                                      {"c": jnp.asarray(c),
                                       "kr": jnp.asarray(kr)},
                                      jnp.asarray(pos, jnp.int32))
            tpos = pos if np.ndim(pos) == 0 else torch.as_tensor(pos)
            for impl in (None, KERNEL):
                cache = {"c": torch.from_numpy(c.copy()),
                         "kr": torch.from_numpy(kr.copy())}
                ty, tc = tattn.mla_decode(tpp, torch.from_numpy(x), tcfg,
                                          cache, tpos, attn_impl=impl)
                _close(ty, jy)
                for key in jc:
                    _close(tc[key], jc[key])


def test_hermes_facade_mla_matches_jax(mla_ckpt, tmp_path):
    """profile -> plan_generate(page_sizes) -> engine -> scheduler, both
    packages planning from one measured profile of the MLA checkpoint: the
    same plan (agents, pin, in-flight count, page size, predicted peak and
    KV bytes), then the same tokens, page counters and ledger peak."""
    jcfg, tcfg, _, path = mla_ckpt
    local = tmp_path / "ckpt"
    shutil.copytree(path, local)
    jh = JaxHermes(local, jcfg)
    jh.profile(batch=1, seq=8, force=True)
    shutil.copy(local / "profile.json", local / "profile_torch_cpu.json")
    th = Hermes(local, tcfg, device="cpu")
    man = load_manifest(local)
    budget = (man["total_bytes"] - man["layer_bytes"]
              + man["layer_bytes"] // jcfg.num_layers + 2**16)
    plan_kw = dict(prompt_len=12, new_tokens=4, max_inflight=3,
                   page_sizes=(4,), shared_prefix_len=8)
    jp, tp_ = (h.plan_generate([budget], **plan_kw)[0] for h in (jh, th))
    for f in ("num_agents", "pin_window", "inflight", "page_size",
              "predicted_peak_bytes", "cache_bytes", "feasible"):
        assert getattr(tp_, f) == getattr(jp, f), f
    kw = dict(budget_bytes=budget, max_inflight=3, prompt_len=12,
              new_tokens=4, page_sizes=(4,), shared_prefix_len=8, seed=3)
    shared = np.random.default_rng(8).integers(0, 300, (8,))
    prompts = [np.concatenate([shared, [i, i + 1, i + 2, i + 3]])
               for i in range(3)]
    outs = []
    for sched in (jh.scheduler(**kw), th.scheduler(**kw)):
        rids = [sched.submit(p, 4) for p in prompts]
        o, st = sched.run()
        sched.close()
        outs.append(([np.asarray(o[r]) for r in rids], st))
    (jt, jst), (tt, tst) = outs
    for t, j in zip(tt, jt):
        np.testing.assert_array_equal(t, j)
    for f in ("peak_bytes", "page_size", "prefix_hit_pages", "rounds",
              "cache_bytes_peak"):
        assert getattr(tst, f) == getattr(jst, f), f
