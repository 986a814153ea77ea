"""The port's quantized weight streaming against the JAX package's
(``tests/test_quant.py``): the int8/int4 shard format bit for bit, the
dequantizing matmul's plain version against the Pallas kernel (interpret
mode), and generation, batch rounds, planning and the serve CLI over int8
and int4 shards, on one checkpoint the JAX package wrote."""
import json
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_manifest, load_shard, partition_and_save
from repro.checkpoint import partition as jax_partition
from repro.checkpoint import quant as jqz
from repro.configs import get_config
from repro.core import BatchScheduler as JaxScheduler
from repro.core import Hermes as JaxHermes
from repro.core import PipeloadEngine as JaxEngine
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.dense_lm import init_params as jax_init
from repro_torch.checkpoint import partition as tp
from repro_torch.checkpoint import quant as qz
from repro_torch.configs import get as torch_get
from repro_torch.core import BatchScheduler, Hermes, PipeloadEngine
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve

TOL = dict(atol=1e-5, rtol=1e-5)
# documented int8 logit tolerance (docs/quantization.md): max |delta|
# relative to the largest fp32 logit magnitude
INT8_LOGIT_RTOL = 0.05
# the reference's gpt2q geometry (tests/test_quant.py)
GEOM = dict(num_layers=6, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
            d_ff=1024, vocab_size=1000, vocab_pad_to=8, remat=False)
QUANTS = ("int8", "int4")


@pytest.fixture(scope="module")
def gpt2q(tmp_path_factory):
    """fp32 checkpoint written by the JAX package, and its int8/int4
    transcodes by the JAX package's ``requantize``."""
    jcfg = get_config("gpt2_base").with_(**GEOM)
    tcfg = torch_get("gpt2_base").with_(**GEOM)
    root = tmp_path_factory.mktemp("qckpt")
    params = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0), jcfg))
    paths = {"fp32": root / "fp32"}
    partition_and_save(params, jcfg, paths["fp32"])
    for q in QUANTS:
        paths[q] = root / q
        jax_partition.requantize(paths["fp32"], paths[q], q)
    return jcfg, tcfg, params, paths


@pytest.fixture(scope="module")
def toks():
    return np.random.default_rng(1).integers(0, 1000, (2, 12))


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# the quantization scheme, bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("k,n,seed", [(64, 32, 0), (37, 16, 1), (3, 1, 2),
                                      (256, 1024, 3)])
def test_quantize_array_bit_equal(quant, k, n, seed):
    """q and scale equal the reference's; the dequantized weight keeps the
    reference's half-step bound |dequant - w| <= scale / 2."""
    w = np.random.default_rng(seed).normal(size=(k, n)).astype(np.float32)
    got = qz.quantize_array(w, quant)
    want = jqz.quantize_array(w, quant)
    assert isinstance(got.q, torch.Tensor)
    assert got.q.numpy().dtype == np.asarray(want.q).dtype
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert (got.bits, got.shape, got.dtype) == (want.bits, want.shape,
                                                 want.dtype)
    assert got.nbytes == want.nbytes
    deq = got.dequantize().numpy()
    np.testing.assert_array_equal(deq, np.asarray(want.dequantize()))
    halfstep = np.abs(w).max(axis=0, keepdims=True) / \
        qz.QUANT_SCHEMES[quant][1] / 2
    assert np.all(np.abs(deq - w) <= halfstep + 1e-7)


@pytest.mark.parametrize("quant", QUANTS)
def test_zero_channel_has_unit_scale(quant):
    w = np.zeros((8, 4), np.float32)
    w[:, 0] = 3.0
    qt = qz.quantize_array(w, quant)
    np.testing.assert_array_equal(qt.scale.numpy(),
                                  np.asarray(jqz.quantize_array(w, quant)
                                             .scale))
    assert qt.scale[1].item() == 1.0
    np.testing.assert_allclose(qt.dequantize().numpy(), w, atol=0.25)


@pytest.mark.parametrize("k", [6, 7])
def test_int4_pack_and_unpack_match_reference(k):
    vals = np.random.default_rng(k).integers(-8, 8, (k, 5)).astype(np.int8)
    packed = qz.pack_int4(vals)
    np.testing.assert_array_equal(packed, jqz.pack_int4(vals))
    assert packed.shape == ((k + 1) // 2, 5) and packed.dtype == np.uint8
    back = qz.unpack_int4(torch.from_numpy(packed), k)
    np.testing.assert_array_equal(back.numpy(), vals)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jqz.unpack_int4(packed, k)))


def test_quantize_flat_matches_reference():
    """2-D float weights become the quadruple, 1-D params and routers pass
    through; keys, dtypes and bytes equal the reference's."""
    rng = np.random.default_rng(0)
    flat = {"attn.w_q": rng.normal(size=(8, 8)).astype(np.float32),
            "attn_norm": np.ones((8,), np.float32),
            "moe.router": rng.normal(size=(8, 4)).astype(np.float32)}
    for quant in (None,) + QUANTS:
        got = qz.quantize_flat(flat, quant)
        want = jqz.quantize_flat(flat, quant)
        assert sorted(got) == sorted(want)
        for key in want:
            a, b = np.asarray(got[key]), np.asarray(want[key])
            assert a.dtype == b.dtype and a.nbytes == b.nbytes, key
            np.testing.assert_array_equal(a, b)
    stored = qz.quantize_flat(flat, "int8")
    assert "attn_norm" in stored and "moe.router" in stored
    assert "attn.w_q" not in stored and "attn.w_q.__q__" in stored


@pytest.mark.parametrize("quant", QUANTS)
def test_take_rows_gathers_only_the_rows(quant):
    """The embedding gather equals ``dequantize()[idx]`` (what the
    reference computes) for ragged, repeated and odd row ids."""
    w = np.random.default_rng(4).normal(size=(37, 24)).astype(np.float32)
    qt = qz.quantize_array(w, quant)
    idx = torch.tensor([[0, 5, 36, 36], [1, 2, 3, 35]])
    want = np.asarray(jqz.quantize_array(w, quant).dequantize())[idx.numpy()]
    np.testing.assert_array_equal(qt.take_rows(idx).numpy(), want)


def test_dequant_tree_maps_only_quantized_leaves():
    w = np.random.default_rng(5).normal(size=(6, 4)).astype(np.float32)
    norm = torch.ones(4)
    tree = {"attn": {"w_q": qz.quantize_array(w, "int8")}, "norm": norm}
    out = qz.dequant_tree(tree)
    assert out["norm"] is norm
    np.testing.assert_array_equal(out["attn"]["w_q"].numpy(),
                                  np.asarray(jqz.dequant_tree(
                                      {"w": jqz.quantize_array(w, "int8")}
                                  )["w"]))


# ---------------------------------------------------------------------------
# shards and manifests, to the byte
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("quant", QUANTS)
def test_requantize_matches_reference(gpt2q, quant, tmp_path):
    """The port's transcode of a JAX-written fp32 checkpoint: the same
    manifest (bytes, fp_bytes, scale_bytes, n_quantized, source
    fingerprint) and the same arrays in every npz."""
    _, _, _, paths = gpt2q
    got = tp.requantize(paths["fp32"], tmp_path, quant)
    want = load_manifest(paths[quant])
    assert got == want
    assert json.loads((tmp_path / "manifest.json").read_text()) == want
    assert got["quant_scheme"] == qz.SCHEME
    assert got["quant_bits"] == qz.QUANT_SCHEMES[quant][0]
    for name in tp.shard_names(want):
        a, b = _npz(tmp_path / f"{name}.npz"), _npz(paths[quant]
                                                    / f"{name}.npz")
        assert sorted(a) == sorted(b)
        for key in b:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("quant", QUANTS)
def test_partition_and_save_quantized_matches_reference(gpt2q, quant,
                                                        tmp_path):
    jcfg, tcfg, params, _ = gpt2q
    want = partition_and_save(params, jcfg, tmp_path / "jax", quant=quant)
    got = tp.partition_and_save(tp.from_jax_params(params, device="cpu"),
                                tcfg, tmp_path / "port", quant=quant)
    assert got == want
    m32 = load_manifest(gpt2q[3]["fp32"])
    ratio = 3.5 if quant == "int8" else 7.0
    assert m32["layer_bytes"] / got["layer_bytes"] > ratio
    for s in got["shards"]:
        assert s["dtype"] == quant and s["bytes"] < s["fp_bytes"]
        assert s["scale_bytes"] > 0 and s["n_quantized"] > 0


@pytest.mark.parametrize("quant", QUANTS)
def test_each_package_reads_the_others_shards(gpt2q, quant, tmp_path):
    """load_shard restores QuantizedTensor leaves from either package's
    shards, with equal payloads, scales and metadata."""
    _, _, _, paths = gpt2q
    tp.requantize(paths["fp32"], tmp_path, quant)
    for name in ("embed", "layer_000", "head"):
        for port_dir, jax_dir in ((paths[quant], paths[quant]),
                                  (tmp_path, tmp_path)):
            got = tp.load_shard(port_dir, name)
            want = load_shard(jax_dir, name)
            g_leaves = jax.tree.leaves(got, is_leaf=qz.is_quantized)
            w_leaves = jax.tree.leaves(want, is_leaf=jqz.is_quantized)
            assert len(g_leaves) == len(w_leaves)
            for g, w in zip(g_leaves, w_leaves):
                if jqz.is_quantized(w):
                    assert qz.is_quantized(g)
                    assert (g.bits, g.shape, g.dtype) == (w.bits, w.shape,
                                                         w.dtype)
                    np.testing.assert_array_equal(_np(g.q), np.asarray(w.q))
                    np.testing.assert_array_equal(_np(g.scale),
                                                  np.asarray(w.scale))
                else:
                    np.testing.assert_array_equal(g, np.asarray(w))
    layer = tp.load_shard(paths[quant], "layer_000")
    assert isinstance(layer["attn"]["w_q"], qz.QuantizedTensor)
    assert isinstance(layer["attn_norm"], np.ndarray)


def test_requantize_rejects_quantized_source(gpt2q, tmp_path):
    _, _, _, paths = gpt2q
    with pytest.raises(ValueError, match="full-precision"):
        tp.requantize(paths["int8"], tmp_path / "x", "int4")


def test_ensure_quantized_retranscodes_stale_variant(tmp_path):
    """Re-partitioning the source in place invalidates the derived int8
    shards; the same source reuses them."""
    tcfg = torch_get("gpt2_base").with_(
        num_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
        d_ff=128, vocab_size=64, vocab_pad_to=8, remat=False)
    from repro_torch.models.dense_lm import init_params as torch_init
    src, dst = tmp_path / "fp", tmp_path / "q8"
    tp.partition_and_save(torch_init(np.random.default_rng(0), tcfg), tcfg,
                          src)
    tp.ensure_quantized(src, dst, "int8")
    stamp = (dst / "layer_000.npz").stat().st_mtime_ns
    w0 = tp.load_shard(dst, "layer_000")["attn"]["w_q"].dequantize()
    tp.ensure_quantized(src, dst, "int8")                  # reused
    assert (dst / "layer_000.npz").stat().st_mtime_ns == stamp
    bigger = tcfg.with_(d_ff=256)            # new bytes -> new fingerprint
    tp.partition_and_save(torch_init(np.random.default_rng(1), bigger),
                          bigger, src)
    tp.ensure_quantized(src, dst, "int8")
    man = tp.load_manifest(dst)
    assert man["source_total_bytes"] == tp.load_manifest(src)["total_bytes"]
    w1 = tp.load_shard(dst, "layer_000")["attn"]["w_q"].dequantize()
    assert w1.shape == w0.shape and not torch.equal(w1, w0)
    # the JAX package's guard accepts the port's transcode as current
    assert jax_partition.ensure_quantized(src, dst, "int8") == dst
    assert (dst / "manifest.json").read_text() == json.dumps(man, indent=1)


# ---------------------------------------------------------------------------
# the dequantizing matmul's plain version vs the Pallas kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits,quant", [(8, "int8"), (4, "int4")])
@pytest.mark.parametrize("m,k,n,bm,bn,bk", [
    (64, 64, 64, 64, 64, 64),          # single tile
    (128, 256, 64, 64, 64, 64),        # multi-tile K streaming
    (64, 128, 192, 64, 64, 128),       # uneven grid
    (3, 128, 64, 3, 64, 128),          # M not a tile multiple (decode)
])
def test_quant_matmul_matches_pallas_interpret(m, k, n, bm, bn, bk, bits,
                                               quant):
    rng = np.random.default_rng(m + k + n + bits)
    x = rng.normal(size=(m, k)).astype(np.float32)
    qt = jqz.quantize_array(rng.normal(size=(k, n)).astype(np.float32),
                            quant)
    w_q, scale = np.asarray(qt.q), np.asarray(qt.scale)
    pallas = jops.quant_matmul(jnp.asarray(x), jnp.asarray(w_q),
                               jnp.asarray(scale), bits=bits, block_m=bm,
                               block_n=bn, block_k=bk)
    oracle = jref.quant_matmul_ref(jnp.asarray(x), jnp.asarray(w_q),
                                   jnp.asarray(scale), bits=bits)
    xt, wt, st = (torch.from_numpy(a) for a in (x, w_q, scale))
    got = ref.quant_matmul_ref(xt, wt, st, bits=bits)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TOL)
    np.testing.assert_array_equal(
        ref.dequant_ref(wt, st, bits=bits).numpy(),
        np.asarray(jref.dequant_ref(jnp.asarray(w_q), jnp.asarray(scale),
                                    bits=bits)))
    # the CPU wrapper is the plain version and launches nothing
    before = ops.LAUNCHES["quantized_matmul"]
    np.testing.assert_array_equal(ops.quant_matmul(xt, wt, st, bits).numpy(),
                                  got.numpy())
    assert ops.LAUNCHES["quantized_matmul"] == before


def test_quant_matmul_odd_k_int4():
    """An odd K's padding nibble is dropped: the product equals x @ the
    reference's dequantized (K, N) weight."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(5, 37)).astype(np.float32)
    qt = jqz.quantize_array(rng.normal(size=(37, 24)).astype(np.float32),
                            "int4")
    got = ref.quant_matmul_ref(torch.from_numpy(x),
                               torch.from_numpy(np.asarray(qt.q)),
                               torch.from_numpy(np.asarray(qt.scale)),
                               bits=4)
    np.testing.assert_allclose(got.numpy(),
                               x @ np.asarray(qt.dequantize()), **TOL)


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("shape", [(3, 256), (2, 7, 256)])
def test_linear_on_quantized_weight(quant, shape):
    """``common.linear`` flattens leading dims; the kernel route and the
    plain route give the same product on the CPU, equal to x @ the
    dequantized weight."""
    from repro_torch.models import common
    rng = np.random.default_rng(len(shape))
    w = qz.quantize_array(rng.normal(size=(256, 48)).astype(np.float32),
                          quant)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    got = common.linear(x, w, common.KERNEL)
    assert got.shape == shape[:-1] + (48,)
    torch.testing.assert_close(got, common.linear(x, w, None), atol=0,
                               rtol=0)
    torch.testing.assert_close(got, x @ w.dequantize(), **TOL)


# ---------------------------------------------------------------------------
# the engine over int8 / int4 shards
# ---------------------------------------------------------------------------
def _floor(path, cfg, cache_total, pin):
    man = load_manifest(path)
    layer = man["layer_bytes"] // cfg.num_layers
    other = man["total_bytes"] - man["layer_bytes"]
    return other + cache_total + pin * layer + layer


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("kv_cache", [False, True])
def test_generate_matches_jax_engine(gpt2q, toks, quant, kv_cache):
    """Identical greedy tokens, ledger peak equal to the byte (and at the
    quantized floor), equal loads and streamed bytes."""
    jcfg, tcfg, _, paths = gpt2q
    new = 4
    cache = (jcfg.num_layers * jcfg.cache_bytes(2, toks.shape[1] + new)
             if kv_cache else 0)
    budget = _floor(paths[quant], jcfg, cache, 0)
    kw = dict(mode="pipeload", num_agents=2, budget_bytes=budget)
    with JaxEngine(paths[quant], jcfg, **kw) as je:
        jout, jst = je.run_generate(toks, new, kv_cache=kv_cache)
    with PipeloadEngine(paths[quant], tcfg, device="cpu", **kw) as te:
        tout, tst = te.run_generate(toks, new, kv_cache=kv_cache)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert tst.peak_bytes == jst.peak_bytes == budget
    assert tst.peak_breakdown == jst.peak_breakdown
    assert tst.loads == jst.loads
    assert tst.streamed_bytes == jst.streamed_bytes
    man = load_manifest(paths[quant])
    sizes = {s["name"]: s["bytes"] for s in man["shards"]}
    assert tst.streamed_bytes == sum(sizes[e[2]] for e in tst.events
                                     if e[1] == "load_end")


@pytest.mark.parametrize("quant", QUANTS)
def test_run_single_logits_match(gpt2q, toks, quant):
    jcfg, tcfg, _, paths = gpt2q
    with JaxEngine(paths[quant], jcfg, num_agents=3) as je:
        jl, _ = je.run_single(toks)
    with PipeloadEngine(paths[quant], tcfg, num_agents=3,
                        device="cpu") as te:
        tl, _ = te.run_single(toks)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_int8_logits_within_tolerance_of_fp32(gpt2q, toks):
    """The documented int8 accuracy, and the stream ~4x smaller for the
    same load count."""
    _, tcfg, _, paths = gpt2q
    out = {}
    for d in ("fp32", "int8"):
        with PipeloadEngine(paths[d], tcfg, num_agents=2,
                            device="cpu") as te:
            out[d] = te.run_single(toks)
    (l32, s32), (l8, s8) = out["fp32"], out["int8"]
    err = (l8 - l32).abs().max().item()
    assert err <= INT8_LOGIT_RTOL * l32.abs().max().item()
    assert s8.loads == s32.loads
    assert s32.streamed_bytes / s8.streamed_bytes > 3.5


@pytest.mark.parametrize("quant", QUANTS)
def test_batch_round_scheduler_matches_jax(gpt2q, quant):
    """Continuous batching over quantized shards at a budget of the
    quantized decode floor plus two layers: the reference's tokens and
    ledger peak, and the tokens of sequential port runs."""
    jcfg, tcfg, _, paths = gpt2q
    new, plen = 3, 12
    prompts = np.random.default_rng(3).integers(0, 1000, (2, plen))
    man = load_manifest(paths[quant])
    layer = man["layer_bytes"] // jcfg.num_layers
    cache2 = 2 * jcfg.num_layers * jcfg.cache_bytes(1, plen + new)
    budget = _floor(paths[quant], jcfg, cache2, 0) + layer
    ek = dict(mode="pipeload", num_agents=2, budget_bytes=budget)
    sk = dict(max_inflight=2, max_total_len=plen + new)
    res = []
    for sched in (JaxScheduler(JaxEngine(paths[quant], jcfg, **ek), **sk),
                  BatchScheduler(PipeloadEngine(paths[quant], tcfg,
                                                device="cpu", **ek), **sk)):
        rids = [sched.submit(p, new) for p in prompts]
        outs, stats = sched.run()
        sched.close()
        res.append(([np.asarray(outs[r]) for r in rids], stats))
    (jouts, jst), (touts, tst) = res
    for t, j in zip(touts, jouts):
        np.testing.assert_array_equal(t, j)
    assert tst.peak_bytes == jst.peak_bytes and tst.peak_bytes <= budget
    assert tst.rounds == jst.rounds
    assert tst.streamed_bytes == jst.streamed_bytes
    assert tst.kernel_launches == dict.fromkeys(tst.kernel_launches, 0)
    for i in range(2):
        with PipeloadEngine(paths[quant], tcfg, num_agents=2,
                            device="cpu") as te:
            want, _ = te.run_generate(prompts[i:i + 1], new, kv_cache=True)
        np.testing.assert_array_equal(touts[i], want.numpy()[0])


# ---------------------------------------------------------------------------
# Hermes: dtype joins the schedule search
# ---------------------------------------------------------------------------
def test_hermes_quantized_plan_matches_jax(gpt2q, tmp_path):
    """Both facades over one checkpoint, planning from the same measured
    profiles (the JAX package's, copied under the port's name): the
    port reuses the JAX package's current transcodes, and picks the same
    dtype and schedule; under a budget below the fp32 decode floor that
    is a quantized dtype, whose engine serves within the budget."""
    jcfg, tcfg, _, paths = gpt2q
    local = tmp_path / "ckpt"
    shutil.copytree(paths["fp32"], local)
    quants = ("fp32", "int8", "int4")
    jh = JaxHermes(local, jcfg)
    for q in quants:
        jv = jh.quantized(q)
        jv.profile(batch=1, seq=8, force=True)
        shutil.copy(jv.dir / "profile.json", jv.dir / "profile_torch_cpu.json")
    th = Hermes(local, tcfg, device="cpu")
    stamps = {q: (local.parent / f"ckpt-{q}" / "manifest.json").stat()
              .st_mtime_ns for q in QUANTS}
    new, plen = 3, 8
    m8 = load_manifest(paths["int8"])
    layer8 = m8["layer_bytes"] // jcfg.num_layers
    cache = jcfg.num_layers * jcfg.cache_bytes(1, plen + new)
    budget = m8["total_bytes"] - m8["layer_bytes"] + cache + 3 * layer8
    assert budget < _floor(paths["fp32"], jcfg, cache, 0)
    for budgets in ([budget], [budget, None]):
        jp = jh.plan(budgets, quants=quants)
        tpl = th.plan(budgets, quants=quants)
        assert [(e.dtype, e.num_agents, e.predicted_latency_s,
                 e.predicted_peak_bytes) for e in tpl] == \
            [(e.dtype, e.num_agents, e.predicted_latency_s,
              e.predicted_peak_bytes) for e in jp]
    kw = dict(batch=1, prompt_len=plen, new_tokens=new, max_inflight=2,
              quants=quants)
    jg = jh.plan_generate([budget], **kw)[0]
    tg = th.plan_generate([budget], **kw)[0]
    fields = ("dtype", "num_agents", "pin_window", "inflight", "feasible",
              "predicted_peak_bytes", "cache_bytes",
              "predicted_throughput_tps")
    assert [getattr(tg, f) for f in fields] == [getattr(jg, f)
                                                for f in fields]
    assert tg.feasible and tg.dtype in QUANTS
    for q in QUANTS:                       # the JAX transcodes were reused
        assert (local.parent / f"ckpt-{q}" / "manifest.json").stat() \
            .st_mtime_ns == stamps[q]
    hq = th.quantized(tg.dtype)
    assert hq.dir == local.parent / f"ckpt-{tg.dtype}"
    assert (hq.dir / "profile_torch_cpu.json").exists()
    sched = th.scheduler(budget_bytes=budget, max_inflight=2,
                         prompt_len=plen, new_tokens=new, quants=quants)
    assert sched.engine.dir == hq.dir
    rng = np.random.default_rng(2)
    for _ in range(2):
        sched.submit(rng.integers(0, 1000, (plen,)), new)
    outs, stats = sched.run()
    sched.close()
    assert [len(o) for o in outs.values()] == [plen + new] * 2
    assert stats.peak_bytes <= budget


# ---------------------------------------------------------------------------
# the serve CLI on the CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("quant", ["int8", "int4", "auto"])
def test_serve_cli_quant_on_cpu(tmp_path, monkeypatch, capsys, quant):
    monkeypatch.setattr(serve, "CKPT_ROOT", tmp_path)
    serve.main(["--device", "cpu", "--requests", "2", "--prompt-len", "6",
                "--new-tokens", "2", "--max-inflight", "2", "--quant",
                quant])
    out = capsys.readouterr().out
    dtype = re.search(r"planner\(serve\): .*dtype=(\w+)", out).group(1)
    assert dtype == quant if quant != "auto" else dtype in ("fp32",) + QUANTS
    assert re.search(r"served 2 reqs x 2 tokens in \d+ rounds", out)
    want = {"int8", "int4"} if quant == "auto" else {quant}
    assert {p.name.rsplit("-", 1)[1] for p in tmp_path.iterdir()
            if p.name.endswith(tuple(QUANTS))} == want
    if dtype != "fp32":
        assert (tmp_path / f"gpt2-base-smoke-{dtype}"
                / "profile_torch_cpu.json").exists()


def test_serve_cli_quant_no_kv_cache(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(serve, "CKPT_ROOT", tmp_path)
    serve.main(["--device", "cpu", "--requests", "2", "--prompt-len", "6",
                "--new-tokens", "2", "--no-kv-cache", "--quant", "int4"])
    out = capsys.readouterr().out
    assert re.search(r"planner: .*dtype=int4", out)
    assert re.search(r"served 2 reqs x 2 tokens", out)
