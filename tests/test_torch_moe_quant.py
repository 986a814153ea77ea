"""The port's quantized expert-split MoE against the JAX package's
(``tests/test_moe_stream.py``'s int8 tests, widened): int8 / int4 expert
shards to the byte, each package reading the other's, the engine's logits,
tokens, expert counters and ``streamed_bytes``, batched serving, the
dtype search of the planner and the serve CLI, on reduced
``qwen3_moe_30b_a3b`` (fp32, routers x8 as the reference's fixture scales
them) written by the JAX package from one seed.  Then bfloat16 shards:
the port reads the JAX package's bit for bit, writes the same bytes,
quantizes them as the reference quantizes bf16 weights, and serves them.

Each routing-sensitive test first shows that routing is decisive on the
weights the engines multiply by (the quantized weights dequantized): every
token's top-k router margin exceeds 100x the two packages' router-logit
difference (``test_torch_moe_stream.assert_decisive``)."""
import dataclasses
import json
import re
import shutil
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_moe_stream import (EXPERT_FIELDS, NEW, PROMPT,
                                   ROUTER_SCALE, TOTAL, _budget,
                                   assert_decisive, assert_same_run)

from repro.checkpoint import load_manifest, load_shard, partition_and_save
from repro.checkpoint import partition as jax_partition
from repro.checkpoint import quant as jqz
from repro.configs import get_config
from repro.core import BatchScheduler as JaxScheduler
from repro.core import PipeloadEngine as JaxEngine
from repro.core import plan_generate as jax_plan_generate
from repro.models.api import build_model
from repro_torch.checkpoint import partition as tp
from repro_torch.checkpoint import quant as qz
from repro_torch.configs import get as torch_get
from repro_torch.core import BatchScheduler, Hermes, PipeloadEngine
from repro_torch.core import plan_generate
from repro_torch.launch import serve

TOL = dict(atol=1e-5, rtol=1e-5)        # fp32, as tests/test_torch_quant.py
QUANTS = ("int8", "int4")
JCFG = get_config("qwen3_moe_30b_a3b").reduced()
TCFG = torch_get("qwen3_moe_30b_a3b").reduced()


def _init(jcfg):
    """Seeded JAX params with the routers x8, as numpy."""
    p = build_model(jcfg).init(jax.random.PRNGKey(0))
    p["layers"]["moe"]["router"] = p["layers"]["moe"]["router"] * ROUTER_SCALE
    return jax.tree.map(np.asarray, p)


def _dequantized(params, quant):
    """The weights a ``quant`` checkpoint of ``params`` multiplies by: each
    shard's 2-D weight quantized by the JAX package and dequantized (the
    stacked layer leaves slice by slice, the routers kept)."""
    def leaf(path, a):
        key = jax.tree_util.keystr(path)
        if "router" in key or a.ndim < 2 or (key.startswith("['layers']")
                                             and a.ndim < 3):
            return a
        flat = a.reshape((-1,) + a.shape[-2:])
        out = np.stack([np.asarray(jqz.quantize_array(w, quant).dequantize())
                        for w in flat])
        return out.reshape(a.shape)
    return jax.tree_util.tree_map_with_path(leaf, params)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """The JAX package's expert-split fp32 checkpoint and its int8 / int4
    transcodes by the JAX package's ``requantize``."""
    root = tmp_path_factory.mktemp("moe_quant")
    params = _init(JCFG)
    paths = {"fp32": root / "fp32"}
    partition_and_save(params, JCFG, paths["fp32"])
    for q in QUANTS:
        paths[q] = root / q
        jax_partition.requantize(paths["fp32"], paths[q], q)
    return params, paths


@pytest.fixture(scope="module")
def toks():
    return np.random.default_rng(0).integers(0, JCFG.vocab_size, (2, PROMPT))


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# int8 / int4 expert shards, to the byte
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("quant", QUANTS)
def test_requantize_matches_jax_expert_layout(ckpts, quant, tmp_path):
    """The port's transcode of the JAX package's expert-split checkpoint:
    the reference's manifest (expert rows with their ``expert`` id,
    ``index``, quantized ``bytes``, ``fp_bytes``, ``n_quantized``; the
    expert-split and quant keys) and the same arrays in every npz, the
    routers kept at fp32."""
    _, paths = ckpts
    got = tp.requantize(paths["fp32"], tmp_path, quant)
    want = load_manifest(paths[quant])
    assert got == want == tp.load_manifest(tmp_path)
    assert got["expert_split"] is True and got["quant"] == quant
    assert got["experts_per_layer"] == JCFG.n_experts
    assert got["quant_scheme"] == qz.SCHEME
    assert got["quant_bits"] == qz.QUANT_SCHEMES[quant][0]
    experts = [s for s in got["shards"] if s["kind"] == "expert"]
    assert len(experts) == JCFG.num_layers * JCFG.n_experts
    assert got["expert_total_bytes"] == sum(s["bytes"] for s in experts)
    for s in experts:
        assert s["name"] == f"layer_{s['index']:03d}_expert_{s['expert']:03d}"
        assert s["dtype"] == quant and s["n_quantized"] == 3
        assert s["bytes"] < s["fp_bytes"]
    fp = load_manifest(paths["fp32"])
    ratio = 3 if quant == "int8" else 6
    assert got["expert_total_bytes"] < fp["expert_total_bytes"] / ratio
    for name in tp.shard_names(want):
        a, b = _npz(tmp_path / f"{name}.npz"), _npz(paths[quant]
                                                    / f"{name}.npz")
        assert sorted(a) == sorted(b)
        for key in b:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key])
    layer = _npz(tmp_path / "layer_000.npz")
    assert layer["moe.router"].dtype == np.float32
    assert not any(k.startswith("moe.router.") for k in layer)


@pytest.mark.parametrize("quant", QUANTS)
def test_each_package_reads_the_others_expert_shards(ckpts, quant,
                                                     tmp_path):
    _, paths = ckpts
    tp.requantize(paths["fp32"], tmp_path, quant)
    for name in ("layer_000", "layer_001_expert_002", "head"):
        for d in (paths[quant], tmp_path):
            got = tp.load_shard(d, name)
            want = load_shard(d, name)
            g_leaves = jax.tree.leaves(got, is_leaf=qz.is_quantized)
            w_leaves = jax.tree.leaves(want, is_leaf=jqz.is_quantized)
            assert len(g_leaves) == len(w_leaves)
            for g, w in zip(g_leaves, w_leaves):
                if jqz.is_quantized(w):
                    assert (g.bits, g.shape, g.dtype) == (w.bits, w.shape,
                                                         w.dtype)
                    np.testing.assert_array_equal(g.q.numpy(),
                                                  np.asarray(w.q))
                    np.testing.assert_array_equal(g.scale.numpy(),
                                                  np.asarray(w.scale))
                else:
                    np.testing.assert_array_equal(g, np.asarray(w))
    expert = tp.load_shard(paths[quant], "layer_000_expert_001")
    assert all(qz.is_quantized(w) for w in expert.values())


# ---------------------------------------------------------------------------
# the engine against the JAX package's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("quant", QUANTS)
def test_run_single_matches_jax(ckpts, toks, quant):
    params, paths = ckpts
    assert_decisive(_dequantized(params, quant), JCFG, TCFG, toks)
    with JaxEngine(paths[quant], JCFG, num_agents=2) as je:
        jl, jst = je.run_single(toks)
    with PipeloadEngine(paths[quant], TCFG, num_agents=2,
                        device="cpu") as te:
        tl, st = te.run_single(toks)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert st.expert_misses > 0
    assert_same_run(st, jst)


@pytest.mark.parametrize("quant", QUANTS)
def test_budgeted_generation_matches_jax(ckpts, toks, quant):
    """Generated tokens, expert hits, misses, evictions, ``streamed_bytes``
    and the ledger peak and breakdown equal the reference's under a budget
    whose expert cache must evict; the cache holds quantized bytes."""
    params, paths = ckpts
    budget = _budget(paths[quant], JCFG, extra_experts=4, batch=2)
    kw = dict(mode="pipeload", num_agents=2, pin_window=0,
              budget_bytes=budget)
    with JaxEngine(paths[quant], JCFG, **kw) as je:
        jout, jst = je.run_generate(toks, NEW, kv_cache=True)
    with PipeloadEngine(paths[quant], TCFG, device="cpu", **kw) as te:
        out, st = te.run_generate(toks, NEW, kv_cache=True)
    assert_decisive(_dequantized(params, quant), JCFG, TCFG,
                    out.numpy()[:, :-1])
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert_same_run(st, jst)
    assert st.peak_bytes <= budget
    assert st.expert_evictions > 0 and st.peak_breakdown["expert_cache"]
    rows = {s["name"]: s["bytes"] for s in load_manifest(paths[quant])
            ["shards"]}
    loaded = sum(rows[key] for _, kind, key in st.events
                 if kind == "load_end")
    assert st.streamed_bytes == loaded


def test_int8_within_documented_tolerance(ckpts, toks):
    """docs/quantization.md's MoE tolerance on the port: greedy tokens
    equal fp32's, the largest logit error under 25% of the largest fp32
    logit, and fewer bytes streamed on the same cold run."""
    _, paths = ckpts
    with PipeloadEngine(paths["fp32"], TCFG, num_agents=2,
                        device="cpu") as e_fp:
        l_fp, st_fp = e_fp.run_single(toks)
    with PipeloadEngine(paths["int8"], TCFG, num_agents=2,
                        device="cpu") as e_q:
        l_q, st = e_q.run_single(toks)
    l_fp, l_q = l_fp.numpy(), l_q.numpy()
    np.testing.assert_array_equal(l_q.argmax(-1), l_fp.argmax(-1))
    assert np.abs(l_q - l_fp).max() / np.abs(l_fp).max() < 0.25
    assert st.expert_misses > 0
    assert st.streamed_bytes < st_fp.streamed_bytes


@pytest.mark.parametrize("quant", QUANTS)
def test_scheduler_batched_matches_jax(ckpts, quant):
    """Continuous batching over quantized expert shards: the reference's
    tokens, rounds, ledger peak and breakdown, expert counters and
    streamed bytes."""
    params, paths = ckpts
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, JCFG.vocab_size, (6 + 2 * i,))
               for i in range(3)]
    runs = []
    for sched_cls, eng in (
            (JaxScheduler, JaxEngine(paths[quant], JCFG, num_agents=2)),
            (BatchScheduler, PipeloadEngine(paths[quant], TCFG, num_agents=2,
                                            device="cpu"))):
        sched = sched_cls(eng, max_inflight=3, max_total_len=TOTAL)
        try:
            sched.warmup(prompt_lens=sorted({len(p) for p in prompts}))
            rids = [sched.submit(p, 4) for p in prompts]
            outs, stats = sched.run()
        finally:
            sched.close()
        runs.append((rids, outs, stats))
    (jrids, jouts, jst), (rids, outs, st) = runs
    assert rids == jrids
    assert_decisive(_dequantized(params, quant), JCFG, TCFG,
                    [outs[r][:-1] for r in rids])
    for rid in rids:
        np.testing.assert_array_equal(outs[rid], np.asarray(jouts[rid]))
    for f in EXPERT_FIELDS + ("rounds", "peak_bytes", "loads",
                              "streamed_bytes", "cache_bytes_peak"):
        assert getattr(st, f) == getattr(jst, f), f
    assert st.peak_breakdown == jst.peak_breakdown
    assert st.expert_hits > 0 and st.expert_misses > 0
    assert st.kernel_launches == dict.fromkeys(st.kernel_launches, 0)


# ---------------------------------------------------------------------------
# Hermes: the dtype joins the expert cache in the plan
# ---------------------------------------------------------------------------
def test_hermes_plan_quants_matches_jax(ckpts, tmp_path):
    """One profile per dtype variant, expert rows at the variant's bytes;
    the port's and the JAX package's planners make the same joint
    (dtype, agents, pin, expert cache) choice from them; under a budget
    below the fp32 checkpoint's expert floor it is a quantized dtype,
    which ``Hermes.scheduler`` serves within the budget."""
    _, paths = ckpts
    local = tmp_path / "ckpt"
    shutil.copytree(paths["fp32"], local)
    quants = ("fp32", "int8", "int4")
    hermes = Hermes(local, TCFG, device="cpu")
    profs = hermes._profiles(quants)
    eb = {q: profs[q]["expert_bytes"] for q in quants}
    assert eb["fp32"] > eb["int8"] > eb["int4"]
    for q in QUANTS:
        man = load_manifest(local.parent / f"ckpt-{q}")
        assert man == load_manifest(paths[q]) | {
            "source_total_bytes": man["source_total_bytes"]}
        rows = [s for s in profs[q]["shards"] if s["kind"] == "expert"]
        assert [r["bytes"] for r in rows] == [
            s["bytes"] for s in man["shards"] if s["kind"] == "expert"]
        assert all(r["dtype"] == q for r in rows)
    plen, new = 8, 3
    budget = _budget(paths["int8"], JCFG, extra_experts=JCFG.n_experts)
    assert budget < _budget(paths["fp32"], JCFG,
                           extra_experts=JCFG.n_experts)
    kw = dict(new_tokens=new, cache_bytes_per_layer=TCFG.cache_bytes(
        1, plen + new), max_agents=3, max_inflight=2, total_len=plen + new)
    for b in (None, budget):
        [g] = plan_generate(profs, [b], **kw)
        [jg] = jax_plan_generate(profs, [b], **kw)
        assert dataclasses.asdict(g) == dataclasses.asdict(jg)
        assert g.feasible and g.expert_cache_bytes > 0
    assert g.dtype in QUANTS and g.predicted_peak_bytes <= budget
    tg = hermes.plan_generate([budget], batch=1, prompt_len=plen,
                              new_tokens=new, max_inflight=2, max_agents=3,
                              quants=quants)[0]
    assert (tg.dtype, tg.expert_cache_bytes) == (g.dtype,
                                                 g.expert_cache_bytes)
    sched = hermes.scheduler(budget_bytes=budget, max_inflight=2,
                             prompt_len=plen, new_tokens=new, quants=quants)
    assert sched.engine.dir == local.parent / f"ckpt-{g.dtype}"
    rng = np.random.default_rng(2)
    for _ in range(2):
        sched.submit(rng.integers(0, JCFG.vocab_size, (plen,)), new)
    outs, stats = sched.run()
    sched.close()
    assert [len(o) for o in outs.values()] == [plen + new] * 2
    assert stats.peak_bytes <= budget and stats.expert_misses > 0


# ---------------------------------------------------------------------------
# the serve CLI on the CPU
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def cli_root(tmp_path_factory):
    return tmp_path_factory.mktemp("moe_quant_cli")


@pytest.mark.parametrize("quant", ["int8", "int4", "auto"])
def test_serve_cli_moe_quant_on_cpu(cli_root, monkeypatch, capsys, quant):
    """``serve --arch qwen3_moe_30b_a3b --quant``: the expert-split
    checkpoint transcoded once into its sibling, served, and the planner
    line naming the dtype and the expert cache."""
    monkeypatch.setattr(serve, "CKPT_ROOT", cli_root)
    serve.main(["--device", "cpu", "--arch", "qwen3_moe_30b_a3b",
                "--requests", "2", "--prompt-len", "8", "--new-tokens", "3",
                "--quant", quant])
    out = capsys.readouterr().out
    plan = out.split("planner(serve)")[1].splitlines()[0]
    dtype = re.search(r"dtype=(\w+)", plan).group(1)
    assert dtype == quant if quant != "auto" else dtype in ("fp32",) + QUANTS
    assert "expert cache" in plan
    assert "served 2 reqs x 3 tokens" in out
    for row in ("expert_hit_rate", "experts_per_round", "expert_cache_mb"):
        assert row in out
    if dtype != "fp32":
        man = tp.load_manifest(cli_root / f"qwen3-moe-30b-a3b-smoke-{dtype}")
        assert man["quant"] == dtype and man["expert_split"]
        assert man["num_layers"] == 8


# ---------------------------------------------------------------------------
# bfloat16 shards
# ---------------------------------------------------------------------------
BF16_JCFG = dataclasses.replace(JCFG, dtype="bfloat16")
BF16_TCFG = TCFG.with_(dtype="bfloat16")


def _bits(a) -> np.ndarray:
    """The 16-bit patterns of a bfloat16 leaf (torch or numpy)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


@pytest.fixture(scope="module")
def bf16(tmp_path_factory):
    params = _init(BF16_JCFG)
    path = tmp_path_factory.mktemp("bf16") / "split"
    manifest = partition_and_save(params, BF16_JCFG, path)
    return params, path, manifest


def _shard_trees(params, cfg):
    """{shard name: the params it holds}, as the expert split lays them."""
    trees = {"embed": {"embed": params["embed"]},
             "head": {"final_norm": params["final_norm"],
                      "lm_head": params["lm_head"]}}
    for i in range(cfg.num_layers):
        layer = jax.tree.map(lambda a: a[i], params["layers"])
        moe_p = layer.pop("moe")
        trees[f"layer_{i:03d}"] = dict(layer, moe={"router": moe_p["router"]})
        for e in range(cfg.n_experts):
            trees[f"layer_{i:03d}_expert_{e:03d}"] = {
                k: moe_p[k][e] for k in ("w_gate", "w_up", "w_down")}
    return trees


def test_bf16_shards_read_bit_equal(bf16):
    """The JAX package's bf16 shards (2-byte void on disk) come back from
    the port's ``load_shard`` as ``torch.bfloat16`` leaves bit-equal to
    the JAX parameters; the fp32 routers stay fp32."""
    params, path, manifest = bf16
    assert tp.load_manifest(path) == manifest
    trees = _shard_trees(params, BF16_JCFG)
    assert sorted(trees) == sorted(tp.shard_names(manifest))
    n_bf16 = 0
    for name, want in trees.items():
        got = tp.load_shard(path, name)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            if w.dtype == jnp.bfloat16:
                assert g.dtype == torch.bfloat16
                np.testing.assert_array_equal(_bits(g), _bits(w))
                n_bf16 += 1
            else:
                assert g.dtype == w.dtype == np.float32
                np.testing.assert_array_equal(g, w)
    assert n_bf16 > len(trees)


def test_port_bf16_shards_equal_jax(bf16, tmp_path):
    """The port's writer, from the same weights as torch.bfloat16 tensors,
    writes the JAX package's manifest and the same zip members byte for
    byte (npy headers included)."""
    params, path, manifest = bf16
    tparams = tp.from_jax_params(params, device="cpu")
    assert tparams["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(tparams["embed"]),
                                  _bits(params["embed"]))
    got = tp.partition_and_save(tparams, BF16_TCFG, tmp_path)
    assert got == manifest
    for s in got["shards"]:
        with zipfile.ZipFile(tmp_path / f"{s['name']}.npz") as a, \
                zipfile.ZipFile(path / f"{s['name']}.npz") as b:
            assert a.namelist() == b.namelist()
            for member in a.namelist():
                assert a.read(member) == b.read(member), (s["name"], member)
    back = tp.to_numpy(tparams)
    np.testing.assert_array_equal(_bits(back["embed"]),
                                  _bits(params["embed"]))


def test_requantize_bf16_source_matches_jax(bf16, tmp_path):
    """The port's int8 transcode of bf16 shards quantizes the values
    widened to fp32, as the reference's quantizer does with bf16 weights:
    the arrays of the JAX package's int8 write of the same parameters."""
    params, path, manifest = bf16
    got = tp.requantize(path, tmp_path / "port", "int8")
    want = jax_partition.partition_and_save(params, BF16_JCFG,
                                            tmp_path / "jax", quant="int8")
    assert got == dict(want, source_total_bytes=manifest["total_bytes"])
    for name in tp.shard_names(want):
        a = _npz(tmp_path / "port" / f"{name}.npz")
        b = _npz(tmp_path / "jax" / f"{name}.npz")
        assert sorted(a) == sorted(b)
        for key in b:
            assert a[key].dtype == b[key].dtype, key
            assert a[key].tobytes() == b[key].tobytes(), key
    qt = tp.load_shard(tmp_path / "port", "layer_000_expert_000")["w_up"]
    assert qt.dtype == "bfloat16" and qt.dequantize().dtype == torch.bfloat16


def test_bf16_moe_serves_on_cpu(bf16):
    """Reduced bf16 MoE on the JAX package's shards: the port's logits
    against the JAX package's in-memory bf16 model within bf16's
    rounding, and a batched serve whose tokens equal the port's own
    sequential runs."""
    params, path, _ = bf16
    tok = np.random.default_rng(0).integers(0, JCFG.vocab_size, (2, PROMPT))
    ref, _ = jax.jit(build_model(BF16_JCFG).prefill)(
        params, {"tokens": jnp.asarray(tok, jnp.int32)})
    ref = np.asarray(ref, np.float32)
    with PipeloadEngine(path, BF16_TCFG, num_agents=2, device="cpu") as te:
        logits, st = te.run_single(tok)
    got = logits.float().numpy()
    assert np.isfinite(got).all() and st.expert_misses > 0
    assert np.abs(got - ref).max() <= 3e-2 * np.abs(ref).max()
    prompts = [tok[0, :8], tok[1, :10]]
    sched = BatchScheduler(PipeloadEngine(path, BF16_TCFG, num_agents=2,
                                          device="cpu"),
                           max_inflight=2, max_total_len=TOTAL)
    try:
        rids = [sched.submit(p, 3) for p in prompts]
        outs, stats = sched.run()
    finally:
        sched.close()
    assert stats.expert_misses > 0
    for rid, p in zip(rids, prompts):
        with PipeloadEngine(path, BF16_TCFG, num_agents=2,
                            device="cpu") as te:
            seq, _ = te.run_generate(p[None], 3, kv_cache=True)
        np.testing.assert_array_equal(outs[rid], seq.numpy()[0])
    assert json.loads((path / "manifest.json").read_text())["dtype"] \
        == "bfloat16"
