"""The port's VLM family (qwen2_vl_2b's decoder backbone, served on text as
the reference's engine serves it) against the JAX package's: the init
tree with ``patch_proj``, shards and manifests member for member (the
embed shard carrying ``patch_proj``, fp32 and its int8 / int4
transcodes), and paged continuous batching with a shared prefix at G = 6
query heads per KV head (identical tokens, page counters, prefix hits and
ledger peaks to the byte); plus the serve CLI.  fp32, reduced configs."""
import json
import re
import shutil

import jax
import numpy as np
import pytest

from repro.checkpoint import load_manifest, partition_and_save
from repro.checkpoint import partition as jax_partition
from repro.configs import get_config
from repro.core import BatchScheduler as JaxScheduler
from repro.core import Hermes as JaxHermes
from repro.core import PipeloadEngine as JaxEngine
from repro.models.dense_lm import init_params as jax_init
from repro_torch.checkpoint import partition as tp
from repro_torch.configs import get as torch_get
from repro_torch.core import BatchScheduler, Hermes, PipeloadEngine
from repro_torch.launch import serve
from repro_torch.models import dense_lm

# reduced qwen2_vl_2b: 2 KV heads of 32, and G = 6 query heads on each (the
# full model's grouping) where ``reduced`` would cut it to 2
GEOM = dict(num_layers=2, n_heads=12, vocab_size=300, vocab_pad_to=4)
FIELDS = ("peak_bytes", "rounds", "cache_bytes_peak", "pages_allocated",
          "page_reuses", "prefix_hit_pages", "cow_copies", "pool_pages_peak",
          "preemptions", "max_inflight_seen")


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _same_shards(port_dir, jax_dir):
    want = load_manifest(jax_dir)
    assert json.loads((port_dir / "manifest.json").read_text()) == want
    for name in tp.shard_names(want):
        a, b = _npz(port_dir / f"{name}.npz"), _npz(jax_dir / f"{name}.npz")
        assert sorted(a) == sorted(b), name
        for key in b:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key])


@pytest.fixture(scope="module")
def vlm(tmp_path_factory):
    jcfg = get_config("qwen2_vl_2b").reduced().with_(**GEOM)
    tcfg = torch_get("qwen2_vl_2b").reduced().with_(**GEOM)
    params = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0), jcfg))
    path = tmp_path_factory.mktemp("vlm") / "vlm"
    partition_and_save(params, jcfg, path)
    return jcfg, tcfg, params, path


def test_vlm_init_matches_reference_shapes(vlm):
    jcfg, tcfg, params, _ = vlm
    assert tcfg.q_heads_per_kv == jcfg.q_heads_per_kv == 6
    tree = dense_lm.init_params(np.random.default_rng(0), tcfg)
    assert "patch_proj" in tree
    assert jax.tree.structure(tree) == jax.tree.structure(params)
    for a, r in zip(jax.tree.leaves(tree), jax.tree.leaves(params)):
        assert a.shape == r.shape and a.dtype == r.dtype
    full = get_config("qwen2_vl_2b")
    want = jax.eval_shape(lambda k: jax_init(k, full), jax.random.PRNGKey(0))
    assert want["patch_proj"].shape == (full.d_model, full.d_model)


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_vlm_shards_match_jax(vlm, quant, tmp_path):
    """The embed shard carries ``patch_proj``; the port's writer (fp32) and
    transcode (int8 / int4) give the JAX package's manifest and every npz
    member, to the byte."""
    _, tcfg, params, path = vlm
    jax_dir, port_dir = path, tmp_path / "port"
    if quant is None:
        tp.partition_and_save(tp.from_jax_params(params, device="cpu"),
                              tcfg, port_dir)
    else:
        jax_dir = tmp_path / "jax"
        jax_partition.requantize(path, jax_dir, quant)
        tp.requantize(path, port_dir, quant)
    _same_shards(port_dir, jax_dir)
    embed = _npz(port_dir / "embed.npz")
    stem = "patch_proj" + ("" if quant is None else ".__q__")
    assert stem in embed and "embed" + stem[len("patch_proj"):] in embed


def _serve(eng_cls, sched_cls, path, cfg, prompts, news, **ek):
    kw = dict(mode="pipeload", num_agents=2, pin_window=0, page_size=4)
    kw.update(ek)
    if eng_cls is PipeloadEngine:
        kw["device"] = "cpu"
    sched = sched_cls(eng_cls(path, cfg, **kw), max_inflight=3,
                      max_total_len=20)
    rids = [sched.submit(p, n) for p, n in zip(prompts, news)]
    outs, stats = sched.run()
    sched.close()
    return [np.asarray(outs[r]) for r in rids], stats


@pytest.mark.parametrize("quant", [None, "int8"])
def test_vlm_paged_shared_prefix_matches_jax(vlm, quant, tmp_path):
    """Four requests opening with the same 12 tokens (3 pages of 4), at
    most 3 in flight: the same tokens, rounds, page counters, prefix hits
    and ledger peak (with its breakdown) as the JAX package's scheduler, on
    the fp32 checkpoint and on its int8 transcode."""
    jcfg, tcfg, _, path = vlm
    if quant:
        jax_partition.requantize(path, tmp_path / quant, quant)
        path = tmp_path / quant
    rng = np.random.default_rng(6)
    shared = rng.integers(0, 300, (12,))
    prompts = [np.concatenate([shared, rng.integers(0, 300, (n,))])
               for n in (2, 4, 1, 3)]
    news = [3, 2, 4, 2]
    jt, jst = _serve(JaxEngine, JaxScheduler, path, jcfg, prompts, news)
    tt, tst = _serve(PipeloadEngine, BatchScheduler, path, tcfg, prompts,
                     news)
    for t, j in zip(tt, jt):
        np.testing.assert_array_equal(t, j)
    for f in FIELDS:
        assert getattr(tst, f) == getattr(jst, f), f
    assert tst.peak_breakdown == jst.peak_breakdown
    assert tst.prefix_hit_pages > 0
    if quant is None:
        dense, _ = _serve(PipeloadEngine, BatchScheduler, path, tcfg,
                          prompts, news, page_size=None)
        for a, b in zip(tt, dense):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("flags", [[], ["--page-size", "4",
                                        "--shared-prefix", "12"]])
def test_serve_cli_vlm_on_cpu(tmp_path, monkeypatch, capsys, flags):
    monkeypatch.setattr(serve, "CKPT_ROOT", tmp_path)
    serve.main(["--device", "cpu", "--arch", "qwen2_vl_2b", "--requests",
                "3", "--prompt-len", "16", "--new-tokens", "3",
                "--max-inflight", "3", "--budget-mb", "10"] + flags)
    out = capsys.readouterr().out
    assert re.search(r"served 3 reqs x 3 tokens in \d+ rounds", out)
    if flags:
        assert "page size 4" in out
        assert int(re.search(r"prefix_hit_pages\s+(\d+)", out).group(1)) > 0
    ckpt = next(tmp_path.iterdir())
    assert "patch_proj" in tp.load_shard(ckpt, "embed")


def test_hermes_facade_vlm_matches_jax(vlm, tmp_path):
    """profile -> plan_generate(page_sizes) -> scheduler on the VLM
    checkpoint, both packages planning from one measured profile: the
    same plan, then the same tokens, prefix hits and ledger peak."""
    jcfg, tcfg, _, path = vlm
    local = tmp_path / "ckpt"
    shutil.copytree(path, local)
    jh = JaxHermes(local, jcfg)
    jh.profile(batch=1, seq=8, force=True)
    shutil.copy(local / "profile.json", local / "profile_torch_cpu.json")
    th = Hermes(local, tcfg, device="cpu")
    man = load_manifest(local)
    budget = (man["total_bytes"] - man["layer_bytes"]
              + man["layer_bytes"] // jcfg.num_layers + 2**18)
    kw = dict(max_inflight=3, prompt_len=16, new_tokens=3,
              page_sizes=(4,), shared_prefix_len=12)
    jp, tp_ = (h.plan_generate([budget], **kw)[0] for h in (jh, th))
    for f in ("num_agents", "pin_window", "inflight", "page_size",
              "predicted_peak_bytes", "cache_bytes", "feasible"):
        assert getattr(tp_, f) == getattr(jp, f), f
    shared = np.random.default_rng(9).integers(0, 300, (12,))
    prompts = [np.concatenate([shared, [i, i + 1, i + 2, i + 3]])
               for i in range(3)]
    outs = []
    for h in (jh, th):
        sched = h.scheduler(budget_bytes=budget, seed=2, **kw)
        rids = [sched.submit(p, 3) for p in prompts]
        o, st = sched.run()
        sched.close()
        outs.append(([np.asarray(o[r]) for r in rids], st))
    (jt, jst), (tt, tst) = outs
    for t, j in zip(tt, jt):
        np.testing.assert_array_equal(t, j)
    for f in ("peak_bytes", "page_size", "prefix_hit_pages", "rounds",
              "cache_bytes_peak"):
        assert getattr(tst, f) == getattr(jst, f), f
