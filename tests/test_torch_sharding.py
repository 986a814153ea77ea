"""The port's device mesh against the JAX package's local runs, on the
CPU: ``param_pspecs`` leaf for leaf against the reference's, and the
sharded model path (``repro_torch.sharding``, ``api.shard_params`` /
``shard_cache``, the model API and ``make_train_step`` with a ctx) on
gloo ranks that ``torch.distributed.run`` starts on this file.

One launch of 4 ranks, under a wall limit (killed past it; a rank that
raises fails the tests with its traceback), runs every mesh's checks on
its own groups and then ``launch/train.py``'s ``main`` with
``--model-axis 2``, as the README shows the CLI.  The test process draws
the parameters with the JAX package's init and runs the JAX local
references; the ranks (which import no JAX) load them from an ``.npz``,
run the port's local path and the sharded one, hold both, and write
each mesh's errors to a file of their own:

* mesh (data 2, model 2), dense (the reference helper's ``cfg2``): the
  sharded prefill, and the decode of its cache sequence-sharded, against
  the port's and the JAX package's local logits (1e-4), three train steps'
  losses (1e-4) and every leaf's step-1 gradient slice (1e-5 of the
  leaf's largest |g|); the reduced VLM backbone's prefill and one decode;
* meshes (1, 4) and (pod 2, data 1, model 2), MoE (the helper's 8-expert
  ``cfg``, capacity factor 16, so no pair drops differently): the loss
  (1e-4) and every gradient, the router's included (1e-5);
* the other families (``FAMILIES``), reduced: MLA attention
  (``minicpm3_4b``) and the enc-dec (``seamless_m4t_medium``) on (data 2,
  model 2), each model rank on its heads; xLSTM (``xlstm_1_3b``: its
  mLSTM heads split, over 4 ranks one rank's up-projection columns all
  input, another's all gate) and Zamba2 (``zamba2_1_2b``: its shared
  site's 2 KV heads over 4 ranks gathered) on (data 1, model 4), and MLA
  again on (data 1, model 4), its 2 heads over 4 ranks gathered.  Each
  against the port's and the JAX package's local runs: the prefill's
  logits and two decode steps' on the ``shard_cache`` layout (the
  sequence-sharded latent, self, cross and site caches, the recurrent
  states whole) (1e-4), three train steps' losses (1e-4) and every leaf's
  step-1 gradient slice (1e-5 of its largest |g|).
"""
import datetime
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
WALL_S = 240          # one launch of 4 ranks, killed past it
LOSS_TOL = 1e-4
LOGIT_TOL = 1e-4
LEAF_TOL = 1e-5       # of each leaf's largest |g|
DENSE = dict(family="dense", num_layers=2, d_model=128, n_heads=4,
             n_kv_heads=2, d_ff=256, vocab_size=500, head_dim=32,
             vocab_pad_to=4, dtype="float32", remat=False)
MOE = dict(family="moe", num_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
           d_ff=0, vocab_size=500, head_dim=32, n_experts=8, top_k=2,
           expert_d_ff=64, capacity_factor=16.0, vocab_pad_to=4,
           dtype="float32", remat=False)
MESHES = {"dense_2x2": (2, 2), "moe_1x4": (1, 4), "moe_2x1x2": (2, 1, 2),
          "mla_2x2": (2, 2), "mla_1x4": (1, 4), "encdec_2x2": (2, 2),
          "xlstm_1x4": (1, 4), "zamba2_1x4": (1, 4)}
# mesh -> the reduced arch it runs (the families beyond dense / MoE / VLM);
# the reduced minicpm3_4b's 2 heads over 4 ranks take MLA's gathered path
FAMILIES = {"mla_2x2": "minicpm3_4b", "mla_1x4": "minicpm3_4b",
            "encdec_2x2": "seamless_m4t_medium", "xlstm_1x4": "xlstm_1_3b",
            "zamba2_1x4": "zamba2_1_2b"}
FAMILY_PROMPT, FAMILY_TOTAL = 8, 12   # prefill slots, decode cache slots
# the recurrent families' gradients against the JAX package's: their fp32
# floor (``tests/test_torch_recurrent.py``'s docstring: the two packages'
# local gradients lie up to 2.5e-5 of a leaf's largest apart); against
# the port's local run, LEAF_TOL
JAX_LEAF_TOL = {"xlstm_1_3b": 5e-5, "zamba2_1_2b": 5e-5}


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(nproc: int, args, wall: float = WALL_S):
    """``torch.distributed.run`` of ``nproc`` ranks on ``args``; killed
    (the whole process group) past ``wall`` seconds."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
           str(nproc), "--master-addr", "127.0.0.1", "--master-port",
           str(_free_port())] + list(args)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            start_new_session=True)
    t0 = time.monotonic()
    try:
        out, err = proc.communicate(timeout=wall)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        pytest.fail(f"ranks still running after {wall} s:\n{out[-3000:]}\n"
                    f"{err[-6000:]}")
    return proc.returncode, out, err, time.monotonic() - t0


def _ranks_ok(run, mesh: str, n: int = 4) -> list:
    """Each rank's results for ``mesh``, once the launch exited 0."""
    rc, out, err, outdir = run
    assert rc == 0, f"ranks failed (exit {rc}):\n{out[-3000:]}\n{err[-8000:]}"
    files = sorted(outdir.glob(f"{mesh}.rank*.json"))
    assert len(files) == n, (files, out[-3000:])
    return [json.loads(f.read_text()) for f in files]


# ---------------------------------------------------------------------------
# the JAX references, written for the ranks
# ---------------------------------------------------------------------------
def _flat(tree, prefix="", leaf=np.asarray):
    """{"a/b/c": leaf(x)} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/", leaf))
        return out
    return {prefix[:-1]: leaf(tree)}


def _jax_dense(out: dict) -> None:
    import jax
    import jax.numpy as jnp

    from repro.data.synthetic import make_batch
    from repro.models.api import build_model
    from repro.models.config import ModelConfig
    cfg = ModelConfig("d", **DENSE)
    api = build_model(cfg)
    params = api.init(jax.random.PRNGKey(1))
    out.update(_flat(params, "dense/params/"))
    b2 = make_batch(cfg, 4, 8, seed=1)
    b2.pop("labels")
    logits, cache = jax.jit(lambda p, b: api.prefill(p, b, None))(params, b2)
    dcache = api.empty_cache(4, 16)
    dcache = jax.tree.map(lambda e, f: e.at[:, :, :8].set(f), dcache, cache)
    tok = jnp.ones((4, 1), jnp.int32)
    dec, _ = jax.jit(lambda p, t, c: api.decode(p, t, c, 8, None))(
        params, tok, dcache)
    out.update({"dense/tokens": np.asarray(b2["tokens"]),
                "dense/prefill_logits": np.asarray(logits),
                "dense/decode_logits": np.asarray(dec)})
    out.update(_flat(dcache, "dense/cache/"))
    b3 = make_batch(cfg, 4, 16, seed=2)
    out.update(_flat(dict(b3), "dense/batch/"))
    _jax_steps(out, "dense", api, params, b3)


def _jax_steps(out: dict, tag: str, api, params, batch) -> None:
    """Step 1's gradients (``tag``/grads/) and three train steps' losses
    (``tag``/losses) on ``batch``: ``make_train_step``'s at ``grad_accum``
    1 composed from its parts (``value_and_grad`` of the loss,
    ``adamw_update`` at ``cosine_lr(step + 1)``), so the loss and its
    gradient compile once for both."""
    import jax

    from repro.optim import adamw_init, adamw_update, cosine_lr
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p, b: api.loss(p, b, None), has_aux=True))
    update = jax.jit(lambda g, o, p: adamw_update(
        g, o, p, lr=cosine_lr(o["step"] + 1)))
    p, opt, losses = params, adamw_init(params), []
    for i in range(3):
        (loss, _), grads = value_and_grad(p, batch)
        if i == 0:
            out.update(_flat(grads, f"{tag}/grads/"))
        losses.append(float(loss))
        p, opt = update(grads, opt, p)
    out[f"{tag}/losses"] = np.asarray(losses)


def _jax_vlm(out: dict) -> None:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.data.synthetic import make_batch
    from repro.models.api import build_model
    cfg = get_config("qwen2_vl_2b").reduced()
    api = build_model(cfg)
    params = api.init(jax.random.PRNGKey(3))
    out.update(_flat(params, "vlm/params/"))
    batch = make_batch(cfg, 4, 24, seed=3)
    batch.pop("labels")
    out.update(_flat(dict(batch), "vlm/batch/"))
    logits, cache = jax.jit(lambda p, b: api.prefill(p, b, None))(params,
                                                                  batch)
    s = int(cache["k"].shape[2])
    dcache = api.empty_cache(4, s + 4)
    dcache = jax.tree.map(lambda e, f: e.at[:, :, :s].set(f), dcache, cache)
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    dec, _ = jax.jit(lambda p, t, c: api.decode(p, t, c, s, None))(
        params, tok, dcache)
    out.update({"vlm/prefill_logits": np.asarray(logits),
                "vlm/decode_logits": np.asarray(dec)})


def _jax_moe(out: dict) -> None:
    import jax

    from repro.data.synthetic import make_batch
    from repro.models.api import build_model
    from repro.models.config import ModelConfig
    cfg = ModelConfig("moe", **MOE)
    api = build_model(cfg)
    params = api.init(jax.random.PRNGKey(0))
    out.update(_flat(params, "moe/params/"))
    batch = make_batch(cfg, 4, 16, seed=0)
    out.update(_flat(dict(batch), "moe/batch/"))
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: api.loss(p, b, None), has_aux=True))(params, batch)
    out["moe/loss"] = np.asarray(loss)
    out.update(_flat(grads, "moe/grads/"))


def _jax_family(out: dict, arch: str) -> None:
    """A reduced arch's local references under its name, on the numpy
    parameters the port's init draws (seed 5): the prefill's logits, the
    decode cache of FAMILY_TOTAL slots the prefill's fills, two decode
    steps (the tokens fed and their logits), step 1's gradients and three
    train steps' losses (``_jax_steps``)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.data.synthetic import make_batch
    from repro.models.api import build_model
    from repro.models.config import MAMBA_HYBRID, XLSTM
    from repro_torch.checkpoint.partition import to_numpy
    from repro_torch.configs import get
    from repro_torch.models.api import build_model as torch_build
    cfg = get_config(arch).reduced()
    api = build_model(cfg)
    numpy_params = to_numpy(torch_build(get(arch).reduced()).init(
        np.random.default_rng(5), "cpu"))
    params = jax.tree.map(jnp.asarray, numpy_params)
    out.update(_flat(numpy_params, f"{arch}/params/"))
    pb = make_batch(cfg, 4, FAMILY_PROMPT, seed=4)
    pb.pop("labels")
    out.update(_flat(dict(pb), f"{arch}/prefill_batch/"))
    logits, cache = jax.jit(lambda p, b: api.prefill(p, b, None))(params, pb)

    def head(e, f):
        return e.at[:, :, :f.shape[2]].set(f)
    if cfg.family == XLSTM:
        dcache = cache
    elif cfg.family == MAMBA_HYBRID:
        dcache = api.empty_cache(4, FAMILY_TOTAL)
        dcache = {"mamba": cache["mamba"],
                  "attn": jax.tree.map(head, dcache["attn"], cache["attn"])}
    else:
        dcache = jax.tree.map(head, api.empty_cache(4, FAMILY_TOTAL), cache)
    out.update(_flat(dcache, f"{arch}/cache/"))
    decode = jax.jit(lambda p, t, c, pos: api.decode(p, t, c, pos, None))
    toks, decs = [], [logits]
    for i in range(2):
        toks.append(jnp.argmax(decs[-1], -1)[:, None].astype(jnp.int32))
        dec, dcache = decode(params, toks[-1], dcache, FAMILY_PROMPT + i)
        decs.append(dec)
    out.update({f"{arch}/prefill_logits": np.asarray(logits),
                f"{arch}/tokens": np.stack([np.asarray(t) for t in toks]),
                f"{arch}/decode_logits": np.stack([np.asarray(d)
                                                  for d in decs[1:]])})
    batch = make_batch(cfg, 4, 16, seed=5)
    out.update(_flat(dict(batch), f"{arch}/batch/"))
    _jax_steps(out, arch, api, params, batch)


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    out = {}
    _jax_dense(out)
    _jax_vlm(out)
    _jax_moe(out)
    for arch in sorted(set(FAMILIES.values())):
        _jax_family(out, arch)
    path = tmp_path_factory.mktemp("sharding") / "references.npz"
    np.savez(path, **out)
    return path


@pytest.fixture(scope="module")
def mesh_run(references, tmp_path_factory):
    """The one launch of 4 ranks: every mesh's checks, then the train
    CLI's ``main``.  (exit code, stdout, stderr, the results' folder)."""
    outdir = tmp_path_factory.mktemp("ranks")
    rc, out, err, _ = launch(4, [__file__, "all", str(references),
                                 str(outdir)])
    return rc, out, err, outdir


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["gpt2_base", "qwen3_moe_30b_a3b",
                                  "qwen2_vl_2b", "minicpm3_4b",
                                  "seamless_m4t_medium", "xlstm_1_3b",
                                  "zamba2_1_2b"])
@pytest.mark.parametrize("shape", [{"data": 2, "model": 4},
                                   {"data": 1, "model": 2},
                                   {"pod": 2, "data": 2, "model": 4}],
                         ids=["2x4", "1x2", "2x2x4"])
def test_param_pspecs_match_reference(arch, shape):
    """Every leaf's storage spec is the reference's ``PartitionSpec`` (the
    reference reads only ``mesh.shape``)."""
    from types import SimpleNamespace

    import jax

    from repro.configs import get_config
    from repro.models.api import build_model as jax_build
    from repro.models.api import param_pspecs as jax_pspecs
    from repro_torch.configs import get
    from repro_torch.models.api import build_model, param_pspecs
    jcfg = get_config(arch).reduced()
    shapes = jax.eval_shape(jax_build(jcfg).init, jax.random.PRNGKey(0))
    specs = jax_pspecs(shapes, SimpleNamespace(shape=shape))
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    want = {"/".join(k.key for k in path): tuple(spec)
            for path, spec in flat}
    params = build_model(get(arch).reduced()).init(np.random.default_rng(0),
                                                   "cpu")
    got = _flat(param_pspecs(params, shape), leaf=tuple)
    assert got == want
    assert any(v for v in got.values())


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_matches_local(mesh, mesh_run):
    for rank in _ranks_ok(mesh_run, mesh):
        assert rank["mesh"] == mesh
        for key, (val, tol) in rank["errors"].items():
            assert val <= tol, (rank["rank"], key, val, tol)


def test_a_raising_rank_fails_the_launch():
    rc, out, err, took = launch(4, [__file__, "raise", "-", "-"], wall=60)
    assert rc != 0
    assert "rank 1 raised on purpose" in err, err[-4000:]
    assert "Traceback" in err
    assert took < 60


def test_train_cli_on_a_mesh(mesh_run):
    """``launch/train.py``'s ``main`` with ``--model-axis 2`` on the
    launch's 4 ranks (CLI_ARGS), after the meshes' checks."""
    rc, out, err, _ = mesh_run
    assert rc == 0, err[-6000:]
    for r in range(4):
        assert f"rank {r}/4: backend gloo, device cpu" in out
    assert out.count("first loss ") == 1      # rank 0 alone prints it
    found = re.search(r"first loss (\S+) -> last loss (\S+)", out)
    assert np.isfinite(float(found[1])) and np.isfinite(float(found[2]))


# ---------------------------------------------------------------------------
# the ranks (python -m torch.distributed.run ... this file all <npz> <dir>)
# ---------------------------------------------------------------------------
CLI_ARGS = ["--device", "cpu", "--model-axis", "2", "--arch",
            "qwen3_moe_30b_a3b", "--steps", "2", "--batch", "4", "--seq",
            "16"]


def _unflat(data, prefix: str):
    import torch
    tree = {}
    for key in data.files:
        if not key.startswith(prefix):
            continue
        node, *path = key[len(prefix):].split("/")
        parts = [node] + path
        d = tree
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = torch.from_numpy(np.array(data[key]))
    return tree


def _rel(got, want) -> float:
    import torch
    got, want = got.double(), torch.as_tensor(want).double()
    assert got.shape == want.shape, (tuple(got.shape), tuple(want.shape))
    return float((got - want).abs().max() / max(want.abs().max(), 1e-30))


def _abs(got, want) -> float:
    import torch
    return float((got.double() - torch.as_tensor(want).double()).abs().max())


def _grad_errors(errors, grads, want, ctx, tag, tol=LEAF_TOL):
    """Each leaf's local gradient slice against the same slice of the
    reference's, over the reference leaf's largest |g|."""
    from repro_torch.models.api import shard_params
    full = _flat(want, leaf=lambda t: t)
    local = _flat(shard_params(want, ctx), leaf=lambda t: t)
    got = _flat(grads, leaf=lambda t: t)
    assert sorted(got) == sorted(full)
    for name, g in got.items():
        err = float((g.double() - local[name].double()).abs().max()
                    / max(float(full[name].abs().max()), 1e-30))
        errors[f"{tag} grad {name}"] = (err, tol)


def _rank_dense(ctx, data, errors):
    import torch

    from repro_torch.launch.stepfns import make_train_step
    from repro_torch.models.api import (build_model, shard_cache,
                                        shard_params)
    from repro_torch.models.config import ModelConfig
    from repro_torch.optim import adamw_init
    cfg = ModelConfig("d", **DENSE)
    api = build_model(cfg)
    full = _unflat(data, "dense/params/")
    mine = _clone(shard_params(full, ctx))
    b2 = {"tokens": torch.from_numpy(data["dense/tokens"])}
    with torch.no_grad():
        lg, cache = api.prefill(mine, b2, ctx)
        local_lg, _ = api.prefill(full, b2)
        errors["dense prefill vs jax"] = (
            _abs(lg, data["dense/prefill_logits"]), LOGIT_TOL)
        errors["dense prefill vs port"] = (_abs(lg, local_lg), LOGIT_TOL)
        tok = torch.ones((4, 1), dtype=torch.int32)
        local_dec, _ = api.decode(full, tok, _unflat(data, "dense/cache/"),
                                  8)
        dec, _ = api.decode(mine, tok, shard_cache(cache, ctx, 16), 8, ctx)
        errors["dense decode vs jax"] = (
            _abs(dec, data["dense/decode_logits"]), LOGIT_TOL)
        errors["dense decode vs port"] = (_abs(dec, local_dec), LOGIT_TOL)
    batch = _unflat(data, "dense/batch/")
    grads = _grads(api, mine, batch, ctx)
    _grad_errors(errors, grads, _unflat(data, "dense/grads/"), ctx, "dense")
    step = make_train_step(api, ctx=ctx)
    opt, losses = adamw_init(mine), []
    for _ in range(3):
        mine, opt, m = step(mine, opt, batch)
        losses.append(float(m["loss"]))
    for i, (got, want) in enumerate(zip(losses, data["dense/losses"])):
        errors[f"dense step {i} loss"] = (abs(got - want) / abs(want),
                                          LOSS_TOL)


def _rank_vlm(ctx, data, errors):
    import torch

    from repro_torch.configs import get
    from repro_torch.models.api import (build_model, shard_cache,
                                        shard_params)
    cfg = get("qwen2_vl_2b").reduced()
    api = build_model(cfg)
    full = _unflat(data, "vlm/params/")
    mine = _clone(shard_params(full, ctx))
    batch = _unflat(data, "vlm/batch/")
    with torch.no_grad():
        lg, cache = api.prefill(mine, batch, ctx)
        errors["vlm prefill vs jax"] = (
            _abs(lg, data["vlm/prefill_logits"]), LOGIT_TOL)
        s = cache["k"].shape[2]
        tok = torch.from_numpy(np.argmax(data["vlm/prefill_logits"], -1)
                               [:, None].astype(np.int32))
        dec, _ = api.decode(mine, tok, shard_cache(cache, ctx, s + 4), s,
                            ctx)
        errors["vlm decode vs jax"] = (
            _abs(dec, data["vlm/decode_logits"]), LOGIT_TOL)


def _rank_moe(ctx, data, errors, tag):
    from repro_torch.models.api import build_model, shard_params
    from repro_torch.models.config import ModelConfig
    cfg = ModelConfig("moe", **MOE)
    api = build_model(cfg)
    mine = _clone(shard_params(_unflat(data, "moe/params/"), ctx))
    batch = _unflat(data, "moe/batch/")
    grads, loss = _grads(api, mine, batch, ctx, with_loss=True)
    errors[f"{tag} loss"] = (abs(loss - float(data["moe/loss"]))
                             / abs(float(data["moe/loss"])), LOSS_TOL)
    _grad_errors(errors, grads, _unflat(data, "moe/grads/"), ctx, tag)
    assert any("router" in k for k in errors)


def _rank_family(ctx, data, errors, mesh: str) -> None:
    """The sharded model API of ``FAMILIES[mesh]`` against the JAX
    references (``_jax_family``) and the port's local run on the same
    params, batches and decode tokens."""
    import torch

    from repro_torch.configs import get
    from repro_torch.launch.stepfns import make_train_step
    from repro_torch.models.api import (build_model, shard_cache,
                                        shard_params)
    from repro_torch.optim import adamw_init
    arch = FAMILIES[mesh]
    api = build_model(get(arch).reduced())
    full = _unflat(data, f"{arch}/params/")
    mine = _clone(shard_params(full, ctx))
    with torch.no_grad():
        pb = _unflat(data, f"{arch}/prefill_batch/")
        lg, cache = api.prefill(mine, pb, ctx)
        local_lg, _ = api.prefill(full, pb)
        errors[f"{mesh} prefill vs jax"] = (
            _abs(lg, data[f"{arch}/prefill_logits"]), LOGIT_TOL)
        errors[f"{mesh} prefill vs port"] = (_abs(lg, local_lg), LOGIT_TOL)
        local_cache = _unflat(data, f"{arch}/cache/")
        cache = shard_cache(cache, ctx, FAMILY_TOTAL)
        for i, tok in enumerate(data[f"{arch}/tokens"]):
            tok = torch.from_numpy(tok)
            local_dec, local_cache = api.decode(full, tok, local_cache,
                                                FAMILY_PROMPT + i)
            dec, cache = api.decode(mine, tok, cache, FAMILY_PROMPT + i, ctx)
            errors[f"{mesh} decode {i} vs jax"] = (
                _abs(dec, data[f"{arch}/decode_logits"][i]), LOGIT_TOL)
            errors[f"{mesh} decode {i} vs port"] = (_abs(dec, local_dec),
                                                    LOGIT_TOL)
    batch = _unflat(data, f"{arch}/batch/")
    grads = _grads(api, mine, batch, ctx)
    _grad_errors(errors, grads, _unflat(data, f"{arch}/grads/"), ctx,
                 f"{mesh} vs jax", JAX_LEAF_TOL.get(arch, LEAF_TOL))
    _grad_errors(errors, grads, _grads(api, _clone(full), batch, None), ctx,
                 f"{mesh} vs port")
    step = make_train_step(api, ctx=ctx)
    opt, losses = adamw_init(mine), []
    for _ in range(3):
        mine, opt, m = step(mine, opt, batch)
        losses.append(float(m["loss"]))
    for i, (got, want) in enumerate(zip(losses, data[f"{arch}/losses"])):
        errors[f"{mesh} step {i} loss"] = (abs(got - want) / abs(want),
                                           LOSS_TOL)


def _grads(api, params, batch, ctx, with_loss=False):
    """Step 1's gradients, averaged over the batch axes as
    ``make_train_step`` averages them (and the global loss)."""
    import torch

    from repro_torch import sharding as sh
    from repro_torch.checkpoint.partition import tree_leaves, tree_map
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = api.loss(params, batch, ctx)
    grads = torch.autograd.grad(loss, leaves)
    if ctx is not None and ctx.shard_batch:
        grads = [sh.pmean(ctx, g, ctx.batch_axes) for g in grads]
    it = iter(grads)
    tree = tree_map(lambda _: next(it), params)
    return (tree, float(loss)) if with_loss else tree


def _clone(tree):
    from repro_torch.checkpoint.partition import tree_map
    return tree_map(lambda t: t.detach().clone(), tree)


def _rank_main(job: str, npz: str, outdir: str) -> None:
    import torch.distributed as dist

    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import ShardingCtx
    if job == "raise":
        train.init_ranks(2, "cpu", timeout_s=WALL_S)
        if dist.get_rank() == 1:
            raise RuntimeError("rank 1 raised on purpose")
        dist.barrier()
        return
    # joined here, not through init_ranks, so that the rank lines in the
    # output are the CLI's own
    dist.init_process_group("gloo",
                            timeout=datetime.timedelta(seconds=WALL_S))
    rank = dist.get_rank()
    data = np.load(npz)
    for mesh_name, shape in MESHES.items():
        if len(shape) == 3:
            mesh = make_host_mesh(shape[2], pod=shape[0])
            ctx = ShardingCtx(mesh=mesh, batch_axes=("pod", "data"))
        else:
            ctx = ShardingCtx(mesh=make_host_mesh(shape[1]))
        errors = {}
        if mesh_name == "dense_2x2":
            _rank_dense(ctx, data, errors)
            _rank_vlm(ctx, data, errors)
        elif mesh_name in FAMILIES:
            _rank_family(ctx, data, errors, mesh_name)
        else:
            _rank_moe(ctx, data, errors, mesh_name)
        bad = {k: v for k, v in errors.items() if not v[0] <= v[1]}
        if bad:
            raise AssertionError(f"rank {rank}, {mesh_name}: {bad}")
        Path(outdir, f"{mesh_name}.rank{rank}.json").write_text(json.dumps(
            {"rank": rank, "mesh": mesh_name, "errors": errors}))
    train.main(CLI_ARGS)       # destroys the process group


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    _rank_main(*sys.argv[1:4])
