"""The port's model API and training path against the JAX package's, on
the CPU at reduced configs: the synthetic batches element for element,
AdamW and the cosine schedule, the chunked cross-entropy and its
gradient, the plain flash-attention backward against ``jax.vjp`` of the
reference's custom-VJP attention, and for five archs (dense GQA, sliding
window, MoE with its aux loss, MLA, VLM with M-RoPE and patches) the loss
and every gradient leaf, three ``make_train_step`` steps against the
reference's jitted step, and ``prefill`` / ``decode`` logits; parameters
carried across with ``from_jax_params``.

Tolerances (fp32 on both sides; the packages sum in different orders):
loss within rtol 1e-5; each gradient leaf, and each parameter after 3
steps, within 1e-5 of that leaf's largest magnitude; logits and the
attention gradients within 1e-5 of their largest magnitude; the
optimiser's moments within 1e-5 of their largest magnitude and the
schedule within 1e-6 relative."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.data.synthetic import make_batch as jax_batch
from repro.launch.stepfns import make_train_step as jax_train_step
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models.api import build_model as jax_build
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import cosine_lr as jax_cosine_lr
from repro_torch.checkpoint.partition import from_jax_params
from repro_torch.configs import get as torch_get
from repro_torch.data.synthetic import make_batch
from repro_torch.kernels import ref
from repro_torch.launch import train
from repro_torch.launch.stepfns import (make_prefill_step, make_serve_step,
                                        make_train_step)
from repro_torch.models import common
from repro_torch.models.api import build_model
from repro_torch.optim import adamw_init, adamw_update, cosine_lr

LOSS_RTOL = 1e-5
LEAF_TOL = 1e-5         # of each leaf's largest magnitude
ARCHS = ("gpt2_base", "yi_9b", "qwen3_moe_30b_a3b", "minicpm3_4b",
         "qwen2_vl_2b")
BATCH = 2


def _seq(cfg) -> int:
    # a VLM's sequence holds its num_patches (16 reduced) patches first
    return 24 if cfg.family == "vlm" else 32


def _leaf_close(got, want, what: str, tol: float = LEAF_TOL) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"{what}: {err:.3e} of the largest |value|"


def _flat_jax(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_torch(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_torch(v, f"{prefix}['{k}']"))
        return out
    return {prefix: tree.detach().numpy()}


def _trees_close(got, want, what: str) -> None:
    g, w = _flat_torch(got), _flat_jax(want)
    assert sorted(g) == sorted(w), what
    for name in w:
        _leaf_close(g[name], w[name], f"{what} {name}")


def _cfgs(arch: str, **kw):
    return (get_config(arch).reduced().with_(**kw),
            torch_get(arch).reduced().with_(**kw))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(jax cfg, torch cfg, jax api, torch api, the JAX init as numpy)."""
    jcfg, tcfg = _cfgs(request.param)
    japi, tapi = jax_build(jcfg), build_model(tcfg)
    params = jax.tree.map(np.asarray, japi.init(jax.random.PRNGKey(0)))
    return jcfg, tcfg, japi, tapi, params


# ---------------------------------------------------------------------------
# data, optimiser, loss pieces
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS + ("seamless_m4t_medium",))
def test_make_batch_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    for seed in (0, 5):
        want = jax_batch(jcfg, 3, _seq(jcfg), seed)
        got = make_batch(tcfg, 3, _seq(tcfg), seed)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=k)


def test_adamw_and_cosine_match_jax():
    """Three AdamW steps on a random tree (one bf16-moment variant) at the
    schedule's rates, in place, against the reference's pure update."""
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 5), "b": {"c": (7,), "d": (3, 2, 2)}}

    def tree(fn, s=shapes):
        return {k: tree(fn, v) if isinstance(v, dict) else fn(v)
                for k, v in s.items()}
    params = tree(lambda s: rng.standard_normal(s).astype(np.float32))
    grads = [tree(lambda s: rng.standard_normal(s).astype(np.float32))
             for _ in range(3)]
    for step in (0, 1, 50, 100, 101, 5000, 10_000, 12_000):
        assert cosine_lr(step) == pytest.approx(
            float(jax_cosine_lr(jnp.int32(step))), rel=1e-6)
    for moment in (torch.float32, torch.bfloat16):
        jmoment = jnp.float32 if moment == torch.float32 else jnp.bfloat16
        jp = jax.tree.map(jnp.asarray, params)
        jopt = jax_adamw_init(jp, jmoment)
        tparams = from_jax_params(params, device="cpu")
        topt = adamw_init(tparams, moment)
        for g in grads:
            lr = jax_cosine_lr(jopt["step"] + 1)
            jp, jopt = jax_adamw_update(jax.tree.map(jnp.asarray, g), jopt,
                                        jp, lr=lr)
            out, topt = adamw_update(from_jax_params(g, device="cpu"), topt,
                                     tparams, lr=cosine_lr(topt["step"] + 1))
            assert out is tparams
        assert topt["step"] == int(jopt["step"]) == 3
        _trees_close(tparams, jp, "params")
        for m in ("mu", "nu"):
            _trees_close(jax.tree.map(lambda t: t.float(), topt[m]),
                         jax.tree.map(lambda a: a.astype(jnp.float32),
                                      jopt[m]), m)


def test_chunked_softmax_xent_and_grad_match_jax():
    rng = np.random.default_rng(1)
    b, s, d, v = 2, 12, 16, 40
    h = rng.standard_normal((b, s, d)).astype(np.float32)
    w = rng.standard_normal((d, v)).astype(np.float32) * 0.3
    y = rng.integers(0, v, (b, s)).astype(np.int32)
    jl, (jgh, jgw) = jax.value_and_grad(
        lambda a, c: jcommon.chunked_softmax_xent(a, c, jnp.asarray(y)),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    tl = common.chunked_softmax_xent(th, tw, torch.from_numpy(y))
    tl.backward()
    assert float(tl.detach()) == pytest.approx(float(jl), rel=LOSS_RTOL)
    _leaf_close(th.grad, jgh, "d hidden")
    _leaf_close(tw.grad, jgw, "d lm_head")


@pytest.mark.parametrize("causal,window,g,dqk,dv", [
    (True, None, 1, 32, 32),
    (True, 5, 1, 32, 32),
    (True, None, 3, 32, 32),
    (True, None, 2, 48, 32),
    (False, None, 2, 16, 16)])
def test_attention_bwd_ref_matches_jax_vjp(causal, window, g, dqk, dv):
    """``attention_gqa_lse_ref`` and ``attention_gqa_bwd_ref`` against the
    reference's ``chunked_attention`` and ``jax.vjp`` of it (its custom
    VJP): outputs and (dq, dk, dv)."""
    rng = np.random.default_rng(2)
    b, s, kv = 2, 20, 2
    q = rng.standard_normal((b, s, kv, g, dqk)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, dqk)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, dv)).astype(np.float32)
    d_out = rng.standard_normal((b, s, kv, g, dv)).astype(np.float32)
    jout, vjp = jax.vjp(lambda a, c, e: jattn.chunked_attention(
        a, c, e, causal=causal, window=window, block_q=8, block_k=4),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(d_out))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = ref.attention_gqa_lse_ref(tq, tk, tv, causal=causal,
                                         window=window)
    _leaf_close(out, jout, "out")
    _leaf_close(out, ref.attention_gqa_ref(tq, tk, tv, causal=causal,
                                           window=window), "out vs plain")
    grads = ref.attention_gqa_bwd_ref(tq, tk, tv, out, lse,
                                      torch.from_numpy(d_out),
                                      causal=causal, window=window)
    for name, got, want in zip(("dq", "dk", "dv"), grads, jgrads):
        _leaf_close(got, want, name)


@pytest.mark.parametrize("arch", ["seamless_m4t_medium", "xlstm_1_3b",
                                  "zamba2_1_2b"])
def test_unported_families_raise(arch):
    """The enc-dec, xLSTM and Zamba2 families, once refused, now build
    (their parity with the JAX package is ``test_torch_encdec.py``'s and
    ``test_torch_recurrent.py``'s) and run under a sharding ctx
    (``test_torch_sharding.py``); a ctx that is not a ``ShardingCtx``
    raises ``TypeError``."""
    api = build_model(torch_get(arch).reduced())
    params = api.init(np.random.default_rng(0), "cpu")
    batch = make_batch(api.cfg, BATCH, 16, 0)
    for call in (lambda: api.loss(params, batch, ctx=object()),
                 lambda: api.prefill(params, batch, ctx=object()),
                 lambda: api.decode(params, batch["tokens"][:, :1],
                                    api.empty_cache(BATCH, 16,
                                                    device="cpu"), 0,
                                    ctx=object())):
        with pytest.raises(TypeError, match="ctx must be a ShardingCtx"):
            call()


# ---------------------------------------------------------------------------
# the model API and the train step, per arch
# ---------------------------------------------------------------------------
def _requires_grad(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in _requires_grad(tree[k])]
    tree.requires_grad_(True)
    return [tree]


def _loss_and_grads_match(jcfg, tcfg, japi, tapi, params):
    jb = jax_batch(jcfg, BATCH, _seq(jcfg), 1)
    (jl, jm), jg = jax.value_and_grad(lambda p, b: japi.loss(p, b),
                                      has_aux=True)(params, jb)
    tparams = from_jax_params(params, device="cpu")
    leaves = _requires_grad(tparams)
    tl, tm = tapi.loss(tparams, make_batch(tcfg, BATCH, _seq(tcfg), 1))
    grads = torch.autograd.grad(tl, leaves)
    tl, tm = tl.detach(), {k: v.detach() for k, v in tm.items()}
    assert float(tl) == pytest.approx(float(jl), rel=LOSS_RTOL)
    assert float(tm["xent"]) == pytest.approx(float(jm["xent"]),
                                              rel=LOSS_RTOL)
    assert float(tm["aux"]) == pytest.approx(float(jm["aux"]), rel=LOSS_RTOL,
                                             abs=1e-7)
    it = iter(grads)

    def rebuild(t):
        return ({k: rebuild(v) for k, v in t.items()} if isinstance(t, dict)
                else next(it))
    _trees_close(rebuild(tparams), jg, "grad")
    return float(jm["aux"])


def test_loss_and_grads_match_jax(model):
    jcfg, tcfg, japi, tapi, params = model
    aux = _loss_and_grads_match(jcfg, tcfg, japi, tapi, params)
    assert (aux > 0) == (jcfg.family == "moe")


def test_loss_and_grads_match_jax_with_remat():
    """``cfg.remat``: every layer under ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint``), the same loss and gradients."""
    jcfg, tcfg = _cfgs("gpt2_base", remat=True)
    japi, tapi = jax_build(jcfg), build_model(tcfg)
    params = jax.tree.map(np.asarray, japi.init(jax.random.PRNGKey(3)))
    _loss_and_grads_match(jcfg, tcfg, japi, tapi, params)


def test_three_train_steps_match_jax(model):
    jcfg, tcfg, japi, tapi, params = model
    jstep = jax.jit(jax_train_step(japi, None))
    tstep = make_train_step(tapi)
    jp, jopt = jax.tree.map(jnp.asarray, params), None
    jopt = jax_adamw_init(jp)
    tparams = from_jax_params(params, device="cpu")
    topt = adamw_init(tparams)
    for i in range(3):
        jb = jax_batch(jcfg, BATCH, _seq(jcfg), 10 + i)
        jp, jopt, jm = jstep(jp, jopt, jb)
        tparams, topt, tm = tstep(tparams, topt,
                                  make_batch(tcfg, BATCH, _seq(tcfg), 10 + i))
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=LOSS_RTOL)
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    _trees_close(tparams, jp, "params after 3 steps")


def test_grad_accum_sums_microbatches():
    """``grad_accum=2`` takes the same step as one full batch, up to the
    order of the sums (the reference's scan over microbatches)."""
    _, tcfg = _cfgs("gpt2_base")
    api = build_model(tcfg)
    runs = []
    for accum in (1, 2):
        params = api.init(np.random.default_rng(4), "cpu")
        opt = adamw_init(params)
        params, opt, m = make_train_step(api, accum)(
            params, opt, make_batch(tcfg, 4, 16, 2))
        runs.append((params, float(m["loss"])))
    assert runs[1][1] == pytest.approx(runs[0][1], rel=1e-5)
    a, b = _flat_torch(runs[1][0]), _flat_torch(runs[0][0])
    for name in b:
        _leaf_close(a[name], b[name], name)


def test_prefill_and_decode_match_jax(model):
    """``api.prefill`` then two ``api.decode`` steps (the cache written in
    place) against the reference's logits, through the step functions."""
    jcfg, tcfg, japi, tapi, params = model
    jb = jax_batch(jcfg, BATCH, _seq(jcfg), 3)
    tb = make_batch(tcfg, BATCH, _seq(tcfg), 3)
    tparams = from_jax_params(params, device="cpu")
    jlog, jcache = japi.prefill(params, jb)
    tlog, tcache = make_prefill_step(tapi)(tparams, tb)
    _leaf_close(tlog, jlog, "prefill logits")
    s = _seq(tcfg)
    total = s + 2
    jc = jax.tree.map(lambda a: jnp.pad(a, ((0, 0), (0, 0), (0, 2))
                                        + ((0, 0),) * (a.ndim - 3)), jcache)
    tc = tapi.empty_cache(BATCH, total, device="cpu")
    for key in tc:
        tc[key][:, :, :s] = tcache[key]
    serve_step = make_serve_step(tapi)
    tok = np.argmax(np.asarray(jlog), -1)[:, None].astype(np.int32)
    for pos in (s, s + 1):
        jlog, jc = japi.decode(params, jnp.asarray(tok), jc, pos)
        tlog, tc = serve_step(tparams, torch.from_numpy(tok), tc, pos)
        _leaf_close(tlog, jlog, f"decode logits at {pos}")
        tok = np.argmax(np.asarray(jlog), -1)[:, None].astype(np.int32)
    for key in tc:
        _leaf_close(tc[key], jc[key], f"cache {key}")


def test_train_cli_runs_on_cpu(capsys):
    train.main(["--device", "cpu", "--arch", "gpt2_base", "--steps", "3",
                "--batch", "2", "--seq", "32"])
    out = capsys.readouterr().out
    assert "step    0 loss=" in out and "step    2 loss=" in out
    assert "first loss " in out and " -> last loss " in out


def test_train_cli_refuses_a_mesh_and_a_missing_card(monkeypatch):
    # a mesh needs a world of ranks (torch.distributed.run); this
    # process is a world of 1, and the error names both numbers
    with pytest.raises(SystemExit, match="--model-axis 2 needs .* the world "
                       "has 1 "):
        train.main(["--device", "cpu", "--arch", "gpt2_base",
                    "--model-axis", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        train.main(["--arch", "gpt2_base", "--steps", "1"])
