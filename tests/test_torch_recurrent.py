"""The port's recurrent-family LMs (``repro_torch/models/recurrent_lm.py``)
through its model API against the JAX package's, on the CPU at reduced
fp32 configs: xLSTM at 2 layers (one super-block of one mLSTM and one
sLSTM layer) and at 4 (two super-blocks), Zamba2 at 2 layers (a group of
2 and the shared site) and at 3 (then a remainder group of 1), parameters
carried across with ``from_jax_params``.  For each: the numpy init's leaf
names, shapes and dtypes (also at bf16, where the fp32 leaves stay
fp32); the loss and every gradient leaf with remat off and on (the
nested checkpoints); three train steps; prefill then two decode steps,
logits and states.  Zamba2's ``LONG_CONFIG`` (window 16 reduced) decodes
past position 16, so its sites' ring caches wrap.

Tolerances: the loss within 1e-5 relative; logits and states within 1e-5
of their largest magnitude; after the train steps, AdamW's moments as the
gradients, and the parameters within that plus 2 x the steps' summed
learning rates (``train_steps_match`` says why).
These recurrences are worse conditioned in fp32 than the decoder
families: over four seeds of each case, the two packages' fp32 gradients
lay up to 2.5e-5 of a leaf's largest magnitude apart, and each up to
2.8e-5 from the same model evaluated in float64 (the JAX package's and
the port's alike), so gradients and moments are held within 5e-5; so are
xLSTM's 4-layer logits and states (1.4e-5 apart after two decode steps,
each ~8e-6 from float64 after the prefill).  One ``launch.train --device
cpu`` run per family."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.zamba2_1_2b import LONG_CONFIG as JAX_LONG
from repro.data.synthetic import make_batch as jax_batch
from repro.launch.stepfns import make_train_step as jax_train_step
from repro.models.api import build_model as jax_build
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.checkpoint.partition import from_jax_params, to_numpy
from repro_torch.configs import get as torch_get
from repro_torch.configs.zamba2_1_2b import LONG_CONFIG
from repro_torch.data.synthetic import make_batch
from repro_torch.launch import train
from repro_torch.launch.stepfns import (make_prefill_step, make_serve_step,
                                        make_train_step)
from repro_torch.models.api import build_model
from repro_torch.optim import adamw_init

# ---------------------------------------------------------------------------
# the port's trees against the reference's (also used by
# test_torch_ssm.py and test_torch_encdec.py): every leaf within a
# tolerance of that leaf's largest magnitude (fp32 on both sides; the
# packages sum in different orders)
# ---------------------------------------------------------------------------
LEAF_TOL = 1e-5


def leaf_close(got, want, what: str, tol: float = LEAF_TOL,
               atol: float = 0.0) -> None:
    """Every element within ``tol`` of the leaf's largest magnitude (plus
    ``atol``)."""
    if torch.is_tensor(got):
        got = got.detach().float().numpy()
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale + atol, (
        f"{what}: {err / scale:.3e} of the largest |value| (atol {atol})")


def flat_jax(tree) -> dict:
    return {jax.tree_util.keystr(p): v
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def flat_torch(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_torch(v, f"{prefix}['{k}']"))
        return out
    return {prefix: tree}


def trees_close(got, want, what: str, tol: float = LEAF_TOL,
                atol: float = 0.0) -> None:
    g, w = flat_torch(got), flat_jax(want)
    assert sorted(g) == sorted(w), (what, sorted(g), sorted(w))
    for name in w:
        leaf_close(g[name], np.asarray(w[name]), f"{what} {name}", tol, atol)


def dtype_name(leaf) -> str:
    return str(leaf.dtype).replace("torch.", "")


def same_layout(got, want, what: str) -> None:
    """The port's tree (tensors) has the reference's leaf names, shapes
    and dtypes (arrays or ``jax.ShapeDtypeStruct``s)."""
    g, w = flat_torch(got), flat_jax(want)
    assert sorted(g) == sorted(w), (what, sorted(g), sorted(w))
    for name in w:
        assert tuple(g[name].shape) == tuple(w[name].shape), (what, name)
        assert dtype_name(g[name]) == dtype_name(w[name]), (
            what, name, g[name].dtype, w[name].dtype)


def carries_reference_tree(japi) -> None:
    """``from_jax_params`` carries the reference's own init (any dtype,
    bf16 through ml_dtypes) across unchanged: names, shapes, dtypes and
    every leaf's bits."""
    want = jax.tree.map(np.asarray, jax.jit(japi.init)(jax.random.PRNGKey(0)))
    got = from_jax_params(want, device="cpu")
    same_layout(got, want, "carried init")
    g, w = flat_torch(got), flat_jax(want)
    for name in w:
        half = g[name].dtype == torch.bfloat16
        got_bits = g[name].view(torch.int16 if half else torch.int32)
        assert np.array_equal(got_bits.numpy(), w[name].view(
            np.int16 if half else np.int32)), name


def requires_grad(tree) -> list:
    """Every leaf of a tensor tree set to record gradients, in order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in requires_grad(tree[k])]
    tree.requires_grad_(True)
    return [tree]


def like(tree, leaves):
    """``leaves`` (in ``requires_grad`` order) in ``tree``'s structure."""
    it = iter(leaves)

    def rebuild(t):
        return ({k: rebuild(v) for k, v in t.items()} if isinstance(t, dict)
                else next(it))
    return rebuild(tree)


# ---------------------------------------------------------------------------
# the model API against the reference's
# ---------------------------------------------------------------------------
def jax_loss_and_grads(japi, params, jbatch):
    """(loss, metrics, gradients) of the reference's ``api.loss``, jitted;
    its ``cfg.remat`` changes none of them."""
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: japi.loss(p, b), has_aux=True))(params, jbatch)
    return jl, jm, jg


def loss_and_grads_match(tapi, params, tbatch, ref, loss_rtol: float = 1e-5,
                         grad_tol: float = LEAF_TOL) -> None:
    """The port's ``api.loss`` and the gradient of every parameter leaf
    (within ``grad_tol`` of its largest magnitude) against the reference's
    ``ref`` (``jax_loss_and_grads``)."""
    jl, jm, jg = ref
    tparams = from_jax_params(params, device="cpu")
    leaves = requires_grad(tparams)
    tl, tm = tapi.loss(tparams, tbatch)
    grads = torch.autograd.grad(tl, leaves)
    assert abs(float(tl.detach()) - float(jl)) <= loss_rtol * abs(float(jl))
    assert abs(float(tm["xent"].detach()) - float(jm["xent"])) <= (
        loss_rtol * abs(float(jm["xent"])))
    trees_close(like(tparams, grads), jg, "grad", grad_tol)


def train_steps_match(japi, tapi, params, batches, loss_rtol: float = 1e-5,
                      tol: float = LEAF_TOL) -> None:
    """Train steps of the port's ``make_train_step`` against the
    reference's jitted step, one per (jax batch, torch batch) of
    ``batches``: each loss within ``loss_rtol`` and learning rate; then
    AdamW's moments (``mu`` and the square root of ``nu``: weighted sums of
    the steps' gradients and the root of those of their squares) within
    ``tol`` of their leaf's largest magnitude, and every
    parameter within ``tol`` of its leaf's largest magnitude plus 2 x the
    steps' summed learning rates.  An AdamW step moves an element by about
    its rate whatever the size of its gradient, so an element whose
    gradient sits at the two packages' fp32 noise floor (every element of
    a zero-initialised leaf, among others) may step another way in each;
    the moments hold the gradients themselves."""
    jstep = jax.jit(jax_train_step(japi, None))
    tstep = make_train_step(tapi)
    jp = jax.tree.map(jax.numpy.asarray, params)
    jopt = jax_adamw_init(jp)
    tparams = from_jax_params(params, device="cpu")
    topt = adamw_init(tparams)
    lr_sum = 0.0
    for jb, tb in batches:
        jp, jopt, jm = jstep(jp, jopt, jb)
        tparams, topt, tm = tstep(tparams, topt, tb)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= (
            loss_rtol * abs(float(jm["loss"])))
        assert abs(tm["lr"] - float(jm["lr"])) <= 1e-6 * abs(float(jm["lr"]))
        lr_sum += tm["lr"]
    trees_close(topt["mu"], jopt["mu"], "AdamW mu after the steps", tol)
    trees_close(jax.tree.map(torch.sqrt, topt["nu"]),
                jax.tree.map(jax.numpy.sqrt, jopt["nu"]),
                "AdamW sqrt(nu) after the steps", tol)
    trees_close(tparams, jp, "params after the steps", tol, atol=2 * lr_sum)


# ---------------------------------------------------------------------------
# xLSTM and Zamba2
# ---------------------------------------------------------------------------
BATCH, SEQ = 2, 16
CASES = {"xlstm-2": ("xlstm_1_3b", {}),
         "xlstm-4": ("xlstm_1_3b", {"num_layers": 4}),
         "zamba-2": ("zamba2_1_2b", {}),
         "zamba-3": ("zamba2_1_2b", {"num_layers": 3})}
GRAD_TOL = 5e-5                # the fp32 floor above
FWD_TOL = {"xlstm-4": 5e-5}    # else 1e-5


def _cfgs(arch: str, **kw):
    return (get_config(arch).reduced().with_(**kw),
            torch_get(arch).reduced().with_(**kw))


@pytest.fixture(scope="module", params=sorted(CASES))
def model(request):
    """(jax cfg, torch cfg, jax api, torch api, the port's init as numpy,
    the case): both packages run on the port's seeded draw."""
    arch, kw = CASES[request.param]
    jcfg, tcfg = _cfgs(arch, **kw)
    japi, tapi = jax_build(jcfg), build_model(tcfg)
    params = to_numpy(tapi.init(np.random.default_rng(0), "cpu"))
    return jcfg, tcfg, japi, tapi, params, request.param


def _batches(jcfg, tcfg, seed: int, seq: int = SEQ):
    return jax_batch(jcfg, BATCH, seq, seed), make_batch(tcfg, BATCH, seq,
                                                         seed)


@pytest.fixture(scope="module")
def reference_grads(model):
    """The reference's loss and gradients on batch seed 1."""
    jcfg, tcfg, japi, _, params, _ = model
    return jax_loss_and_grads(japi, params, _batches(jcfg, tcfg, 1)[0])


def test_init_layout_matches_jax(model):
    jcfg, tcfg, japi, tapi, _, _ = model
    same_layout(tapi.init(np.random.default_rng(0), "cpu"),
                jax.eval_shape(japi.init, jax.random.PRNGKey(0)), "init")
    bf = jax.eval_shape(jax_build(jcfg.with_(dtype="bfloat16")).init,
                        jax.random.PRNGKey(0))
    same_layout(build_model(tcfg.with_(dtype="bfloat16")).init(
        np.random.default_rng(0), "cpu"), bf, "init bf16")
    same_layout(tapi.empty_cache(BATCH, SEQ, device="cpu"),
                jax.eval_shape(lambda: japi.empty_cache(BATCH, SEQ)),
                "empty cache")


def test_reference_tree_carries_across(model):
    """At bf16, with xLSTM's doubly stacked mLSTM leaves."""
    jcfg = model[0]
    carries_reference_tree(jax_build(jcfg.with_(dtype="bfloat16")))


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(model, reference_grads, remat):
    jcfg, tcfg, _, _, params, case = model
    loss_and_grads_match(build_model(tcfg.with_(remat=remat)), params,
                         _batches(jcfg, tcfg, 1)[1], reference_grads,
                         grad_tol=GRAD_TOL)


def test_three_train_steps_match_jax(model):
    jcfg, tcfg, japi, tapi, params, _ = model
    train_steps_match(japi, tapi, params,
                      [_batches(jcfg, tcfg, 10 + i) for i in range(3)],
                      tol=GRAD_TOL)


def _decode_cache(jcfg, tapi, jcache, tcache, total: int):
    """The prefill caches as decode caches of ``total`` slots: xLSTM's
    state as it is; Zamba2's site caches copied into the head of
    ``empty_cache``'s (a ring at the window, when there is one)."""
    if jcfg.family == "xlstm":
        return jcache, tcache
    s = jcache["attn"]["k"].shape[2]
    jc = jax_build(jcfg).empty_cache(BATCH, total)
    jc["mamba"] = jcache["mamba"]
    jc["attn"] = jax.tree.map(lambda e, f: e.at[:, :, :s].set(f),
                              jc["attn"], jcache["attn"])
    tc = tapi.empty_cache(BATCH, total, device="cpu")
    tc["mamba"] = tcache["mamba"]
    for k in tc["attn"]:
        tc["attn"][k][:, :, :s] = tcache["attn"][k]
    return jc, tc


def _prefill_then_decode(jcfg, tcfg, japi, tapi, params, steps: int,
                         seq: int = SEQ, tol: float = 1e-5):
    """Prefill ``seq`` tokens, then ``steps`` decode steps on the
    reference's greedy tokens, logits held each step and the caches at
    the end."""
    jb, tb = _batches(jcfg, tcfg, 3, seq)
    tparams = from_jax_params(params, device="cpu")
    jlog, jcache = jax.jit(japi.prefill)(params, jb)
    tlog, tcache = make_prefill_step(tapi)(tparams, tb)
    leaf_close(tlog, jlog, "prefill logits", tol)
    trees_close(tcache, jcache, "prefill cache", tol)
    jc, tc = _decode_cache(jcfg, tapi, jcache, tcache, seq + steps)
    jdec, tdec = jax.jit(japi.decode), make_serve_step(tapi)
    tok = np.argmax(np.asarray(jlog), -1)[:, None].astype(np.int32)
    for pos in range(seq, seq + steps):
        jlog, jc = jdec(params, jnp.asarray(tok), jc, pos)
        tlog, tc = tdec(tparams, torch.from_numpy(tok), tc, pos)
        leaf_close(tlog, jlog, f"decode logits at {pos}", tol)
        tok = np.argmax(np.asarray(jlog), -1)[:, None].astype(np.int32)
    trees_close(tc, jc, "decode cache", tol)


def test_prefill_and_decode_match_jax(model):
    *model, case = model
    _prefill_then_decode(*model, steps=2, tol=FWD_TOL.get(case, 1e-5))


def test_zamba_window_ring_matches_jax():
    """Window 16: 8 prompt tokens, then 12 decode steps to position 19,
    so each site's 16-slot ring overwrites its oldest keys."""
    jcfg, tcfg = JAX_LONG.reduced(), LONG_CONFIG.reduced()
    assert tcfg.sliding_window == 16
    japi, tapi = jax_build(jcfg), build_model(tcfg)
    params = to_numpy(tapi.init(np.random.default_rng(1), "cpu"))
    _prefill_then_decode(jcfg, tcfg, japi, tapi, params, steps=12, seq=8)


@pytest.mark.parametrize("arch", ["xlstm_1_3b", "zamba2_1_2b"])
def test_train_cli_runs_on_cpu(arch, capsys):
    train.main(["--device", "cpu", "--arch", arch, "--steps", "2",
                "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "step    0 loss=" in out and "step    1 loss=" in out
    assert "first loss " in out and " -> last loss " in out
