"""The port's encoder-decoder LM (``repro_torch/models/encdec_lm.py``,
seamless_m4t_medium reduced: 2 encoder and 2 decoder layers over 32
frames, fp32) through its model API against the JAX package's, both on
the port's seeded init: the init's leaf names, shapes and dtypes (also at
bf16); the loss and every gradient leaf with remat off and on; three
train steps; prefill then two decode steps, logits and caches, with the
frames filling the cross cache and with 24 frames, so that decode also
attends the zero rows ``empty_cache`` leaves past them, as the reference
does.  ``cross_attn_apply`` at one query (the flash-decode path) and at 8
queries against 32 keys (non-causal prefill attention at Sq != Sk)
against the reference's.  Tolerances: the loss within 1e-5 relative;
gradients, logits, caches and attention outputs within 1e-5 of their
largest magnitude; after the train steps, AdamW's moments so and the
parameters so plus 2 x the steps' summed learning rates
(``test_torch_recurrent.train_steps_match`` says why).  One
``launch.train --device cpu`` run."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_recurrent import (carries_reference_tree, jax_loss_and_grads,
                                  leaf_close, loss_and_grads_match,
                                  same_layout, train_steps_match, trees_close)
from repro.configs import get_config
from repro.data.synthetic import make_batch as jax_batch
from repro.models import attention as jattn
from repro.models.api import build_model as jax_build
from repro_torch.checkpoint.partition import from_jax_params, to_numpy
from repro_torch.configs import get as torch_get
from repro_torch.data.synthetic import make_batch
from repro_torch.launch import train
from repro_torch.launch.stepfns import make_prefill_step, make_serve_step
from repro_torch.models import attention
from repro_torch.models.api import build_model

BATCH, SEQ = 2, 16
JCFG = get_config("seamless_m4t_medium").reduced()
CFG = torch_get("seamless_m4t_medium").reduced()


@pytest.fixture(scope="module")
def model():
    """(jax api, torch api, the port's init as numpy)."""
    tapi = build_model(CFG)
    return (jax_build(JCFG), tapi,
            to_numpy(tapi.init(np.random.default_rng(0), "cpu")))


def _batches(seed: int, frames: int = JCFG.enc_seq_len):
    jb, tb = jax_batch(JCFG, BATCH, SEQ, seed), make_batch(CFG, BATCH, SEQ,
                                                           seed)
    jb["frames"], tb["frames"] = jb["frames"][:, :frames], tb["frames"][
        :, :frames]
    return jb, tb


def test_init_layout_matches_jax(model):
    japi, tapi, _ = model
    same_layout(tapi.init(np.random.default_rng(0), "cpu"),
                jax.eval_shape(japi.init, jax.random.PRNGKey(0)), "init")
    same_layout(build_model(CFG.with_(dtype="bfloat16")).init(
        np.random.default_rng(0), "cpu"),
        jax.eval_shape(jax_build(JCFG.with_(dtype="bfloat16")).init,
                       jax.random.PRNGKey(0)), "init bf16")
    same_layout(tapi.empty_cache(BATCH, SEQ, device="cpu"),
                jax.eval_shape(lambda: japi.empty_cache(BATCH, SEQ)),
                "empty cache")


def test_reference_tree_carries_across():
    carries_reference_tree(jax_build(JCFG.with_(dtype="bfloat16")))


@pytest.fixture(scope="module")
def reference_grads(model):
    japi, _, params = model
    return jax_loss_and_grads(japi, params, _batches(1)[0])


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(model, reference_grads, remat):
    _, _, params = model
    loss_and_grads_match(build_model(CFG.with_(remat=remat)), params,
                         _batches(1)[1], reference_grads)


def test_three_train_steps_match_jax(model):
    japi, tapi, params = model
    train_steps_match(japi, tapi, params, [_batches(10 + i)
                                           for i in range(3)])


@pytest.mark.parametrize("frames", [JCFG.enc_seq_len, 24])
def test_prefill_and_decode_match_jax(model, frames):
    japi, tapi, params = model
    jb, tb = _batches(3, frames)
    tparams = from_jax_params(params, device="cpu")
    jlog, jcache = jax.jit(japi.prefill)(params, jb)
    tlog, tcache = make_prefill_step(tapi)(tparams, tb)
    leaf_close(tlog, jlog, "prefill logits")
    trees_close(tcache, jcache, "prefill cache")
    total = SEQ + 2
    jc = jax.tree.map(lambda e, f: e.at[:, :, :f.shape[2]].set(f),
                      japi.empty_cache(BATCH, total), jcache)
    tc = tapi.empty_cache(BATCH, total, device="cpu")
    for part in tc:
        for k in tc[part]:
            tc[part][k][:, :, :tcache[part][k].shape[2]] = tcache[part][k]
    jdec, tdec = jax.jit(japi.decode), make_serve_step(tapi)
    tok = np.argmax(np.asarray(jlog), -1)[:, None].astype(np.int32)
    for pos in (SEQ, SEQ + 1):
        jlog, jc = jdec(params, jnp.asarray(tok), jc, pos)
        tlog, tc = tdec(tparams, torch.from_numpy(tok), tc, pos)
        leaf_close(tlog, jlog, f"decode logits at {pos}")
        tok = np.argmax(np.asarray(jlog), -1)[:, None].astype(np.int32)
    trees_close(tc, jc, "decode cache")


@pytest.mark.parametrize("sq", [1, 8])
def test_cross_attn_apply_matches_jax(model, sq):
    """Queries of 2 rows against 32 encoder frames' K / V."""
    _, _, params = model
    p = jax.tree.map(lambda a: a[0], params["dec_layers"]["cross_attn"])
    rng = np.random.default_rng(6)
    enc = rng.standard_normal((BATCH, 32, CFG.d_model)).astype(np.float32)
    x = rng.standard_normal((BATCH, sq, CFG.d_model)).astype(np.float32)
    jkv = jattn.cross_attn_prefill_kv(p, jnp.asarray(enc), JCFG, None)
    want = jattn.cross_attn_apply(p, jnp.asarray(x), jkv, JCFG, None)
    tp = from_jax_params(p, device="cpu")
    with torch.no_grad():
        tkv = attention.cross_attn_prefill_kv(tp, torch.from_numpy(enc), CFG)
        got = attention.cross_attn_apply(tp, torch.from_numpy(x), tkv, CFG)
    trees_close(tkv, jkv, "cross kv")
    leaf_close(got, want, f"cross attention at sq={sq}")


def test_train_cli_runs_on_cpu(capsys):
    train.main(["--device", "cpu", "--arch", "seamless_m4t_medium",
                "--steps", "2", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "step    0 loss=" in out and "step    1 loss=" in out
    assert "first loss " in out and " -> last loss " in out
