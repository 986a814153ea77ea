"""Training launcher, PyTorch port of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2_base \
        --steps 20 --batch 8 --seq 256 [--full] [--device cuda|cpu]

Trains any registered config through the model API (``models/api.py``):
the decoder families (dense, MoE, VLM; GQA or MLA attention), the
encoder-decoder (``--arch seamless_m4t_medium``, whose batches carry
audio-frame embeddings), xLSTM (``xlstm_1_3b``) and the Mamba2 hybrid
(``zamba2_1_2b``), from seeded random weights on the seeded synthetic
batches (``data/synthetic.py``), with AdamW at the cosine schedule
(``launch/stepfns.py``): the reduced config unless ``--full``.  It runs
on the card unless ``--device cpu`` is asked for (asking for CUDA without
a card raises); on the card every attention and its backward run the
hand-written kernels, and float32 products run in full fp32 (TF32 off).
It prints the reference's step lines and ``first loss ... -> last loss
...``.  ``--model-axis`` above 1 (a device mesh) exits "not yet ported in
repro_torch" before any work.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint.partition import from_jax_params
from repro_torch.configs import get
from repro_torch.core.engine import resolve_device
from repro_torch.data.synthetic import batch_iterator
from repro_torch.launch.stepfns import make_train_step
from repro_torch.models.api import build_model
from repro_torch.optim import adamw_init


def run(arch, *, steps: int = 20, batch: int = 8, seq: int = 256,
        reduced: bool = True, model_axis: int = 1, log_every: int = 10,
        seed: int = 0, device: str = "cuda", attn_impl="auto",
        step_seconds: list | None = None, params=None):
    """Train ``steps`` steps; returns the losses.  ``arch`` is a registered
    name (cut by ``reduced``) or a model config used as given;
    ``attn_impl=None`` runs the kernels' plain versions.  Each step's wall
    seconds (to its loss on the host) are appended to ``step_seconds``.
    ``params``, a numpy tree as the family's init draws it, starts the
    run instead of a draw from ``seed`` (the batches still follow
    ``seed``)."""
    if model_axis > 1:
        raise SystemExit(f"error: --model-axis {model_axis} (a device mesh) "
                         f"is not yet ported in repro_torch")
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get(arch) if isinstance(arch, str) else arch
    if isinstance(arch, str) and reduced:
        cfg = cfg.reduced()
    api = build_model(cfg, attn_impl=attn_impl)
    params = (api.init(np.random.default_rng(seed), dev) if params is None
              else from_jax_params(params, dev))
    opt_state = adamw_init(params)
    step = make_train_step(api)
    it = batch_iterator(cfg, batch, seq, seed=seed)

    losses = []
    t0 = time.time()
    for i in range(steps):
        t_step = time.time()
        b = {k: v.to(dev) for k, v in next(it).items()}
        params, opt_state, metrics = step(params, opt_state, b)
        losses.append(float(metrics["loss"]))
        if step_seconds is not None:
            step_seconds.append(time.time() - t_step)
        if i % log_every == 0 or i == steps - 1:
            print(f"step {i:4d} loss={losses[-1]:.4f} "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)", flush=True)
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--full", action="store_true",
                    help="full-size config (default: the reduced one)")
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    losses = run(args.arch, steps=args.steps, batch=args.batch,
                 seq=args.seq, reduced=not args.full,
                 model_axis=args.model_axis, device=args.device)
    print(f"first loss {losses[0]:.4f} -> last loss {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
