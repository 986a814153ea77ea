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
...``.

``--model-axis N`` trains on a device mesh of (world / N, N) ranks
("data", "model"; ``launch/mesh.py``), each rank one process started by
``torch.distributed.run``:

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.train --device cpu --model-axis 2 \
        --arch qwen3_moe_30b_a3b --steps 3 --batch 4 --seq 32

Each rank reads RANK / WORLD_SIZE / LOCAL_RANK (and MASTER_ADDR /
MASTER_PORT) from its environment, uses ``cuda:(LOCAL_RANK % cards)``
(or the CPU with ``--device cpu``), draws the full parameters from the
seed and keeps its slices (``models/api.shard_params``); the batch's rows
split over "data" when the data axis divides it.  The process group's
backend is NCCL when every rank on the host has a card of its own, gloo
on the CPU and when ranks share a card (NCCL refuses two ranks on one
device); each rank prints its backend and device.  A world smaller than
the model axis exits with an error naming both, where the reference
trains unsharded.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.partition import from_jax_params, tree_map
from repro_torch.configs import get
from repro_torch.core.engine import resolve_device
from repro_torch.data.synthetic import batch_iterator
from repro_torch.launch.mesh import (DEFAULT_TIMEOUT_S, batch_axes_of,
                                     make_host_mesh, mesh_shape)
from repro_torch.launch.stepfns import make_train_step
from repro_torch.models.api import build_model, shard_params
from repro_torch.optim import adamw_init
from repro_torch.sharding import ShardingCtx


def init_ranks(model_axis: int, device: str = "cuda", *,
               timeout_s: float = DEFAULT_TIMEOUT_S):
    """This process's rank of a ``torch.distributed.run`` launch: the
    process group (NCCL when each rank on the host has a card of its own,
    else gloo) with a ``timeout_s`` timeout, a handshake all-reduce on the
    rank's device, and the (world / model_axis, model_axis) mesh.  Returns
    (mesh, device, backend).  Raises SystemExit when the world is smaller
    than the model axis or does not split into it."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    local = int(os.environ.get("LOCAL_RANK", str(rank)))
    if world < model_axis or world % model_axis:
        raise SystemExit(
            f"error: --model-axis {model_axis} needs a world of ranks it "
            f"divides, but the world has {world} (start the ranks with "
            f"python -m torch.distributed.run --nproc-per-node N)")
    if torch.device(device).type == "cuda":
        resolve_device("cuda")            # raises without a card
        cards = torch.cuda.device_count()
        dev = torch.device("cuda", local % cards)
        torch.cuda.set_device(dev)
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
        backend = "nccl" if per_host <= cards else "gloo"
    else:
        dev, backend = torch.device("cpu"), "gloo"
    timeout = datetime.timedelta(seconds=timeout_s)
    if not dist.is_initialized():
        dist.init_process_group(backend, rank=rank, world_size=world,
                                timeout=timeout)
    probe = torch.ones(1, device=dev)
    dist.all_reduce(probe)
    if int(probe.item()) != world:
        raise RuntimeError(f"rank {rank}: the handshake all-reduce gave "
                           f"{probe.item()} over a world of {world}")
    mesh = make_host_mesh(model_axis, timeout=timeout,
                          device_type="cuda" if backend == "nccl" else "cpu")
    print(f"rank {rank}/{world}: backend {backend}, device {dev}, mesh "
          f"{mesh_shape(mesh)}", flush=True)
    return mesh, dev, backend


def make_ctx(mesh, batch: int) -> ShardingCtx:
    """The train path's ctx on ``mesh``: the batch split over its batch
    axes when they divide it (the reference's ``shard_batch``)."""
    ctx = ShardingCtx(mesh=mesh, batch_axes=batch_axes_of(mesh))
    return dataclasses.replace(ctx, shard_batch=batch % ctx.batch_size == 0)


def run(arch, *, steps: int = 20, batch: int = 8, seq: int = 256,
        reduced: bool = True, model_axis: int = 1, log_every: int = 10,
        seed: int = 0, device: str = "cuda", attn_impl="auto",
        step_seconds: list | None = None, params=None, ctx=None):
    """Train ``steps`` steps; returns the losses.  ``arch`` is a registered
    name (cut by ``reduced``) or a model config used as given;
    ``attn_impl=None`` runs the kernels' plain versions.  Each step's wall
    seconds (to its loss on the host) are appended to ``step_seconds``.
    ``params``, a numpy tree as the family's init draws it, starts the
    run instead of a draw from ``seed`` (the batches still follow
    ``seed``).  ``model_axis`` above 1 joins the ranks of the
    ``torch.distributed.run`` launch (``init_ranks``); a ``ctx`` given
    (the ranks joined already, on ``device``) is used as it is.  Under a
    mesh each rank keeps its slices of the full parameters and returns
    the global losses."""
    if ctx is None and model_axis > 1:
        mesh, dev, _ = init_ranks(model_axis, device)
        ctx = make_ctx(mesh, batch)
    else:
        dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get(arch) if isinstance(arch, str) else arch
    if isinstance(arch, str) and reduced:
        cfg = cfg.reduced()
    api = build_model(cfg, attn_impl=attn_impl)
    if params is None:
        params = api.init(np.random.default_rng(seed), "cpu" if ctx else dev)
        if ctx is not None:
            params = tree_map(lambda t: t.to(dev, copy=True),
                              shard_params(params, ctx))
    else:
        params = from_jax_params(shard_params(params, ctx), dev)
    opt_state = adamw_init(params)
    step = make_train_step(api, ctx=ctx)
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
        if (i % log_every == 0 or i == steps - 1) and (
                ctx is None or dist.get_rank() == 0):
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
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(f"first loss {losses[0]:.4f} -> last loss {losses[-1]:.4f}")
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
