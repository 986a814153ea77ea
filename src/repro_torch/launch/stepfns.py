"""Step functions (train / prefill / serve) over a ``ModelAPI``, PyTorch
port of ``repro/launch/stepfns.py``.

``make_train_step(api, grad_accum, ctx=None)`` returns
``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``:
the loss and its gradients by autograd (the global batch split into
``grad_accum`` microbatches whose fp32 gradients are summed, each over
``grad_accum``, as the reference's scan sums them), then one AdamW step at
the cosine schedule's rate, the parameters and moments updated in place.

With a sharding ``ctx`` (``repro_torch.sharding``) each rank passes its
parameter slices (``models/api.shard_params``) and the global batch, of
which the model takes this rank's rows.  Each rank differentiates its own
copy of the global loss, and the gradients are averaged over the batch
axes, so every leaf's gradient is the reference's global one.  Nothing is
summed over the model axis here: a replicated leaf whose use the model
ranks split (the MoE router, through its combine weights) gets its whole
gradient from the all-reduce inside the backward of ``copy_to_model``.
"""
from __future__ import annotations

import torch

from repro_torch import sharding as sh
from repro_torch.checkpoint.partition import tree_leaves, tree_map
from repro_torch.models.api import ModelAPI
from repro_torch.optim import adamw_update, cosine_lr


def _like(tree, leaves):
    """``leaves`` (in ``tree_leaves`` order) in ``tree``'s structure."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def make_train_step(api: ModelAPI, grad_accum: int = 1, ctx=None):
    def grads_of(loss, leaves):
        grads = torch.autograd.grad(loss, leaves)
        if ctx is None or not ctx.shard_batch:
            return grads
        return [sh.pmean(ctx, g, ctx.batch_axes) for g in grads]

    def value_and_grads(params, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        if grad_accum <= 1:
            loss, metrics = api.loss(params, batch, ctx)
            grads = grads_of(loss, leaves)
            return loss.detach(), metrics, _like(params, grads)
        b = batch["tokens"].shape[0]
        if b % grad_accum:
            raise ValueError(f"batch {b} does not split into {grad_accum} "
                             f"microbatches")
        m = b // grad_accum
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for i in range(grad_accum):
            micro = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            loss, metrics = api.loss(params, micro, ctx)
            for a, g in zip(acc, grads_of(loss, leaves)):
                a.add_(g.float() / grad_accum)
            total = total + loss.detach() / grad_accum
        return total, metrics, _like(params, acc)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = value_and_grads(params, batch)
        lr = cosine_lr(opt_state["step"] + 1)   # step counts from 1
        params, opt_state = adamw_update(grads, opt_state, params, lr=lr)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss
        metrics["lr"] = lr
        return params, opt_state, metrics

    return train_step


def make_prefill_step(api: ModelAPI, ctx=None):
    @torch.no_grad()
    def prefill_step(params, batch):
        return api.prefill(params, batch, ctx)

    return prefill_step


def make_serve_step(api: ModelAPI, ctx=None):
    @torch.no_grad()
    def serve_step(params, tokens, cache, pos):
        return api.decode(params, tokens, cache, pos, ctx)

    return serve_step
