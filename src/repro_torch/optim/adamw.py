"""AdamW and the cosine learning-rate schedule over a parameter tree,
PyTorch port of ``repro/optim/adamw.py``.

The arithmetic is the reference's, in fp32: moments updated from the fp32
gradient, bias correction from the step, decoupled weight decay on every
leaf.  Unlike the reference, which returns new trees, ``adamw_update``
writes the parameters and both moments IN PLACE (under
``torch.no_grad()``) and returns the same objects, so a step allocates
only its temporaries.  The schedule and the bias corrections are
computed in numpy float32, the precision of the reference's scalars.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.checkpoint.partition import tree_leaves, tree_map


def adamw_init(params, moment_dtype=torch.float32) -> Dict[str, Any]:
    """Zeroed moments beside every leaf (``moment_dtype=torch.bfloat16``
    halves the optimiser state, the reference's documented trade-off) and
    step 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": 0}


def cosine_lr(step: int, *, base_lr=3e-4, warmup=100, total=10_000,
              min_frac=0.1) -> float:
    """Linear warm-up to ``base_lr``, then cosine decay to ``min_frac`` of
    it, in float32 as the reference computes it."""
    f = np.float32
    step = f(step)
    warm = step / f(max(warmup, 1))
    prog = np.clip((step - f(warmup)) / f(max(total - warmup, 1)), f(0),
                   f(1))
    cos = f(min_frac) + f(1 - min_frac) * f(0.5) * (f(1) + np.cos(
        f(np.pi) * prog))
    return float(f(base_lr) * np.minimum(warm, cos))


@torch.no_grad()
def adamw_update(grads, opt_state, params, *, lr=3e-4, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1):
    """One AdamW step over matching trees of parameters, gradients and
    moments, in place; returns ``(params, opt_state)`` with the step
    advanced."""
    step = opt_state["step"] + 1
    f = np.float32
    b1t = float(f(1) - f(b1) ** f(step))
    b2t = float(f(1) - f(b2) ** f(step))
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(opt_state["mu"]),
                          tree_leaves(opt_state["nu"])):
        gf = g.float()
        m_new = b1 * m.float() + (1 - b1) * gf
        v_new = b2 * v.float() + (1 - b2) * gf * gf
        m.copy_(m_new)
        v.copy_(v_new)
        mh = m.float() / b1t
        vh = v.float() / b2t
        delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    opt_state["step"] = step
    return params, opt_state
