"""Sharding context threaded through the model code, and the port's
collectives, PyTorch port of ``repro/sharding.py``.

A ``ShardingCtx`` names a ``DeviceMesh`` (``launch/mesh.py``) and how the
model uses its axes: the batch is split over ``batch_axes`` (when
``shard_batch``), and the ``model`` axis splits the attention heads and
FFN columns (Megatron layout), the experts, the vocabulary and the
decode cache's sequence.  Each rank holds its slices of the parameters
(``models/api.shard_params``) and runs the model code on them; the
collectives below join the ranks where the reference's GSPMD partitioner
or its ``shard_map`` does.  ``ctx=None`` runs the local paths.

The collectives reduce in fp32 (a bf16 or fp16 tensor is widened for the
transport and narrowed back), over the axis groups of the mesh, and are
no-ops on an axis of size 1.  Each is built on ``all_reduce`` (sum or
max): gloo, which the ranks that share one card use, offers only
all-reduce and broadcast for CUDA tensors, so a gather is an all-reduce
of a zero-filled buffer that holds this rank's part.

Autograd follows Megatron's rules on the model axis, where activations
are replicated and counted once: ``copy_to_model`` is the identity
forward and an all-reduce backward (before a column-parallel product),
``reduce_from_model`` the all-reduce forward and identity backward (after
a row-parallel product), ``gather_from_model`` / ``scatter_to_model``
the all-gather and the local slice, each the other's backward.  On the
batch axes each rank differentiates its own copy of the loss and the
step averages the gradients (``launch/stepfns.py``), so ``pmean`` there
is its own adjoint: an all-reduce mean forward and backward.

The reference's placement helpers are not ported: ``constrain`` and
``seq_shard`` only place data under GSPMD (the results do not change
with them), and the port places data by the slices each rank holds;
``constrain_layer_params`` regathers FSDP layer weights only when its
dry run sets ``layer_param_specs``, which the train path never does.
FSDP and sequence parallelism are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    mesh: object                              # torch DeviceMesh
    batch_axes: Tuple[str, ...] = ("data",)   # ("pod", "data") multi-pod
    model_axis: str = "model"
    shard_batch: bool = True                  # False when batch indivisible

    def size(self, axis: str) -> int:
        return int(self.mesh.mesh.shape[self._dim(axis)])

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return int(self.mesh.get_coordinate()[self._dim(axis)])

    def group(self, axis: str):
        return self.mesh.get_group(axis)

    def _dim(self, axis: str) -> int:
        return self.mesh.mesh_dim_names.index(axis)

    @property
    def model_size(self) -> int:
        return self.size(self.model_axis)

    @property
    def model_rank(self) -> int:
        return self.coord(self.model_axis)

    @property
    def batch_size(self) -> int:
        return _index(self, self.batch_axes)[0]


# ---------------------------------------------------------------------------
# Plain collectives (no autograd)
# ---------------------------------------------------------------------------
def _axes(ctx: Optional[ShardingCtx], axes) -> Tuple[str, ...]:
    if ctx is None:
        return ()
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(a for a in axes if ctx.size(a) > 1)


def all_reduce(ctx: Optional[ShardingCtx], x: torch.Tensor, axes,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Sum (or ``op``) of ``x`` over the groups of ``axes``, out of place,
    reduced in fp32 and returned in ``x``'s dtype."""
    live = _axes(ctx, axes)
    if not live:
        return x
    y = x.detach().to(torch.float32, copy=True).contiguous()
    for a in live:
        dist.all_reduce(y, op=op, group=ctx.group(a))
    return y.to(x.dtype)


def pmax(ctx: Optional[ShardingCtx], x: torch.Tensor, axes) -> torch.Tensor:
    """``lax.pmax`` outside autograd."""
    return all_reduce(ctx, x, axes, dist.ReduceOp.MAX)


def _index(ctx: ShardingCtx, axes) -> Tuple[int, int]:
    """(the ranks over ``axes``, this rank's index among them, the first
    axis major)."""
    n, i = 1, 0
    for a in axes:
        n, i = n * ctx.size(a), i * ctx.size(a) + ctx.coord(a)
    return n, i


def _place(ctx: ShardingCtx, x: torch.Tensor, axes, dim: int
           ) -> torch.Tensor:
    """A zero buffer ``n`` times ``x`` along ``dim`` (n the ranks of
    ``axes``) holding ``x`` at this rank's place."""
    n, i = _index(ctx, axes)
    shape = list(x.shape)
    step = shape[dim]
    shape[dim] = step * n
    buf = x.new_zeros(shape)
    buf.narrow(dim, i * step, step).copy_(x)
    return buf


def all_gather(ctx: Optional[ShardingCtx], x: torch.Tensor, axes,
               dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in their order over
    ``axes`` (first axis major), outside autograd."""
    live = _axes(ctx, axes)
    if not live:
        return x
    dim = dim % x.ndim
    return all_reduce(ctx, _place(ctx, x.detach(), live, dim), live)


def local_slice(ctx: Optional[ShardingCtx], x, axes, dim: int = 0):
    """This rank's equal part of ``x`` along ``dim`` over ``axes`` (numpy or
    torch); raises unless the ranks divide the dimension."""
    live = _axes(ctx, axes)
    if not live:
        return x
    n, i = _index(ctx, live)
    dim = dim % x.ndim
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of size {x.shape[dim]} does not "
                         f"split over {n} ranks of {live}")
    step = x.shape[dim] // n
    index = [slice(None)] * x.ndim
    index[dim] = slice(i * step, (i + 1) * step)
    return x[tuple(index)]


def batch_rows(ctx: Optional[ShardingCtx], x, dim: int = 0):
    """This rank's rows of a global batch (all of them unless
    ``shard_batch``)."""
    if ctx is None or not ctx.shard_batch:
        return x
    return local_slice(ctx, x, ctx.batch_axes, dim)


def gather_batch(ctx: Optional[ShardingCtx], x: torch.Tensor,
                 dim: int = 0) -> torch.Tensor:
    """The global batch from each rank's rows (``batch_rows``' inverse),
    outside autograd."""
    if ctx is None or not ctx.shard_batch:
        return x
    return all_gather(ctx, x, ctx.batch_axes, dim)


# ---------------------------------------------------------------------------
# Autograd-aware collectives
# ---------------------------------------------------------------------------
class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx = ctx
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return all_reduce(fctx.ctx, g, fctx.ctx.model_axis), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        return all_reduce(ctx, x, ctx.model_axis)

    @staticmethod
    def backward(fctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, dim):
        fctx.ctx, fctx.dim = ctx, dim
        return all_gather(ctx, x, ctx.model_axis, dim)

    @staticmethod
    def backward(fctx, g):
        part = local_slice(fctx.ctx, g, fctx.ctx.model_axis, fctx.dim)
        return part.clone(memory_format=torch.contiguous_format), None, None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, dim):
        fctx.ctx, fctx.dim = ctx, dim
        part = local_slice(ctx, x, ctx.model_axis, dim)
        return part.clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(fctx, g):
        return all_gather(fctx.ctx, g, fctx.ctx.model_axis, fctx.dim), None, \
            None


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axes):
        fctx.ctx, fctx.axes = ctx, axes
        return _mean(ctx, x, axes)

    @staticmethod
    def backward(fctx, g):
        return _mean(fctx.ctx, g, fctx.axes), None, None


def _mean(ctx, x, axes):
    return (all_reduce(ctx, x.float(), axes) / _index(ctx, axes)[0]).to(
        x.dtype)


def _model(ctx: Optional[ShardingCtx]) -> bool:
    return ctx is not None and ctx.model_size > 1


def copy_to_model(ctx: Optional[ShardingCtx], x: torch.Tensor):
    """Identity forward, all-reduce over ``model`` backward: the input of a
    column-parallel product, whose ranks each give part of its gradient."""
    return _CopyToModel.apply(x, ctx) if _model(ctx) else x


def reduce_from_model(ctx: Optional[ShardingCtx], x: torch.Tensor):
    """All-reduce over ``model`` forward, identity backward: the sum of a
    row-parallel product's (or the experts') partial outputs."""
    return _ReduceFromModel.apply(x, ctx) if _model(ctx) else x


def gather_from_model(ctx: Optional[ShardingCtx], x: torch.Tensor,
                      dim: int = -1):
    """The model ranks' parts concatenated along ``dim``; backward keeps
    this rank's part of the (replicated) gradient."""
    return _GatherFromModel.apply(x, ctx, dim) if _model(ctx) else x


def scatter_to_model(ctx: Optional[ShardingCtx], x: torch.Tensor,
                     dim: int = -1):
    """This model rank's part of a replicated ``x`` along ``dim``;
    backward gathers the parts' gradients."""
    return _ScatterToModel.apply(x, ctx, dim) if _model(ctx) else x


def pmean(ctx: Optional[ShardingCtx], x: torch.Tensor,
          axes: Sequence[str]) -> torch.Tensor:
    """Mean over the ranks of ``axes`` (``lax.pmean``), its own adjoint."""
    live = _axes(ctx, axes)
    return _PMean.apply(x, ctx, live) if live else x

