"""Device meshes over the ranks of a process group, PyTorch port of
``repro/launch/mesh.py``.

``make_host_mesh(model)`` lays the ranks of the default process group
out as a ``DeviceMesh`` of shape (world // model, model) named ("data",
"model"), or (pod, world // (pod * model), model) named ("pod", "data",
"model") for three axes, rank ``r`` at its row-major place as JAX's
``make_mesh`` lays out devices.  Each axis's groups are made here with
the default group's timeout (a ``DeviceMesh`` made by
``init_device_mesh`` would give them the library's default instead), so
a collective that never completes raises rather than hangs.

The reference's ``make_production_mesh`` and ``compat_*`` helpers
(TPU pods of 256 chips) are not ported here: the dry run that uses them
is not ported yet, nor are the hardware constants, which only the
roofline reads.
"""
from __future__ import annotations

import datetime
from typing import Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DEFAULT_TIMEOUT_S = 300.0         # a collective that waits longer raises


def make_host_mesh(model: int = 1, *, pod: int = 1,
                   device_type: str = "cpu",
                   timeout: Optional[datetime.timedelta] = None
                   ) -> DeviceMesh:
    """A (data, model) mesh, or (pod, data, model) when ``pod`` > 1, over
    every rank of the initialised default process group.  Every rank
    calls it, in the same order as its other group creations.  Raises
    unless ``pod * model`` divides the world size."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh: the default process group is "
                           "not initialised")
    world = dist.get_world_size()
    if model < 1 or pod < 1 or world % (pod * model):
        raise ValueError(f"make_host_mesh: a world of {world} ranks does not "
                         f"split into pod {pod} x model {model}")
    data = world // (pod * model)
    shape = (pod, data, model) if pod > 1 else (data, model)
    names = ("pod", "data", "model") if pod > 1 else ("data", "model")
    if timeout is None:
        timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)
    layout = torch.arange(world).reshape(shape)
    rank = dist.get_rank()
    groups = []
    for dim, size in enumerate(shape):
        mine = None
        # every rank creates every group of this axis, in one order
        for ranks in layout.movedim(dim, -1).reshape(-1, size).tolist():
            group = dist.new_group(ranks, timeout=timeout)
            if rank in ranks:
                mine = group
        groups.append(mine)
    return DeviceMesh.from_group(groups, device_type, mesh=layout,
                                 mesh_dim_names=names)


def mesh_shape(mesh) -> Mapping[str, int]:
    """{axis name: size} of a ``DeviceMesh``, or of a mapping as given (the
    form the reference reads from ``mesh.shape``)."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(mesh)


def batch_axes_of(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh_shape(mesh) if a in ("pod", "data"))
