"""Device mesh construction over a ``torch.distributed`` world.

Counterpart of ``simplemath_tpu/parallel/mesh.py``.  JAX runs one
controller over a mesh of devices; the port runs one process per rank, each
rank one device, in a ``torch.distributed`` world (NCCL on the card, gloo on
the CPU).  A ``Mesh`` lays the world's ranks out over named axes with
``torch.distributed.device_mesh``; the collectives (collectives.py) act over
the process group of one named axis, and ``shard_map`` takes each rank's
block of a global array by the rank's coordinate on the named axes.

``PartitionSpec`` (``P``) says, dimension by dimension, which mesh axis (or
tuple of axes, outer first) a dimension is split over, as JAX's does;
``scenario_sharding`` and ``replicated`` are the two placements the solvers
use.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..config import config


class PartitionSpec(tuple):
    """Per-dimension mesh axes of a sharded array: ``P("scenario")`` splits
    dimension 0 over the scenario axis, ``P(None, "h")`` dimension 1 over
    "h", ``P(("dcn", "scenario"))`` dimension 0 over both (dcn outer), and
    ``P()`` is replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def device_type() -> str:
    """"cuda" or "cpu": the type of the port's default device."""
    return torch.device(config.device).type


def ensure_world() -> None:
    """A caller outside a world (no ``init_process_group``) is a world of
    one, as a JAX process on one device is: the default group is made over
    an in-process store, NCCL on the card and gloo on the CPU."""
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device_type() == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1,
        )


class Mesh:
    """Named axes over a world's ranks (``jax.sharding.Mesh``'s surface:
    ``shape``, ``axis_names``, ``devices``; ``devices`` holds ranks).

    ``device_mesh`` is the ``torch.distributed`` mesh; ``group(name)`` the
    process group of this rank's slice along ``name``; ``coordinate(name)``
    this rank's index along it (None on a rank outside the mesh)."""

    def __init__(self, device_mesh: DeviceMesh, axis_names: Sequence[str]):
        self.device_mesh = device_mesh
        self.axis_names = tuple(axis_names)
        self.devices = device_mesh.mesh.numpy()
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        coord = device_mesh.get_coordinate()
        self._coord = None if coord is None else dict(zip(self.axis_names, coord))

    @property
    def member(self) -> bool:
        return self._coord is not None

    def group(self, name: str):
        return self.device_mesh.get_group(name)

    def coordinate(self, name: str) -> int:
        if self._coord is None:
            raise ValueError(f"rank {dist.get_rank()} is not on this mesh")
        return self._coord[name]

    def __repr__(self):
        return f"Mesh({self.shape}, ranks={self.devices.tolist()})"


def device_info() -> dict:
    """Topology summary: the backend, the world's devices and processes
    (one device a rank), and the platforms."""
    ensure_world()
    kind = device_type()
    world = dist.get_world_size()
    return {
        "backend": dist.get_backend(),
        "n_devices": world,
        "n_local": torch.cuda.device_count() if kind == "cuda" else 1,
        "n_processes": world,
        "platforms": [{"cuda": "gpu"}.get(kind, kind)],
    }


def make_mesh(
    axis_sizes: Optional[Sequence[int]] = None,
    axis_names: Optional[Sequence[str]] = None,
    devices=None,
) -> Mesh:
    """Build a mesh.

    Default: 1-D mesh over every rank named after ``config.data_axis``
    (the scenario axis of the batched solvers).  Pass ``axis_sizes`` /
    ``axis_names`` for 2-D layouts, e.g. ``((n_hosts, ranks_per_host),
    ("dcn", "scenario"))``; ``devices`` is a list of ranks (a sub-mesh).
    Every rank of the world calls it, members of the mesh or not: making
    its process groups is a collective of the world."""
    ensure_world()
    ranks = np.asarray(devices if devices is not None else range(dist.get_world_size()))
    if axis_sizes is None:
        axis_sizes = (ranks.size,)
        axis_names = (config.data_axis,)
    axis_sizes = tuple(int(s) for s in axis_sizes)
    if int(np.prod(axis_sizes)) != ranks.size:
        raise ValueError(
            f"mesh axes {axis_sizes} do not match device count {ranks.size}"
        )
    if axis_names is None or len(axis_names) != len(axis_sizes):
        raise ValueError("axis_names must match axis_sizes")
    names = tuple(axis_names)
    if devices is None:
        dm = init_device_mesh(device_type(), axis_sizes, mesh_dim_names=names)
    else:
        dm = DeviceMesh(device_type(), torch.as_tensor(ranks).reshape(axis_sizes),
                        mesh_dim_names=names)
    return Mesh(dm, names)


def scenario_sharding(mesh: Mesh, axis_name: Optional[str] = None):
    """Placement that splits the leading (scenario) axis over the mesh:
    ``(mesh, P(axis))``, which ``shard_map`` reads."""
    return mesh, P(axis_name or config.data_axis)


def replicated(mesh: Mesh):
    return mesh, P()
