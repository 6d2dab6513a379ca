"""Collective communication over the named axes of a mesh.

Counterpart of ``simplemath_tpu/parallel/collectives.py``: ``psum``,
``pmean``, ``pmax``, ``pmin``, ``all_gather``, ``ppermute_ring``,
``reduce_scatter`` and ``axis_index``, each over the process group of a
named mesh axis (``Mesh.group``), and ``shard_map``, which runs a function
on each rank's block of global arrays with those names in scope.

Each collective returns a new tensor and leaves its input as it was, as a
JAX caller's value is immutable.  A gloo group is handed a card tensor on
the host: gloo copies card tensors through the host in its all-reduce,
gather and scatter, and fails on them in its point-to-point
(tools/probe_torch_collectives.py).  An NCCL group takes one where it lies.
"""

from __future__ import annotations

import collections
import math
from typing import Sequence, Tuple, Union

import torch
import torch.distributed as dist

from .mesh import Mesh, PartitionSpec

AxisNames = Union[str, Tuple[str, ...]]

# Collectives run, by name (a collective over several axes counts once
# an axis); phase 9 of chip_smoke.py and the tests read it.
COUNTS: collections.Counter = collections.Counter()

_ACTIVE: list = []  # meshes of the enclosing shard_map calls


def _as_tuple(axis_name: AxisNames) -> Tuple[str, ...]:
    return (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)


def current_mesh() -> Mesh:
    if not _ACTIVE:
        raise RuntimeError("collectives act over the axes of an enclosing shard_map")
    return _ACTIVE[-1]


def _staged(group, x: torch.Tensor) -> torch.Tensor:
    """The tensor the group's backend takes: a contiguous copy of ``x``,
    on the host for gloo."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return x.detach().to("cpu", copy=True).contiguous()
    return x.detach().clone(memory_format=torch.contiguous_format)


def _all_reduce(mesh: Mesh, x, axis_name: AxisNames, op, name: str) -> torch.Tensor:
    x = out = torch.as_tensor(x)
    for ax in reversed(_as_tuple(axis_name)):
        group = mesh.group(ax)
        buf = _staged(group, out)
        dist.all_reduce(buf, op, group=group)
        COUNTS[name] += 1
        out = buf.to(x.device)
    return out


def psum(x, axis_name: AxisNames):
    """Sum over a mesh axis (a tuple of axes: inner first, then outer)."""
    return _all_reduce(current_mesh(), x, axis_name, dist.ReduceOp.SUM, "psum")


def pmean(x, axis_name: AxisNames):
    n = math.prod(current_mesh().shape[ax] for ax in _as_tuple(axis_name))
    return psum(x, axis_name) / n


def pmax(x, axis_name: AxisNames):
    return _all_reduce(current_mesh(), x, axis_name, dist.ReduceOp.MAX, "pmax")


def pmin(x, axis_name: AxisNames):
    return _all_reduce(current_mesh(), x, axis_name, dist.ReduceOp.MIN, "pmin")


def _gather(mesh: Mesh, x: torch.Tensor, axis_name: AxisNames, axis: int,
            tiled: bool) -> torch.Tensor:
    axes = _as_tuple(axis_name)
    if not tiled and len(axes) != 1:
        raise ValueError("an untiled all_gather takes one axis")
    out = x
    for ax in reversed(axes):  # inner first: blocks in the mesh's row-major order
        n = mesh.shape[ax]
        group = mesh.group(ax)
        src = _staged(group, out)
        buf = src.new_empty((n * src.numel(),))
        dist.all_gather_into_tensor(buf, src.reshape(-1), group=group)
        COUNTS["all_gather"] += 1
        stacked = buf.view((n,) + tuple(src.shape)).to(x.device)
        if not tiled:
            return torch.movedim(stacked, 0, axis)
        shape = list(src.shape)
        shape[axis] *= n
        out = torch.movedim(stacked, 0, axis).reshape(shape)
    return out


def all_gather(x, axis_name: AxisNames, axis: int = 0, tiled: bool = True):
    """Every rank's ``x`` along a mesh axis: concatenated along ``axis``
    (``tiled``) or stacked as a new axis ``axis``."""
    return _gather(current_mesh(), torch.as_tensor(x), axis_name, axis, tiled)


def ppermute_ring(x, axis_name: str, shift: int = 1):
    """Ring shift along a mesh axis: rank i's ``x`` goes to rank
    (i + shift) mod n (one send and one receive, ``batch_isend_irecv``)."""
    mesh = current_mesh()
    n = mesh.shape[axis_name]
    group = mesh.group(axis_name)
    i = mesh.coordinate(axis_name)
    send = _staged(group, x)
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(group, (i + shift) % n), group),
           dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, (i - shift) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    COUNTS["ppermute"] += 1
    return recv.to(x.device)


def reduce_scatter(x, axis_name: str, axis: int = 0):
    """Sum over a mesh axis, each rank keeping its block along ``axis``
    (JAX's tiled ``psum_scatter``)."""
    mesh = current_mesh()
    n = mesh.shape[axis_name]
    moved = torch.movedim(torch.as_tensor(x), axis, 0)
    if moved.shape[0] % n:
        raise ValueError(f"reduce_scatter: dimension {moved.shape[0]} not divisible by {n}")
    group = mesh.group(axis_name)
    src = _staged(group, moved)
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, dist.ReduceOp.SUM, group=group)
    COUNTS["reduce_scatter"] += 1
    return torch.movedim(out.to(x.device), 0, axis)


def _index(mesh: Mesh, axes: Sequence[str]) -> int:
    """This rank's block index over ``axes`` (row-major, first outer)."""
    idx = 0
    for ax in axes:
        idx = idx * mesh.shape[ax] + mesh.coordinate(ax)
    return idx


def axis_index(axis_name: AxisNames):
    """This rank's index along a mesh axis, an int32 0-d tensor on the
    port's default device."""
    from ..config import config

    mesh = current_mesh()
    return torch.tensor(_index(mesh, _as_tuple(axis_name)), dtype=torch.int32,
                        device=config.device)


# ----------------------------------------------------------------- shard_map
def _local(mesh: Mesh, spec: PartitionSpec, x):
    """This rank's block of the global array ``x``."""
    if not isinstance(x, torch.Tensor):
        return x
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = _as_tuple(ax)
        n = math.prod(mesh.shape[a] for a in axes)
        if x.shape[d] % n:
            raise ValueError(
                f"dimension {d} of size {x.shape[d]} not divisible by mesh axes {axes}={n}"
            )
        b = x.shape[d] // n
        x = x.narrow(d, _index(mesh, axes) * b, b)
    return x


def _global(mesh: Mesh, spec: PartitionSpec, y):
    """The global array from each rank's block ``y``: gathered along every
    sharded dimension; a replicated (``P()``) result is this rank's."""
    if not isinstance(y, torch.Tensor):
        return y
    for d, ax in enumerate(spec):
        if ax is not None:
            y = _gather(mesh, y, ax, d, tiled=True)
    return y


def _map_specs(fn, specs, tree):
    """``fn(spec, leaf)`` over ``tree``, ``specs`` a prefix of it (a spec
    stands for the whole subtree under it)."""
    if specs is None or isinstance(specs, PartitionSpec):
        spec = specs if specs is not None else PartitionSpec()
        if isinstance(tree, dict):
            return {k: _map_specs(fn, spec, v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            items = [_map_specs(fn, spec, v) for v in tree]
            return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
        return fn(spec, tree)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, specs[k], v) for k, v in tree.items()}
    if len(specs) != len(tree):
        raise ValueError(f"specs {specs!r} do not match a tree of {len(tree)} items")
    items = [_map_specs(fn, s, v) for s, v in zip(specs, tree)]
    return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)


def shard_map(f, mesh: Mesh, in_specs, out_specs, check_vma: bool = True):
    """``f`` over each rank's block: every rank is handed the global
    arguments, takes its block of each by its coordinate on the axes the
    specs name, runs ``f`` with those axes in scope for the collectives,
    and returns the global results (sharded ones gathered, replicated ones
    as this rank computed them).  ``check_vma`` is JAX's replication check;
    there is nothing to check here."""
    del check_vma

    def wrapped(*args):
        specs = in_specs if isinstance(in_specs, PartitionSpec) else tuple(in_specs)
        local = _map_specs(lambda s, x: _local(mesh, s, x), specs, tuple(args))
        _ACTIVE.append(mesh)
        try:
            out = f(*local)
        finally:
            _ACTIVE.pop()
        return _map_specs(lambda s, y: _global(mesh, s, y), out_specs, out)

    return wrapped
