"""Sharded batched solving: the scenario axis over the ranks of a mesh.

Counterpart of ``simplemath_tpu/parallel/sharded.py``.  ``shard_map``
splits the scenario batch over the ranks, each rank runs
``models.ilqr.solve_batched`` on its block, and ``psum``/``pmax``
collectives reduce the global solver statistics (total cost, largest
gradient norm, mean cost): the "QP/KKT block reductions" of BASELINE.json
configs 4-5.

``axis_name`` may be a single mesh axis or a tuple (e.g. ``("dcn",
"scenario")`` on a 2-D mesh): the batch shards over the axis product, and
the statistics reduce over the inner axis first, then cross the outer one
with a single scalar.

``make_sharded_train_step`` is the compiled step (JAX jits it): on the card
each rank's block runs through ``solve_batched_jit`` and the reductions and
gathers through one more CUDA graph, the NCCL collectives inside it.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import config
from ..models import ilqr as _ilqr
from ..models.dynamics import System
from ..utils import graphs
from . import collectives, mesh as _mesh
from .collectives import AxisNames, _as_tuple
from .mesh import Mesh, PartitionSpec as P


def _check_batch(mesh: Mesh, axes, n: int) -> None:
    size = 1
    for ax in axes:
        size *= mesh.shape[ax]
    if n % size != 0:
        raise ValueError(
            f"scenario batch {n} not divisible by mesh axes "
            f"{axes}={size}"
        )


def _spec(axes) -> P:
    return P(axes if len(axes) > 1 else axes[0])


def _out_specs(spec: P):
    return (
        _ilqr.ILQRResult(xs=spec, us=spec, cost=spec, cost_trace=spec, grad_norm=spec),
        {"total_cost": P(), "mean_cost": P(), "max_grad_norm": P()},
    )


def _with_stats(result: _ilqr.ILQRResult, axes, n: int):
    """A rank's block result and the global statistics, reduced across the
    ranks: the cross-rank KKT/convergence reductions, inner axis first (the
    outer axis carries a single scalar)."""
    total_cost = torch.sum(result.cost)
    max_grad = torch.amax(result.grad_norm)
    for ax in reversed(axes):
        total_cost = collectives.psum(total_cost, ax)
        max_grad = collectives.pmax(max_grad, ax)
    mean_cost = total_cost / n
    return result, {
        "total_cost": total_cost,
        "mean_cost": mean_cost,
        "max_grad_norm": max_grad,
    }


def solve_batched_sharded(
    system: System,
    x0_batch,
    us_init_batch,
    ilqr_config: _ilqr.ILQRConfig = _ilqr.ILQRConfig(),
    mesh: Optional[Mesh] = None,
    axis_name: Optional[AxisNames] = None,
):
    """Solve a scenario batch sharded over mesh axes.

    Every rank is handed the global batch and returns the global result
    and stats; stats carries the globally reduced metrics: total cost
    (psum), max gradient norm (pmax), mean cost.  The batch's leading dim
    must divide by the product of the named axis sizes.
    """
    mesh = mesh if mesh is not None else _mesh.make_mesh()
    axes = _as_tuple(axis_name or config.data_axis)
    n = x0_batch.shape[0]
    _check_batch(mesh, axes, n)

    def shard_fn(x0s, uss):
        return _with_stats(_ilqr.solve_batched(system, x0s, uss, ilqr_config), axes, n)

    spec = _spec(axes)
    fn = collectives.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(spec, spec),
        out_specs=_out_specs(spec),
        check_vma=False,
    )
    return fn(x0_batch, us_init_batch)


def _stats_and_gathers(static, *fields):
    """The compiled train step's last program: the statistics' collectives
    and the gathers of the five result fields."""
    _, mesh, axes, _, n = static
    with collectives.in_mesh(mesh):
        out = _with_stats(_ilqr.ILQRResult(*fields), axes, n)
    return collectives.global_arrays(mesh, _out_specs(_spec(axes)), out)


_STATS_AND_GATHERS = graphs.Jit(_stats_and_gathers)


def make_sharded_train_step(
    system: System,
    mesh: Mesh,
    ilqr_config: _ilqr.ILQRConfig = _ilqr.ILQRConfig(),
    axis_name: Optional[AxisNames] = None,
):
    """A compiled sharded solve step (the framework's "training step"), the
    JAX package's ``jax.jit`` of :func:`solve_batched_sharded`.

    On the card each rank solves its block with
    :func:`models.ilqr.solve_batched_jit` (the initial rollout and one
    iteration, each a CUDA graph, the iteration replayed
    ``ilqr_config.iterations`` times), and then one more graph runs the
    ``psum``/``pmax`` of the statistics and the gathers of the result over
    NCCL.  Python launches nothing between the replays but the copies into
    the graphs' inputs.  Graphs are keyed on the system (held weakly), the
    mesh, the axes, the config and the tensors' shapes, dtypes and device.
    A mesh whose groups copy card tensors through the host (gloo) raises
    ``graphs.CaptureError`` before anything is built.  On the CPU, or inside
    ``graphs.eager()``, the same functions run eagerly (``Jit`` and
    ``solve_batched_jit`` call their bodies), with
    :func:`solve_batched_sharded`'s bits.
    """
    axes = _as_tuple(axis_name or config.data_axis)
    spec = _spec(axes)

    def step(x0_batch, us_batch):
        collectives.check_capturable(mesh, axes, x0_batch.device)
        n = x0_batch.shape[0]
        _check_batch(mesh, axes, n)
        x0s, uss = collectives.local_blocks(mesh, (spec, spec), (x0_batch, us_batch))
        result = _ilqr.solve_batched_jit(system, x0s, uss, ilqr_config)
        return _STATS_AND_GATHERS((system, mesh, axes, ilqr_config, n), *result)

    return step
