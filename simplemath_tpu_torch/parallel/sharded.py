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
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import config
from ..models import ilqr as _ilqr
from ..models.dynamics import System
from . import collectives, mesh as _mesh
from .collectives import AxisNames, _as_tuple
from .mesh import Mesh, PartitionSpec as P


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
    axis_size = 1
    for ax in axes:
        axis_size *= mesh.shape[ax]
    if n % axis_size != 0:
        raise ValueError(
            f"scenario batch {n} not divisible by mesh axes "
            f"{axes}={axis_size}"
        )

    def shard_fn(x0s, uss):
        result = _ilqr.solve_batched(system, x0s, uss, ilqr_config)
        # Cross-rank KKT/convergence reductions, inner axis first: the
        # outer axis carries a single scalar.
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

    spec = P(axes if len(axes) > 1 else axes[0])
    fn = collectives.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(spec, spec),
        out_specs=(
            _ilqr.ILQRResult(
                xs=spec, us=spec, cost=spec, cost_trace=spec, grad_norm=spec
            ),
            {"total_cost": P(), "mean_cost": P(), "max_grad_norm": P()},
        ),
        check_vma=False,
    )
    return fn(x0_batch, us_init_batch)


def make_sharded_train_step(
    system: System,
    mesh: Mesh,
    ilqr_config: _ilqr.ILQRConfig = _ilqr.ILQRConfig(),
    axis_name: Optional[AxisNames] = None,
):
    """A sharded solve step (the framework's "training step"); the JAX
    package jits it, the port runs it as it stands."""
    axes = _as_tuple(axis_name or config.data_axis)

    def step(x0_batch, us_batch):
        return solve_batched_sharded(
            system, x0_batch, us_batch, ilqr_config, mesh, axes
        )

    return step
