"""Weak-scaling measurement harness.

Counterpart of ``simplemath_tpu/parallel/scaling.py``: weak scaling (the
same work a rank, a growing number of ranks) of the sharded solver, and the
sharding machinery's overhead at constant total work, on whatever world is
running.  Every rank of the world calls these functions; the ranks outside
a sub-mesh wait, and the report (each time the slowest rank's) is the same
on every rank.  Times are wall times ended by ``torch.cuda.synchronize()``
on the card.

Where ranks share a device (the CPU, or several ranks on one card) the
n-rank time carries n times the work on the same silicon, so the
efficiency validates the collective structure only
(``efficiency_meaningful`` is false).
"""

from __future__ import annotations

import time
from typing import Dict, Sequence

import torch
import torch.distributed as dist

from ..config import config
from ..models import dynamics as _dyn
from ..models import ilqr as _ilqr
from . import sharded as _sharded
from .mesh import device_type, ensure_world, make_mesh
from .multihost import scaling_efficiency


def _sync():
    if device_type() == "cuda":
        torch.cuda.synchronize()


def _time_step(step_fn, x0s, us, repeats: int = 3) -> float:
    """Median wall time of a sharded step (the first call excluded)."""
    step_fn(x0s, us)
    _sync()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        step_fn(x0s, us)
        _sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def _slowest(t: float) -> float:
    """The largest of every rank's ``t`` (0 from a rank that did not time)."""
    buf = torch.tensor([t], dtype=torch.float64)
    if dist.get_backend() == "nccl":
        buf = buf.cuda()
    dist.all_reduce(buf, dist.ReduceOp.MAX)
    return float(buf.cpu()[0])


def _shared_device() -> bool:
    """Whether ranks of the world share a device."""
    if device_type() != "cuda":
        return True
    return dist.get_world_size() > torch.cuda.device_count()


def _problem(system, batch, horizon, seed):
    g = torch.Generator().manual_seed(seed)
    x0s = 0.2 * torch.randn((batch, system.nx), generator=g, dtype=torch.float32)
    us = torch.zeros((batch, horizon, system.nu), dtype=torch.float32)
    return x0s.to(config.device), us.to(config.device)


def weak_scaling_report(
    per_device_batch: int = 64,
    horizon: int = 40,
    iterations: int = 3,
    device_counts: Sequence[int] = (1, 2, 4, 8),
    system_name: str = "cartpole",
) -> Dict:
    """Weak-scaling efficiencies of the sharded cartpole solve.

    For each n in ``device_counts`` (clamped to the world): mesh over the
    first n ranks, batch = n * per_device_batch, time one sharded solve
    step; efficiency_n = t_1 / t_n (1.0 = perfect weak scaling).  Returns
    {"times_s": {n: t}, "efficiency": {n: e}, ...}.
    """
    ensure_world()
    system = _dyn.SYSTEMS[system_name]()
    world = dist.get_world_size()
    counts = [n for n in device_counts if n <= world]
    cfg = _ilqr.ILQRConfig(iterations=iterations)
    times: Dict[int, float] = {}
    for n in counts:
        mesh = make_mesh((n,), ("scenario",), devices=list(range(n)))
        t = 0.0
        if mesh.member:
            step = _sharded.make_sharded_train_step(system, mesh, cfg, "scenario")
            x0s, us = _problem(system, n * per_device_batch, horizon, n)
            t = _time_step(step, x0s, us)
        times[n] = _slowest(t)
    t1 = times[counts[0]]
    eff = {n: scaling_efficiency(t1, t, n) for n, t in times.items()}
    return {
        "system": system_name,
        "per_device_batch": per_device_batch,
        "horizon": horizon,
        "iterations": iterations,
        "backend": dist.get_backend(),
        "device_counts": counts,
        "times_s": times,
        "efficiency": eff,
        "efficiency_meaningful": not _shared_device(),
    }


def sharding_overhead_report(
    total_batch: int = 256,
    horizon: int = 40,
    iterations: int = 3,
    n_devices: int = None,
    system_name: str = "cartpole",
) -> Dict:
    """Sharding-machinery overhead at CONSTANT total work: the same batch
    solved unsharded on each rank vs sharded over n ranks.  A ratio near or
    below 1.0 on ranks of their own means the partitioning and collectives
    add no cost; on ranks that share a device the sharded side runs its
    blocks side by side on it."""
    ensure_world()
    system = _dyn.SYSTEMS[system_name]()
    n = n_devices or dist.get_world_size()
    if total_batch % n:
        total_batch = (total_batch // n) * n
    cfg = _ilqr.ILQRConfig(iterations=iterations)
    x0s, us = _problem(system, total_batch, horizon, 0)

    def plain(x, u):
        return _ilqr.solve_batched(system, x, u, cfg).cost

    t_plain = _slowest(_time_step(plain, x0s, us))
    mesh = make_mesh((n,), ("scenario",), devices=list(range(n)))
    t_shard = 0.0
    if mesh.member:
        step = _sharded.make_sharded_train_step(system, mesh, cfg, "scenario")
        t_shard = _time_step(step, x0s, us)
    t_shard = _slowest(t_shard)
    return {
        "total_batch": total_batch,
        "n_devices": n,
        "unsharded_s": t_plain,
        "sharded_s": t_shard,
        "sharded_over_unsharded": t_shard / t_plain,
    }
