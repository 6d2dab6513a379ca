"""Multi-process orchestration helpers.

Counterpart of ``simplemath_tpu/parallel/multihost.py``.  The port runs one
process per rank; ``initialize_from_env`` stitches them into one
``torch.distributed`` world from the same three variables the JAX package
reads (``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``, ``PROCESS_ID``).  The
mesh is laid out (dcn, scenario): the scenario axis over the ranks of one
host (``LOCAL_WORLD_SIZE`` of them, one if unset), the outer axis across
hosts.
"""

from __future__ import annotations

import os
from typing import Tuple

import torch.distributed as dist

from .mesh import Mesh, device_type, make_mesh


def initialize_from_env() -> None:
    """Join the world named by COORDINATOR_ADDRESS (host:port) /
    NUM_PROCESSES / PROCESS_ID: NCCL when the port's default device is the
    card, gloo when the caller asked for the CPU.  A no-op when the
    variables are unset or NUM_PROCESSES is 1."""
    coord = os.environ.get("COORDINATOR_ADDRESS")
    nproc = int(os.environ.get("NUM_PROCESSES", "1"))
    if coord and nproc > 1:
        dist.init_process_group(
            "nccl" if device_type() == "cuda" else "gloo",
            init_method=f"tcp://{coord}",
            world_size=nproc,
            rank=int(os.environ.get("PROCESS_ID", "0")),
        )


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def pod_mesh(ici_axis: str = "scenario", dcn_axis: str = "dcn") -> Mesh:
    """(n_hosts, ranks_per_host) mesh: dcn outer, the scenario axis inner."""
    n_dev = process_count()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    if n_dev <= 1 or per_host >= n_dev:
        return make_mesh((n_dev,), (ici_axis,))
    return make_mesh((n_dev // per_host, per_host), (dcn_axis, ici_axis))


def host_local_batch_slice(global_batch: int) -> Tuple[int, int]:
    """(start, size) of this process's slice of a globally sharded batch."""
    n_proc = max(process_count(), 1)
    if global_batch % n_proc:
        raise ValueError(
            f"global batch {global_batch} not divisible by {n_proc} hosts"
        )
    per = global_batch // n_proc
    return process_index() * per, per


def scaling_efficiency(t_1dev: float, t_ndev: float, n: int) -> float:
    """Weak-scaling efficiency: n-device time vs 1-device time at n x the
    work (1.0 = perfect)."""
    return t_1dev / t_ndev if t_ndev > 0 else 0.0
