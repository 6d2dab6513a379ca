"""Distributed layer on ``torch.distributed``: mesh construction,
collectives, sharded solvers.  Counterpart of ``simplemath_tpu/parallel/``;
one process per rank, NCCL on the card and gloo on the CPU (mesh.py)."""

from .mesh import device_info, make_mesh, replicated, scenario_sharding  # noqa: F401
from .collectives import (  # noqa: F401
    all_gather,
    axis_index,
    pmax,
    pmean,
    pmin,
    ppermute_ring,
    psum,
    reduce_scatter,
    shard_map,
)
from .sharded import make_sharded_train_step, solve_batched_sharded  # noqa: F401
from .horizon import (  # noqa: F401
    backward_associative_sharded,
    backward_associative_sharded_batched,
    sharded_suffix_scan,
    sharded_suffix_scan_batched,
)
from .multihost import (  # noqa: F401
    host_local_batch_slice,
    initialize_from_env,
    pod_mesh,
    scaling_efficiency,
)
