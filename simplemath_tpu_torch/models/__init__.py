"""Model / solver layer: the benchmark dynamical systems and the batched
iLQR/DDP, RTI and AL-SQP MPC trajectory optimizers (BASELINE.json configs
3-5), as plain torch.

Counterpart of ``simplemath_tpu/models/``; the scenario-consensus MPC
runs over the parallel layer (``simplemath_tpu_torch.parallel``).
"""

from .dynamics import (  # noqa: F401
    SYSTEMS,
    System,
    make_bicycle,
    make_cartpole,
    make_pendulum,
    make_quadrotor,
    make_sm_pendulum,
    rk4,
)
from .ilqr import (  # noqa: F401
    ILQRConfig,
    ILQRResult,
    rollout,
    solve,
    solve_batched,
    trajectory_cost,
)
from .rti import (  # noqa: F401
    RTIConfig,
    RTIState,
    rti_closed_loop,
    rti_init,
    rti_tick,
)
from .sqp_mpc import (  # noqa: F401
    MPCController,
    SQPConfig,
    make_scenario_mpc_step,
    scenario_mpc_solve,
    scenario_mpc_step,
    solve_constrained,
)
from .simulate import SimResult, closed_loop  # noqa: F401
