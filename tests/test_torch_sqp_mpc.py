"""The port's SQP-MPC layer (models/sqp_mpc.py) against the JAX package:
the augmented-Lagrangian constrained solve and the receding-horizon
controller.  Twins of tests/test_sqp_mpc.py (the scenario-consensus tests
need the parallel layer, not ported yet) at shorter horizons and fewer
iterations; the same float32 numpy inputs go through both packages on the
CPU.

Tolerances: the JAX suite's violation bounds on the port's own results;
against JAX, costs within ``rtol=1e-4`` and controls within ``rtol=1e-3``
with an absolute part of 1e-4 times the largest control (tests/
test_torch_models.py says why); multipliers within ``rtol=1e-3`` and
1e-3 times the largest, as they sum the controls' errors over the outer
iterations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simplemath_tpu_torch as sm
from simplemath_tpu import models as jm
from simplemath_tpu.models import sqp_mpc as jsqp
from simplemath_tpu_torch import models as tm
from simplemath_tpu_torch.models import ilqr as tilqr
from simplemath_tpu_torch.models import sqp_mpc
from simplemath_tpu_torch.models.sqp_mpc import MPCController, SQPConfig, solve_constrained


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's default device is the card; these tests ask for the CPU."""
    old = sm.config.device
    sm.configure(device="cpu")
    yield
    sm.configure(device=old)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _scaled(got, want, rtol, frac):
    want = np.asarray(want)
    atol = frac * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(_np(got), want, rtol=rtol, atol=atol)


def _constrained_both(name, x0, us, u_min, u_max, **cfg):
    ts = tm.SYSTEMS[name]()
    got = solve_constrained(ts, torch.from_numpy(x0), torch.from_numpy(us), u_min, u_max,
                            SQPConfig(**cfg))
    if not cfg.get("use_multipliers", True):
        # The pure penalty method stalls on an ill-conditioned problem
        # (that is what the test shows); its iterate is not held to JAX's.
        return got
    js = jm.SYSTEMS[name]()
    want = jax.jit(lambda x, u: jsqp.solve_constrained(
        js, x, u, u_min, u_max, jsqp.SQPConfig(**cfg)))(jnp.asarray(x0), jnp.asarray(us))
    np.testing.assert_allclose(_np(got.cost), np.asarray(want.cost), rtol=1e-4)
    _scaled(got.us, want.us, 1e-3, 1e-4)
    _scaled(got.lam_lo, want.lam_lo, 1e-3, 1e-3)
    _scaled(got.lam_hi, want.lam_hi, 1e-3, 1e-3)
    return got


def test_constrained_solve_respects_bounds():
    system = tm.make_pendulum()
    x0, us = np.zeros(2, np.float32), np.zeros((30, 1), np.float32)
    res = _constrained_both("pendulum", x0, us, -2.0, 2.0)
    assert float(res.max_violation) <= 1e-5
    assert float(torch.max(torch.abs(res.us))) <= 2.0 + 1e-5
    tx, tu = torch.from_numpy(x0), torch.from_numpy(us)
    init = tilqr.trajectory_cost(system, tilqr.rollout(system.step, tx, tu), tu)
    assert float(res.cost) < float(init)


def test_multiplier_update_is_load_bearing():
    """With a FROZEN penalty weight (penalty_scale=1), convergence of the
    constraint violation can only come from the multiplier update."""
    x0 = np.array([np.pi - 0.5, 0.0], np.float32)
    us = np.zeros((25, 1), np.float32)

    def run(use_lam):
        return _constrained_both("pendulum", x0, us, -0.5, 0.5, sqp_iterations=10,
                                 ilqr_iterations=6, penalty_init=10.0, penalty_scale=1.0,
                                 use_multipliers=use_lam)

    with_lam, without_lam = run(True), run(False)
    assert float(torch.max(torch.abs(with_lam.us))) > 0.45
    assert float(with_lam.max_violation) <= 2e-3
    assert float(without_lam.max_violation) > 100 * max(float(with_lam.max_violation), 1e-6)
    assert float(torch.max(with_lam.lam_lo + with_lam.lam_hi)) > 1.0


def test_constrained_tighter_bounds_cost_more():
    system = tm.make_pendulum()
    x0, us = torch.zeros(2), torch.zeros((30, 1))
    cfg = SQPConfig(sqp_iterations=4, ilqr_iterations=4)
    loose = solve_constrained(system, x0, us, -10.0, 10.0, cfg)
    tight = solve_constrained(system, x0, us, -1.0, 1.0, cfg)
    assert float(tight.cost) >= float(loose.cost) - 1e-3


def test_violation_matches_jax():
    rng = np.random.default_rng(0)
    us = (3 * rng.standard_normal((6, 2))).astype(np.float32)
    lo, hi = np.array([-1.0, -2.0], np.float32), np.array([1.0, 0.5], np.float32)
    got = sqp_mpc._violation(*map(torch.from_numpy, (us, lo, hi)))
    np.testing.assert_array_equal(_np(got), np.asarray(jsqp._violation(us, lo, hi)))


def test_mpc_controller_stabilizes_pendulum():
    system, jsystem = tm.make_pendulum(), jm.make_pendulum()
    ctrl = MPCController(system, horizon=20, replan_iters=3)
    jctrl = jsqp.MPCController(jsystem, horizon=20, replan_iters=3)
    x = torch.tensor([np.pi - 0.4, 0.0])
    jx = jnp.asarray(_np(x))
    for _ in range(40):
        u0, cost = ctrl.replan(x)
        x = system.step(x, u0)
        ju0, jcost = jctrl.replan(jx)
        jx = jsystem.step(jx, ju0)
    assert abs(float(x[0]) - np.pi) < 0.2
    assert abs(float(x[1])) < 0.5
    np.testing.assert_allclose(_np(x), np.asarray(jx), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(_np(ctrl.us_warm), np.asarray(jctrl.us_warm), rtol=1e-3, atol=1e-3)


def test_mpc_controller_respects_bounds():
    system = tm.make_pendulum()
    ctrl = MPCController(system, horizon=20, u_min=-3.0, u_max=3.0)
    x = torch.tensor([0.5, 0.0])
    for _ in range(5):
        u0, _ = ctrl.replan(x)
        assert float(torch.max(torch.abs(u0))) <= 3.0 + 1e-6
        x = system.step(x, u0)
    ctrl.reset()
    assert float(ctrl.us_warm.abs().max()) == 0.0


def test_quadrotor_constrained():
    x0 = np.zeros(12, np.float32)
    x0[0] = 0.5
    u_min = np.array([-5.0, -1.0, -1.0, -1.0], np.float32)
    u_max = np.array([5.0, 1.0, 1.0, 1.0], np.float32)
    res = _constrained_both("quadrotor", x0, np.zeros((20, 4), np.float32), u_min, u_max,
                            sqp_iterations=4, ilqr_iterations=4)
    assert float(res.max_violation) <= 1e-5
    assert np.isfinite(float(res.cost))


def test_bicycle_steering_limits_respected():
    """Bicycle + AL box constraints: |steer| <= 0.2 rad; the converged
    controls respect the limit."""
    res = _constrained_both("bicycle", np.zeros(4, np.float32), np.zeros((40, 2), np.float32),
                            np.array([-3.0, -0.2], np.float32), np.array([3.0, 0.2], np.float32),
                            sqp_iterations=6)
    us = _np(res.us)
    assert np.all(np.isfinite(us))
    assert float(res.max_violation) < 5e-3
    assert us[:, 1].max() <= 0.2 + 5e-3 and us[:, 1].min() >= -0.2 - 5e-3
