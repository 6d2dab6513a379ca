"""The port's parallel-in-time RTI SQP-MPC (models/rti.py) against the
JAX package: the affine scan, one tick, closed loops on the pendulum and
the quadrotor.  Twins of tests/test_rti.py at shorter horizons and fewer
ticks; the same float32 numpy inputs go through both packages on the CPU.

Tolerances: the affine scan at test_rti.py's ``rtol=1e-4, atol=1e-5``
against a sequential recursion and against JAX.  A tick's outputs against
JAX within ``rtol=1e-4, atol=1e-5``; a closed loop's states within
``rtol=1e-3, atol=1e-4``: every tick feeds its rounding (an ulp of the
two libraries' ``sin``/``cos``) into the next.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simplemath_tpu_torch as sm
from simplemath_tpu import models as jm
from simplemath_tpu.models import rti as jrti
from simplemath_tpu_torch import models as tm
from simplemath_tpu_torch.models import rti


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's default device is the card; these tests ask for the CPU."""
    old = sm.config.device
    sm.configure(device="cpu")
    yield
    sm.configure(device=old)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_affine_scan_matches_sequential_and_jax():
    rng = np.random.default_rng(0)
    H, n = 17, 5
    A = (0.3 * rng.standard_normal((H, n, n))).astype(np.float32)
    b = rng.standard_normal((H, n)).astype(np.float32)
    x0 = rng.standard_normal(n).astype(np.float32)
    xs = rti.affine_scan(*map(torch.from_numpy, (A, b, x0)))
    x = x0.astype(np.float64)
    for k in range(H):
        x = A[k] @ x + b[k]
        np.testing.assert_allclose(_np(xs[k + 1]), x, rtol=1e-4, atol=1e-5)
    want = jax.jit(jrti.affine_scan)(A, b, x0)
    np.testing.assert_allclose(_np(xs), np.asarray(want), rtol=1e-4, atol=1e-5)


def _tick_both(name, x0, horizon, x_meas):
    js, ts = jm.SYSTEMS[name](), tm.SYSTEMS[name]()
    jstate = jrti.rti_init(js, jnp.asarray(x0), horizon)
    tstate = rti.rti_init(ts, torch.from_numpy(x0), horizon)
    jout = jax.jit(lambda s, x: jrti.rti_tick(js, s, x))(jstate, jnp.asarray(x_meas))
    tout = rti.rti_tick(ts, tstate, torch.from_numpy(x_meas))
    return jout, tout


def test_rti_tick_shapes_and_values():
    x0 = np.zeros(2, np.float32)
    jout, out = _tick_both("pendulum", x0, 20, np.array([0.1, 0.0], np.float32))
    assert out.u0.shape == (1,)
    assert out.state.xs.shape == (21, 2)
    assert np.isfinite(float(out.cost))
    for g, w in ((out.u0, jout.u0), (out.state.xs, jout.state.xs), (out.state.us, jout.state.us),
                 (out.cost, jout.cost), (out.defect_norm, jout.defect_norm)):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_rti_tick_quadrotor_matches_jax():
    """One tick on the 12-state quadrotor: the per-step elements, both
    associative scans (Riccati with defects, affine forward) at nx = 12."""
    x0 = np.zeros(12, np.float32)
    x0[0:3] = [0.5, -0.5, 0.3]
    jout, out = _tick_both("quadrotor", x0, 12, x0)
    for g, w in ((out.u0, jout.u0), (out.state.xs, jout.state.xs), (out.cost, jout.cost)):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4, atol=1e-5)


def _closed_loop_both(name, x0, horizon, ticks):
    js, ts = jm.SYSTEMS[name](), tm.SYSTEMS[name]()
    want = jax.jit(lambda x: jrti.rti_closed_loop(js, x, horizon, ticks))(jnp.asarray(x0))
    got = rti.rti_closed_loop(ts, torch.from_numpy(x0), horizon, ticks)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-3, atol=1e-4)
    return got


def test_rti_closed_loop_stabilizes_pendulum():
    x0 = np.array([np.pi - 0.3, 0.0], np.float32)
    xs, us, costs, defects = _closed_loop_both("pendulum", x0, 20, 40)
    assert abs(float(xs[-1, 0]) - np.pi) < 0.2
    assert abs(float(xs[-1, 1])) < 0.5
    # Defects (shooting infeasibility) shrink as the nominal converges.
    assert float(defects[-1]) < float(defects[0]) + 1e-3


def test_rti_closed_loop_quadrotor():
    x0 = np.zeros(12, np.float32)
    x0[0:3] = [0.5, -0.5, 0.3]
    xs, us, costs, defects = _closed_loop_both("quadrotor", x0, 20, 60)
    assert float(torch.linalg.norm(xs[-1, 0:3])) < 0.15
    assert np.isfinite(_np(costs)).all()
