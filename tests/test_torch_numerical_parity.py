"""Numerical parity of the port's solvers: float32 against a float64
reference (BASELINE.json's north star), the float32 matmul pin of every
solver entry point, the ``debug_checks`` finite guard, and the port's
twin of ``__graft_entry__.entry()``.  Twins of tests/test_numerical_parity.py
(minus the parallel layer's entries) at its tolerances: controls within
``rtol=0.05, atol=0.05`` of float64, costs within 1e-3 (pendulum) and
5e-3 (cartpole) relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simplemath_tpu_torch as sm
from simplemath_tpu_torch.models import ILQRConfig, make_cartpole, make_pendulum
from simplemath_tpu_torch.models.ilqr import solve


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's default device is the card; these tests ask for the CPU."""
    old = sm.config.device
    sm.configure(device="cpu")
    yield
    sm.configure(device=old)


def _solve_in_dtype(system, x0, horizon, dtype, iters=20):
    x0 = torch.tensor(x0, dtype=dtype)
    us = torch.zeros((horizon, system.nu), dtype=dtype)
    return solve(system, x0, us, ILQRConfig(iterations=iters))


def test_pendulum_f32_matches_f64_controls():
    system = make_pendulum()
    r32 = _solve_in_dtype(system, [0.4, 0.0], 40, torch.float32)
    r64 = _solve_in_dtype(system, [0.4, 0.0], 40, torch.float64)
    assert r32.us.dtype == torch.float32 and r64.us.dtype == torch.float64
    assert abs(float(r32.cost) - float(r64.cost)) / float(r64.cost) < 1e-3
    np.testing.assert_allclose(r32.us.numpy(), r64.us.numpy(), rtol=0.05, atol=0.05)


def test_cartpole_f32_matches_f64_cost():
    system = make_cartpole()
    r32 = _solve_in_dtype(system, [0.0, 0.0, 0.3, 0.0], 40, torch.float32, iters=10)
    r64 = _solve_in_dtype(system, [0.0, 0.0, 0.3, 0.0], 40, torch.float64, iters=10)
    assert abs(float(r32.cost) - float(r64.cost)) / float(r64.cost) < 5e-3


def test_float64_solve_matches_jax_float64():
    """The float64 reference itself: the port's and the JAX package's
    float64 solves agree to float64 rounding carried through the iterations."""
    from simplemath_tpu.models import make_pendulum as jpendulum
    from simplemath_tpu.models.ilqr import ILQRConfig as JConfig, solve as jsolve

    r64 = _solve_in_dtype(make_pendulum(), [0.4, 0.0], 20, torch.float64, iters=6)
    js = jpendulum()
    want = jax.jit(lambda x, u: jsolve(js, x, u, JConfig(iterations=6)))(
        jnp.asarray([0.4, 0.0], jnp.float64), jnp.zeros((20, 1), jnp.float64))
    np.testing.assert_allclose(r64.us.numpy(), np.asarray(want.us), rtol=1e-9, atol=1e-9)


def _entry_points():
    from simplemath_tpu_torch.models import ilqr, rti, sqp_mpc

    return [
        ilqr.linearize, ilqr.linearize_soa,
        ilqr.backward_sequential, ilqr.backward_sequential_soa,
        ilqr.backward_associative, ilqr.backward_associative_soa,
        ilqr.forward_linesearch, ilqr.forward_linesearch_soa,
        ilqr.solve, ilqr.solve_batched,
        rti.affine_scan, rti.backward_associative_defect,
        rti.rti_tick, rti.rti_closed_loop,
        sqp_mpc.solve_constrained,
    ]


def test_solver_entry_points_pin_f32_matmul_precision():
    """Every solver entry point the JAX package pins (tests/
    test_numerical_parity.py, minus the parallel layer's) is pinned in the
    port too, but for the ``ops/soa.py`` helpers: they multiply entry by
    entry and call no matmul, and in eager torch the pin would cost a
    context switch on every call (the JAX package pins at trace time, for
    nothing)."""
    unpinned = [fn.__name__ for fn in _entry_points()
                if not getattr(fn, "_pins_f32_matmuls", False)]
    assert not unpinned, f"solver entry points missing @f32_matmuls: {unpinned}"


def test_pin_turns_tf32_off_and_restores_it():
    from simplemath_tpu_torch.ops import matmul as mm
    from simplemath_tpu_torch.utils import f32_matmuls
    from simplemath_tpu_torch.utils.precision import exact_float32

    assert mm.exact_float32 is exact_float32  # one helper for engine and solvers
    seen = []

    @f32_matmuls
    def probe(fail=False):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        if fail:
            raise RuntimeError("inside")

    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        probe()
        assert torch.backends.cuda.matmul.allow_tf32 is True
        with pytest.raises(RuntimeError, match="inside"):
            probe(fail=True)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert seen == [False, False]


def test_debug_checks_guard_raises_on_singular_input_and_is_silent_off():
    from simplemath_tpu_torch.ops import linalg_small, soa

    singular = torch.tensor([[[1.0, 2.0, 0.0], [2.0, 4.0, 0.0], [0.0, 0.0, 1.0]]])
    soa_singular = singular.permute(1, 2, 0).contiguous()
    old = sm.config.debug_checks
    try:
        sm.configure(debug_checks=False)
        assert not torch.isfinite(linalg_small.inv_unrolled(singular)).all()
        assert not torch.isfinite(soa.inv(soa_singular)).all()
        sm.configure(debug_checks=True)
        with pytest.raises(FloatingPointError, match="inv_unrolled"):
            linalg_small.inv_unrolled(singular)
        with pytest.raises(FloatingPointError, match="soa.inv"):
            soa.inv(soa_singular)
        with pytest.raises(FloatingPointError, match="soa.inv"):
            soa.inv(torch.zeros((2, 2, 3)))  # the n = 2 closed form
        well = torch.eye(3)[None] * 2.0
        np.testing.assert_allclose(linalg_small.inv_unrolled(well).numpy(), np.eye(3)[None] / 2)
    finally:
        sm.configure(debug_checks=old)


def test_inv_unrolled_matches_jax():
    from simplemath_tpu.ops import linalg_small as jls
    from simplemath_tpu_torch.ops import linalg_small

    rng = np.random.default_rng(0)
    M = rng.standard_normal((6, 4, 4))
    A = (M @ np.swapaxes(M, -1, -2) + 4 * np.eye(4)).astype(np.float32)
    b = rng.standard_normal((6, 4)).astype(np.float32)
    np.testing.assert_allclose(linalg_small.inv_unrolled(torch.from_numpy(A)).numpy(),
                               np.asarray(jls.inv_unrolled(jnp.asarray(A))), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(linalg_small.solve_unrolled(torch.from_numpy(A), torch.from_numpy(b)).numpy(),
                               np.asarray(jls.solve_unrolled(jnp.asarray(A), jnp.asarray(b))),
                               rtol=1e-5, atol=1e-6)


def test_entry_matches_graft_entry():
    """The port's entry() against __graft_entry__.entry(): the same step
    (a batched cartpole solve, 3 iterations, batch 32, horizon 20) on the
    same zeros."""
    import __graft_entry__ as g
    from simplemath_tpu_torch import entry

    step, args = entry.entry()
    assert [tuple(a.shape) for a in args] == [(32, 4), (32, 20, 1)]
    assert all(a.device.type == "cpu" and a.dtype == torch.float32 for a in args)
    jstep, jargs = g.entry()
    np.testing.assert_allclose(step(*args).numpy(), np.asarray(jax.jit(jstep)(*jargs)), rtol=1e-4)
