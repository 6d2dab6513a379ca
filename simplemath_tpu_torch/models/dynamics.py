"""Benchmark dynamical systems for the trajectory-optimization layer.

Counterpart of ``simplemath_tpu/models/dynamics.py``: the pendulum swing-up
(BASELINE.json config 3), the cartpole (config 4), the 12-state quadrotor
(config 5) and the kinematic bicycle.  Each system is a pure-function
triple (dynamics, stage cost, final cost) over torch tensors, discretized
with RK4.  Every system is batch-polymorphic: states of shape
``(nx, *batch)`` and controls of ``(nu, *batch)`` work, constants broadcast
from the left (``_left_bcast``).  The same functions run under
``torch.func`` transforms, which the solvers use for their derivatives.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import numpy as np
import torch
from torch.fx.experimental.proxy_tensor import disable_proxy_modes_tracing

from ..config import config
from ..utils import graphs


def as_tensor(x, dtype=None, device=None):
    """``x`` as a tensor of ``dtype`` on ``device``, each kept from a tensor
    when not given; host data goes to ``config.device`` by default."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=dtype, device=device)
    device = device or config.device
    if isinstance(x, (bool, int, float)):
        return torch.full((), x, dtype=dtype, device=device)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def rk4(f: Callable, x, u, dt: float):
    """Classic RK4 step, fully unrolled."""
    k1 = f(x, u)
    k2 = f(x + 0.5 * dt * k1, u)
    k3 = f(x + 0.5 * dt * k2, u)
    k4 = f(x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


@dataclasses.dataclass(frozen=True)
class System:
    """A control system: discrete dynamics + quadratic-ish costs."""

    name: str
    nx: int
    nu: int
    dt: float
    step: Callable  # (x, u) -> x_next
    stage_cost: Callable  # (x, u) -> scalar
    final_cost: Callable  # (x) -> scalar
    # True when the costs are coordinate-separable (diagonal Hessians, no
    # x-u cross terms): iLQR's PSD projection then reduces to exact diagonal
    # clamping instead of a batched eigh (ILQRConfig.psd="auto").
    separable_cost: bool = False
    # True when step/stage_cost/final_cost accept states with arbitrary
    # TRAILING batch axes: x of shape (nx, *batch), u of (nu, *batch),
    # costs returning (*batch).  Lets the batched solvers run rollouts and
    # line searches in batch-minor layout (ops/soa.py).  Leading-axis
    # indexing (``x[0]``) plus ``torch.stack`` along dim 0 gives this for
    # free; constants must broadcast from the left (see _left_bcast).
    batch_polymorphic: bool = False


def _constant(values: tuple, dtype, device) -> torch.Tensor:
    """``values`` on ``device``, from a cache; a CUDA graph being built
    holds the tensor, so that the cache's eviction frees no memory the
    graph reads."""
    t = _cached_constant(values, dtype, device)
    graphs.hold(t)
    return t


@functools.lru_cache(maxsize=1024)
def _cached_constant(values: tuple, dtype, device) -> torch.Tensor:
    # Copied to the card once per (values, dtype, device) and without a
    # stream sync, so that a solve pays no host round trip for constants.
    # Made outside any torch.func transform: a tensor made inside one is
    # that transform's, and must not outlive it in the cache.  Made outside
    # an export's trace too: the program holds it as a constant whether this
    # call or an earlier one made it.  A CUDA graph
    # cannot hold the copy: the warm-up call before a capture makes every
    # constant the program needs, and a program that needs more than the
    # cache holds fails its capture here.
    if graphs.capturing():
        raise graphs.CaptureError(
            f"the constant {values} ({dtype}, {device}) was first asked for while a "
            "CUDA graph was captured; the warm-up call should have made it")
    with torch._C._DisableFuncTorch(), disable_proxy_modes_tracing():
        return torch.tensor(values, dtype=dtype).to(device, non_blocking=True)


def _left_bcast(c, x):
    """A (k,) constant vector in ``x``'s dtype and on its device, shaped to
    broadcast against a stacked (k, *batch) state: (k, 1, ..., 1)."""
    c = _constant(tuple(float(v) for v in np.asarray(c).reshape(-1)), x.dtype, x.device)
    return c.reshape(c.shape + (1,) * (x.ndim - 1))


# ---------------------------------------------------------------- pendulum
def make_pendulum(dt: float = 0.05) -> System:
    """Torque-limited pendulum swing-up: x = [theta, thetadot], target
    upright (theta = pi)."""
    g, m, l, b = 9.81, 1.0, 1.0, 0.1

    def f(x, u):
        th, thd = x[0], x[1]
        thdd = (u[0] - b * thd - m * g * l * torch.sin(th)) / (m * l * l)
        return torch.stack([thd, thdd])

    def step(x, u):
        return rk4(f, x, u, dt)

    def stage_cost(x, u):
        th_err = x[0] - math.pi
        return 0.5 * (th_err**2 + 0.1 * x[1] ** 2 + 0.01 * u[0] ** 2)

    def final_cost(x):
        th_err = x[0] - math.pi
        return 0.5 * (100.0 * th_err**2 + 10.0 * x[1] ** 2)

    return System("pendulum", 2, 1, dt, step, stage_cost, final_cost,
                  separable_cost=True, batch_polymorphic=True)


def make_sm_pendulum(dt: float = 0.05) -> System:
    """The pendulum with its dynamics and costs written in the ``sm`` API
    (sm.Array in, sm ops, sm.Array out), as the JAX package's
    tests/test_models.py::_make_sm_pendulum writes them: the north star's
    form, "per-stage dynamics and cost math expressed through the SMArray
    API".  Numerically ``make_pendulum``, and batch-polymorphic like it.
    The solvers' ``torch.func`` transforms run its sm ops through
    ops/autodiff.py, on the kernels."""
    from .. import api as sm
    from ..array import Array

    g, m, l, b = 9.81, 1.0, 1.0, 0.1

    def f(x, u):
        th, thd = x[0], x[1]
        thdd = (u[0] - thd * b - sm.sin(th) * (m * g * l)) / (m * l * l)
        return sm.stack([thd, thdd])

    def step(x, u):
        k1 = f(x, u)
        k2 = f(x + k1 * (0.5 * dt), u)
        k3 = f(x + k2 * (0.5 * dt), u)
        k4 = f(x + k3 * dt, u)
        return x + (k1 + k2 * 2.0 + k3 * 2.0 + k4) * (dt / 6.0)

    def stage_cost(x, u):
        th_err = x[0] - float(np.pi)
        return (th_err * th_err + x[1] * x[1] * 0.1 + u[0] * u[0] * 0.01) * 0.5

    def final_cost(x):
        th_err = x[0] - float(np.pi)
        return (th_err * th_err * 100.0 + x[1] * x[1] * 10.0) * 0.5

    return System(
        "sm_pendulum", 2, 1, dt,
        step=lambda x, u: step(Array(x), Array(u)).torch(),
        stage_cost=lambda x, u: stage_cost(Array(x), Array(u)).torch(),
        final_cost=lambda x: final_cost(Array(x)).torch(),
        separable_cost=True, batch_polymorphic=True,
    )


# ---------------------------------------------------------------- cartpole
def make_cartpole(dt: float = 0.02) -> System:
    """Cartpole swing-up: x = [p, pdot, theta, thetadot], theta = 0 is
    hanging, target theta = pi (up)."""
    mc, mp, l, g = 1.0, 0.3, 0.5, 9.81

    def f(x, u):
        _, pd, th, thd = x[0], x[1], x[2], x[3]
        s, c = torch.sin(th), torch.cos(th)
        force = u[0]
        denom = mc + mp * s * s
        pdd = (force + mp * s * (l * thd * thd + g * c)) / denom
        thdd = (-force * c - mp * l * thd * thd * c * s - (mc + mp) * g * s) / (
            l * denom
        )
        return torch.stack([pd, pdd, thd, thdd])

    def step(x, u):
        return rk4(f, x, u, dt)

    def stage_cost(x, u):
        # Upright target via cos(theta) = -1 (smooth, no angle wrapping).
        up_err = 1.0 + torch.cos(x[2])
        return 0.5 * (
            0.1 * x[0] ** 2 + 10.0 * up_err**2 + 0.1 * x[3] ** 2 + 0.01 * u[0] ** 2
        )

    def final_cost(x):
        up_err = 1.0 + torch.cos(x[2])
        return 0.5 * (
            10.0 * x[0] ** 2
            + 500.0 * up_err**2
            + 10.0 * x[1] ** 2
            + 50.0 * x[3] ** 2
        )

    return System("cartpole", 4, 1, dt, step, stage_cost, final_cost,
                  separable_cost=True, batch_polymorphic=True)


# --------------------------------------------------------------- quadrotor
def make_quadrotor(dt: float = 0.02) -> System:
    """12-state quadrotor (BASELINE.json config 5): position (3), velocity
    (3), Euler attitude (3), body rates (3); controls = total thrust +
    body-rate torques (4).  Euler-angle model; costs regulate to hover at
    the origin."""
    mass, g = 1.0, 9.81
    J_np = np.array([0.01, 0.01, 0.02])  # diagonal inertia

    def f(x, u):
        # Constants follow the state dtype, so float32 pipelines stay
        # float32, and broadcast from the LEFT so stacked (nx, *batch)
        # states work (batch_polymorphic).
        J = _left_bcast(J_np, x)
        vel = x[3:6]
        phi, theta, psi = x[6], x[7], x[8]
        omega = x[9:12]
        thrust = u[0] + mass * g  # u[0] is delta-thrust around hover
        torque = u[1:4]

        cph, sph = torch.cos(phi), torch.sin(phi)
        cth, sth = torch.cos(theta), torch.sin(theta)
        cps, sps = torch.cos(psi), torch.sin(psi)
        # Body-z axis in world frame (ZYX Euler).
        zb = torch.stack(
            [cph * sth * cps + sph * sps, cph * sth * sps - sph * cps, cph * cth]
        )
        gvec = _left_bcast([0.0, 0.0, g], x)
        acc = (thrust / mass) * zb - gvec

        # Euler kinematics (ZYX): eulerdot = E(phi, theta) @ omega.
        tth = sth / cth
        eulerdot = torch.stack(
            [
                omega[0] + tth * (sph * omega[1] + cph * omega[2]),
                cph * omega[1] - sph * omega[2],
                (sph * omega[1] + cph * omega[2]) / cth,
            ]
        )
        omegadot = (torque - torch.linalg.cross(omega, J * omega, dim=0)) / J
        return torch.cat([vel, acc, eulerdot, omegadot])

    def step(x, u):
        return rk4(f, x, u, dt)

    Qdiag_np = np.array(
        [10.0, 10.0, 10.0, 1.0, 1.0, 1.0, 5.0, 5.0, 5.0, 0.1, 0.1, 0.1]
    )
    Rdiag_np = np.array([0.1, 0.5, 0.5, 0.5])

    def stage_cost(x, u):
        Qd = _left_bcast(Qdiag_np, x)
        Rd = _left_bcast(Rdiag_np, u)
        return 0.5 * (torch.sum(Qd * x * x, dim=0) + torch.sum(Rd * u * u, dim=0))

    def final_cost(x):
        Qd = _left_bcast(Qdiag_np, x)
        return 0.5 * 10.0 * torch.sum(Qd * x * x, dim=0)

    return System("quadrotor", 12, 4, dt, step, stage_cost, final_cost,
                  separable_cost=True, batch_polymorphic=True)


# ----------------------------------------------------------------- bicycle
def make_bicycle(dt: float = 0.05, wheelbase: float = 2.7,
                 target=(20.0, 3.0)) -> System:
    """Kinematic bicycle (car) lane-change / waypoint tracking.
    x = [px, py, yaw, v], u = [accel, steer]: the two-input model family.
    Costs drive to ``target`` at cruise speed with straight heading;
    steering enters the dynamics through tan(delta)/L, so the problem is
    nonlinear in the controls."""
    v_ref = 5.0
    tgt_np = np.array([target[0], target[1]])

    def f(x, u):
        yaw, v = x[2], x[3]
        a, delta = u[0], u[1]
        return torch.stack(
            [
                v * torch.cos(yaw),
                v * torch.sin(yaw),
                v * torch.tan(delta) / wheelbase,
                a,
            ]
        )

    def step(x, u):
        return rk4(f, x, u, dt)

    def stage_cost(x, u):
        tgt = _left_bcast(tgt_np, x)
        ex = x[0] - tgt[0]
        ey = x[1] - tgt[1]
        return 0.5 * (
            0.02 * ex**2
            + 0.1 * ey**2
            + 0.5 * x[2] ** 2
            + 0.05 * (x[3] - v_ref) ** 2
            + 0.1 * u[0] ** 2
            + 1.0 * u[1] ** 2
        )

    def final_cost(x):
        tgt = _left_bcast(tgt_np, x)
        ex = x[0] - tgt[0]
        ey = x[1] - tgt[1]
        return 0.5 * (
            10.0 * ex**2 + 50.0 * ey**2 + 20.0 * x[2] ** 2
            + 5.0 * (x[3] - v_ref) ** 2
        )

    return System("bicycle", 4, 2, dt, step, stage_cost, final_cost,
                  separable_cost=True, batch_polymorphic=True)


SYSTEMS = {
    "pendulum": make_pendulum,
    "cartpole": make_cartpole,
    "quadrotor": make_quadrotor,
    "bicycle": make_bicycle,
}
