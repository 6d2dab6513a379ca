"""Parallel-in-time real-time-iteration (RTI) SQP-MPC.

Counterpart of ``simplemath_tpu/models/rti.py``.  The 1 kHz replan budget
(BASELINE.json config 5) asks for a tick without O(H) sequential structure:

* **linearize** around the shifted previous nominal, mapped over the
  horizon, depth O(1);
* **defects** d_k = f(x_k, u_k) - x_{k+1} evaluated in parallel
  (multiple-shooting Gauss-Newton: the nominal need not be dynamically
  feasible; defects shrink across ticks);
* **backward pass**: associative scan over affine-quadratic value
  elements with defect offsets, depth O(log H);
* **forward pass**: the closed-loop update is an AFFINE recursion
  dx_{k+1} = (A_k + B_k K_k) dx_k + B_k k_k + d_k, i.e. another
  associative scan, depth O(log H).

No sequential nonlinear rollout anywhere in the tick: one SQP iteration per
tick, warm started.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch.func import vmap

from ..ops.linalg_small import solve_unrolled
from ..utils.precision import f32_matmuls
from . import ilqr as _ilqr
from .dynamics import System, as_tensor
from .scan import associative_scan


@dataclasses.dataclass(frozen=True)
class RTIConfig:
    reg: float = 1e-6
    step_alpha: float = 1.0  # RTI applies full steps; lower to damp
    psd: str = "auto"
    psd_eps: float = 1e-6


class RTIState(NamedTuple):
    xs: torch.Tensor  # (H+1, nx) nominal states
    us: torch.Tensor  # (H, nu) nominal controls


class RTIOutput(NamedTuple):
    u0: torch.Tensor
    state: RTIState
    defect_norm: torch.Tensor
    cost: torch.Tensor


@f32_matmuls
def affine_scan(A, b, x0):
    """All states of x_{k+1} = A_k x_k + b_k via associative scan.

    Returns xs with shape (H+1, nx); depth O(log H)."""

    def combine(e1, e2):
        # e1 earlier in time; composition is (A2 A1, A2 b1 + b2), batched.
        A1, b1 = e1
        A2, b2 = e2
        return A2 @ A1, _ilqr._mv(A2, b1) + b2

    Ps, qs = associative_scan(combine, (A, b))
    xs_tail = (Ps @ x0[None, :, None])[..., 0] + qs
    return torch.cat([x0[None], xs_tail])


def linearize_with_defects(system: System, xs, us):
    """Jacobians, cost derivatives, and shooting defects, all parallel
    over the horizon."""
    A, B, lx, lu, lxx, luu, lux, Vx_T, Vxx_T = _ilqr.linearize(system, xs, us)
    f_next = vmap(system.step)(xs[:-1], us)
    d = f_next - xs[1:]
    return A, B, lx, lu, lxx, luu, lux, Vx_T, Vxx_T, d


@f32_matmuls
def backward_associative_defect(
    A, B, lx, lu, lxx, luu, lux, Vx_T, Vxx_T, d, reg
):
    """Associative-scan Riccati with defect (multiple-shooting) offsets.

    Identical to ilqr.backward_associative but the per-step element carries
    the affine dynamics offset c = d - B luu^{-1} lu, and gain recovery
    uses Vx_{k+1} + Vxx_{k+1} d_k."""
    nu = B.shape[-1]
    nx = A.shape[-1]
    I_u = torch.eye(nu, dtype=B.dtype, device=B.device)
    I_x = torch.eye(nx, dtype=A.dtype, device=A.device)

    def make_elem(inp):
        A_t, B_t, lx_t, lu_t, lxx_t, luu_t, lux_t, d_t = inp
        Ru = luu_t + reg * I_u
        Ru_inv_lux = solve_unrolled(Ru, lux_t)
        Ru_inv_lu = solve_unrolled(Ru, lu_t)
        Ru_inv_Bt = solve_unrolled(Ru, B_t.mT)
        F = A_t - B_t @ Ru_inv_lux
        c = d_t - B_t @ Ru_inv_lu
        C = B_t @ Ru_inv_Bt
        J = lxx_t - lux_t.mT @ Ru_inv_lux
        eta = -(lx_t - lux_t.mT @ Ru_inv_lu)
        return F, c, C, eta, J

    elems = vmap(make_elem)((A, B, lx, lu, lxx, luu, lux, d))
    zmat = torch.zeros((nx, nx), dtype=A.dtype, device=A.device)
    zvec = torch.zeros((nx,), dtype=A.dtype, device=A.device)
    term = (zmat, zvec, zmat, -Vx_T, Vxx_T)
    full = tuple(torch.cat([e, t[None]]) for e, t in zip(elems, term))

    # The elements compose as ilqr.backward_associative's do: the defect
    # rides in c, which that combine already carries.
    suffix = _ilqr.riccati_suffix_scan(full, I_x)

    Vx_all = -suffix[3]
    Vxx_all = suffix[4]

    def gains(inp, Vx, Vxx):
        A_t, B_t, lu_t, luu_t, lux_t, d_t = inp
        Vx_eff = Vx + (Vxx @ d_t[..., None])[..., 0]
        Qu = lu_t + B_t.mT @ Vx_eff
        Quu = luu_t + B_t.mT @ Vxx @ B_t + reg * I_u
        Qux = lux_t + B_t.mT @ Vxx @ A_t
        k_t = -solve_unrolled(Quu, Qu)
        K_t = -solve_unrolled(Quu, Qux)
        return k_t, K_t

    ks, Ks = vmap(gains)((A, B, lu, luu, lux, d), Vx_all[1:], Vxx_all[1:])
    return ks, Ks


@f32_matmuls
def rti_tick(
    system: System,
    state: RTIState,
    x_measured,
    config: RTIConfig = RTIConfig(),
) -> RTIOutput:
    """One real-time iteration: shift, linearize, backward, affine forward.

    Every stage is O(1) or O(log H) in sequential depth."""
    xs, us = state.xs, state.us
    # Shift the nominal one step (receding horizon warm start).
    xs = torch.cat([xs[1:], xs[-1:]])
    us = torch.cat([us[1:], us[-1:]])

    A, B, lx, lu, lxx, luu, lux, Vx_T, Vxx_T, d = linearize_with_defects(
        system, xs, us
    )
    psd_mode = config.psd
    if psd_mode == "auto":
        psd_mode = "clamp_diag" if system.separable_cost else "eigh"
    lxx, luu, lux, Vxx_T = _ilqr.psd_cost_hessians(
        lxx, luu, lux, Vxx_T, psd_mode, config.psd_eps
    )
    reg = torch.full((), config.reg, dtype=xs.dtype, device=xs.device)
    ks, Ks = backward_associative_defect(
        A, B, lx, lu, lxx, luu, lux, Vx_T, Vxx_T, d, reg
    )

    # Closed-loop affine forward pass (associative):
    #   dx_{k+1} = (A_k + B_k K_k) dx_k + alpha*B_k k_k + d_k
    alpha = config.step_alpha
    Acl = A + B @ Ks
    bcl = alpha * _ilqr._mv(B, ks) + d
    dx0 = as_tensor(x_measured, xs.dtype) - xs[0]
    dxs = affine_scan(Acl, bcl, dx0)
    dus = alpha * ks + _ilqr._mv(Ks, dxs[:-1])

    xs_new = xs + dxs
    us_new = us + dus
    cost = _ilqr.trajectory_cost(system, xs_new, us_new)
    return RTIOutput(
        u0=us_new[0],
        state=RTIState(xs=xs_new, us=us_new),
        defect_norm=torch.amax(torch.abs(d)),
        cost=cost,
    )


def rti_init(system: System, x0, horizon: int) -> RTIState:
    """Initial nominal: zero controls, sequential rollout ONCE at startup
    (startup is not latency-critical)."""
    x0 = as_tensor(x0, torch.float32)
    us = torch.zeros((horizon, system.nu), dtype=torch.float32, device=x0.device)
    xs = _ilqr.rollout(system.step, x0, us)
    return RTIState(xs=xs, us=us)


@f32_matmuls
def rti_closed_loop(
    system: System,
    x0,
    horizon: int,
    ticks: int,
    config: RTIConfig = RTIConfig(),
):
    """Closed-loop RTI MPC: ``ticks`` RTI ticks, each followed by one step
    of the true dynamics; returns stacked (xs, us, costs, defects)."""
    state = rti_init(system, x0, horizon)
    x = as_tensor(x0, torch.float32)
    out_xs, out_us, costs, defects = [], [], [], []
    for _ in range(ticks):
        out = rti_tick(system, state, x, config)
        x = system.step(x, out.u0)
        state = out.state
        out_xs.append(x)
        out_us.append(out.u0)
        costs.append(out.cost)
        defects.append(out.defect_norm)
    return (torch.stack(out_xs), torch.stack(out_us), torch.stack(costs),
            torch.stack(defects))
