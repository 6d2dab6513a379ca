"""SQP-style MPC: constrained trajectory optimization + receding-horizon
replanning (BASELINE.json config 5: 12-state quadrotor, H=50, 1 kHz
replan).

Counterpart of ``simplemath_tpu/models/sqp_mpc.py``:

* ``solve_constrained``: augmented-Lagrangian iLQR.  The SQP outer loop
  linearizes dynamics and quadratizes the AL-penalized cost, the inner iLQR
  solves the resulting LQ subproblem (sequential or associative-scan
  Riccati), and multiplier/penalty updates enforce control box
  constraints.  Static iteration counts, no host round trip.
* ``MPCController``: warm-started receding-horizon wrapper, one
  ``replan(x)`` per tick.
* ``scenario_mpc_step``: robust scenario MPC with a SHARED first control.
  Per-scenario backward passes run sharded over the mesh's scenario axis
  and the first-step KKT block (Quu_0, Qu_0) is summed across the ranks
  with ``psum`` (parallel/collectives.py): the distributed QP/KKT block
  reduction of BASELINE.json configs 4-5.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch.func import vmap

from ..config import config
from ..utils.precision import f32_matmuls
from . import ilqr as _ilqr
from .dynamics import System, _constant, as_tensor


@dataclasses.dataclass(frozen=True)
class SQPConfig:
    # Defaults tuned in the JAX package on the pendulum swing-up /
    # quadrotor hover workloads: 8x8 iterations with mu: 100 -> 5^7*100
    # drive box violations to ~1e-6 without post-hoc clipping; faster mu
    # growth (or fewer inner iterations) destabilizes the inner solves.
    sqp_iterations: int = 8  # outer AL multiplier/penalty updates
    ilqr_iterations: int = 8  # inner LQ solves per outer iteration
    penalty_init: float = 100.0
    penalty_scale: float = 5.0
    penalty_max: float = 1e6
    alphas: tuple = (1.0, 0.5, 0.25, 0.1)
    reg_init: float = 1e-5
    reg_scale_up: float = 10.0
    reg_scale_down: float = 0.5
    reg_max: float = 1e8
    backward: str = "sequential"
    # Debug switch: freeze multipliers at zero, degrading AL to a pure
    # quadratic-penalty method.  Exists so tests can prove the multiplier
    # update is load-bearing (with penalty_scale=1.0, the penalty method
    # stalls at O(grad/mu) violation while true AL converges).
    use_multipliers: bool = True


class ConstrainedResult(NamedTuple):
    xs: torch.Tensor
    us: torch.Tensor  # the AL iterate itself — NOT post-hoc clipped
    cost: torch.Tensor  # true (unpenalized) cost of (xs, us)
    max_violation: torch.Tensor  # max box violation of the returned us
    lam_lo: torch.Tensor  # (H, nu) lower-bound multipliers (diagnostics)
    lam_hi: torch.Tensor  # (H, nu) upper-bound multipliers


def _violation(us, u_min, u_max):
    return torch.clamp_min(us - u_max, 0.0) + torch.clamp_min(u_min - us, 0.0)


@f32_matmuls
def solve_constrained(
    system: System,
    x0,
    us_init,
    u_min,
    u_max,
    config: SQPConfig = SQPConfig(),
) -> ConstrainedResult:
    """Augmented-Lagrangian iLQR on control box constraints.

    Standard PHR (Powell-Hestenes-Rockafellar) augmented Lagrangian for the
    inequalities g_hi = u - u_max <= 0 and g_lo = u_min - u <= 0 with
    per-step multipliers lam_hi, lam_lo (H, nu):

        L_A = f(x, u) + (1/2mu) * sum[ max(0, lam + mu g)^2 - lam^2 ]

    The inner loop runs iLQR iterations on L_A; since the constraints
    involve only u, the AL terms contribute analytically to lu (the
    projected multiplier estimate max(0, lam + mu g)) and to luu (mu on the
    diagonal where active); lx/lxx/lux are untouched.  The outer loop
    applies the first-order multiplier update

        lam^+ = max(0, lam + mu * g(u))

    and scales mu.  The returned iterate is NOT clipped: max_violation
    measures the true AL convergence.
    """
    u_min = as_tensor(u_min, us_init.dtype, us_init.device)
    u_max = as_tensor(u_max, us_init.dtype, us_init.device)
    nu = us_init.shape[-1]
    I_u = torch.eye(nu, dtype=us_init.dtype, device=us_init.device)
    backward = (
        _ilqr.backward_associative
        if config.backward == "associative"
        else _ilqr.backward_sequential
    )
    psd = "clamp_diag" if system.separable_cost else "eigh"

    def al_penalty(us, lam_lo, lam_hi, mu):
        """Scalar PHR penalty term (whole horizon)."""
        p_hi = torch.clamp_min(lam_hi + mu * (us - u_max), 0.0)
        p_lo = torch.clamp_min(lam_lo + mu * (u_min - us), 0.0)
        return (
            torch.sum(p_hi * p_hi - lam_hi * lam_hi)
            + torch.sum(p_lo * p_lo - lam_lo * lam_lo)
        ) / (2.0 * mu)

    def al_derivs(us, lam_lo, lam_hi, mu):
        """(H, nu) gradient and (H, nu, nu) diagonal Hessian of the AL
        penalty w.r.t. u, exact (the projections are piecewise linear)."""
        p_hi = torch.clamp_min(lam_hi + mu * (us - u_max), 0.0)
        p_lo = torch.clamp_min(lam_lo + mu * (u_min - us), 0.0)
        g = p_hi - p_lo
        active = (p_hi > 0.0).to(us.dtype) + (p_lo > 0.0).to(us.dtype)
        hess = mu * active[..., None] * I_u
        return g, hess

    def al_linesearch(xs, us, ks, Ks, lam_lo, lam_hi, mu):
        """Closed-loop rollouts at every alpha at once, scored by the FULL
        augmented objective (base cost + AL penalty)."""
        alphas = _constant(tuple(map(float, config.alphas)), us.dtype, us.device)

        def rollout_alpha(alpha):
            xs_new, us_new = _ilqr.feedback_rollout(system, xs, us, ks, Ks, alpha)
            obj = _ilqr.trajectory_cost(system, xs_new, us_new) + al_penalty(
                us_new, lam_lo, lam_hi, mu
            )
            return xs_new, us_new, obj

        xs_c, us_c, objs = vmap(rollout_alpha)(alphas)
        best = torch.argmin(objs)
        return _ilqr._take(xs_c, best), _ilqr._take(us_c, best), _ilqr._take(objs, best)

    def inner_ilqr(xs, us, lam_lo, lam_hi, mu):
        """iLQR iterations on the augmented objective L_A."""
        obj = _ilqr.trajectory_cost(system, xs, us) + al_penalty(
            us, lam_lo, lam_hi, mu
        )
        reg = torch.full((), config.reg_init, dtype=us.dtype, device=us.device)
        for _ in range(config.ilqr_iterations):
            A, B, lx, lu, lxx, luu, lux, Vx_T, Vxx_T = _ilqr.linearize(
                system, xs, us
            )
            lxx, luu, lux, Vxx_T = _ilqr.psd_cost_hessians(
                lxx, luu, lux, Vxx_T, psd, 1e-6
            )
            al_g, al_h = al_derivs(us, lam_lo, lam_hi, mu)
            ks, Ks = backward(
                A, B, lx, lu + al_g, lxx, luu + al_h, lux, Vx_T, Vxx_T, reg
            )
            xs_new, us_new, obj_new = al_linesearch(
                xs, us, ks, Ks, lam_lo, lam_hi, mu
            )
            improved = torch.isfinite(obj_new) & (obj_new < obj)
            xs = torch.where(improved, xs_new, xs)
            us = torch.where(improved, us_new, us)
            obj = torch.where(improved, obj_new, obj)
            reg = _ilqr._next_reg(improved, reg, config)
        return xs, us

    us = us_init
    lam_lo = lam_hi = torch.zeros_like(us_init)
    mu = torch.full((), config.penalty_init, dtype=us_init.dtype, device=us_init.device)
    for _ in range(config.sqp_iterations):
        xs = _ilqr.rollout(system.step, x0, us)
        xs, us = inner_ilqr(xs, us, lam_lo, lam_hi, mu)
        # First-order multiplier update at the new iterate.
        if config.use_multipliers:
            lam_hi = torch.clamp_min(lam_hi + mu * (us - u_max), 0.0)
            lam_lo = torch.clamp_min(lam_lo + mu * (u_min - us), 0.0)
        mu = torch.clamp_max(mu * config.penalty_scale, config.penalty_max)
    xs = _ilqr.rollout(system.step, x0, us)
    cost = _ilqr.trajectory_cost(system, xs, us)
    viol = torch.amax(_violation(us, u_min, u_max))
    return ConstrainedResult(
        xs=xs, us=us, cost=cost, max_violation=viol, lam_lo=lam_lo, lam_hi=lam_hi
    )


class MPCController:
    """Receding-horizon controller with warm starts.

    ``replan(x)`` shifts the previous control sequence one step, runs
    ``replan_iters`` iLQR iterations (optionally with box clamping), and
    returns the first control and the new warm start.  Call it in the
    physical control loop at the replan rate.
    """

    def __init__(
        self,
        system: System,
        horizon: int,
        u_min=None,
        u_max=None,
        replan_iters: int = 2,
        alphas: tuple = (1.0, 0.5, 0.1),
        backward: str = "sequential",
    ):
        self.system = system
        self.horizon = horizon
        self.u_min = u_min
        self.u_max = u_max
        self._config = _ilqr.ILQRConfig(
            iterations=replan_iters, alphas=alphas, backward=backward
        )
        self.us_warm = torch.zeros((horizon, system.nu), dtype=torch.float32,
                                   device=config.device)
        if u_min is not None:
            self._lo, self._hi = (as_tensor(b, torch.float32, self.us_warm.device)
                                  for b in (u_min, u_max))

    def _replan(self, x, us_warm):
        res = _ilqr.solve(self.system, x, us_warm, self._config)
        us = res.us
        if self.u_min is not None:
            us = torch.clamp(us, self._lo, self._hi)
        # Shift for the next warm start (repeat last control).
        us_next = torch.cat([us[1:], us[-1:]])
        return us[0], us_next, res.cost

    def replan(self, x):
        u0, self.us_warm, cost = self._replan(as_tensor(x), self.us_warm)
        return u0, cost

    def reset(self):
        self.us_warm = torch.zeros_like(self.us_warm)


@f32_matmuls
def make_scenario_mpc_step(
    system: System,
    mesh,
    axis_name: str = "scenario",
    ilqr_config: Optional[_ilqr.ILQRConfig] = None,
):
    """Build the sharded scenario-consensus step once.  Returns
    ``step(x0_batch, us_batch) -> (us', du0, stats)``; every rank is handed
    the global batch and returns the global result.

    Each scenario k runs its own backward pass; the first-step QP/KKT block
    (Quu_0^k, Qu_0^k) is summed across the mesh (``psum``) and the
    consensus first control update  du0 = -(Σ Quu_0^k)^{-1} Σ Qu_0^k  is
    applied to every scenario through a mesh-wide line search.  The
    candidates' costs are summed across the mesh in one ``psum`` of the
    vector of them, so every rank picks the same step.
    """
    from ..parallel import collectives
    from ..parallel.mesh import PartitionSpec as P

    cfg = ilqr_config or _ilqr.ILQRConfig(iterations=1)

    def per_scenario(x0, us):
        xs = _ilqr.rollout(system.step, x0, us)
        A, B, lx, lu, lxx, luu, lux, VxT, VxxT = _ilqr.linearize(system, xs, us)
        reg = torch.full((), cfg.reg_init, dtype=us.dtype, device=us.device)
        ks, Ks, Vx_all, Vxx_all = _ilqr.backward_associative(
            A, B, lx, lu, lxx, luu, lux, VxT, VxxT, reg, return_values=True
        )
        # Exact first-step KKT block from the Riccati value at t=1.
        I_u = torch.eye(us.shape[-1], dtype=us.dtype, device=us.device)
        Quu0 = luu[0] + B[0].mT @ Vxx_all[1] @ B[0] + cfg.reg_init * I_u
        Qu0 = lu[0] + B[0].mT @ Vx_all[1]
        return ks, Ks, Quu0, Qu0, xs

    def shard_fn(x0s, uss):
        ks, Ks, Quu0, Qu0, xs = vmap(per_scenario)(x0s, uss)
        # Distributed KKT block reduction across the scenario axis.
        Quu_sum = collectives.psum(torch.sum(Quu0, dim=0), axis_name)
        Qu_sum = collectives.psum(torch.sum(Qu0, dim=0), axis_name)
        du0 = -torch.linalg.solve(Quu_sum, Qu_sum)

        # Line search on the CONSENSUS objective (sum of scenario costs
        # across the whole mesh): one shared step length scales both the
        # consensus first-step update and the per-scenario feedforwards,
        # with closed-loop feedback rollouts per candidate.  alpha = 0 is
        # among the candidates, so the accepted step never increases the
        # total cost.
        ff = torch.cat([torch.broadcast_to(du0, ks[:, :1, :].shape), ks[:, 1:, :]], dim=1)
        alphas = torch.cat([
            _constant(tuple(map(float, cfg.alphas)), uss.dtype, uss.device),
            torch.zeros((1,), dtype=uss.dtype, device=uss.device),
        ])

        def eval_alpha(alpha):
            def per_scen(x0, us, xs_ref, f, K):
                xs_new, us_new = _ilqr.feedback_rollout(system, xs_ref, us, f, K, alpha)
                return us_new, _ilqr.trajectory_cost(system, xs_new, us_new)

            us_a, cost_a = vmap(per_scen)(x0s, uss, xs, ff, Ks)
            return us_a, torch.sum(cost_a)

        us_c, local = vmap(eval_alpha)(alphas)
        totals = collectives.psum(local, axis_name)
        best = torch.argmin(totals)
        us_new = _ilqr._take(us_c, best)
        total = _ilqr._take(totals, best)
        alpha_star = _ilqr._take(alphas, best)
        return us_new, du0, {"total_cost": total, "alpha": alpha_star}

    spec = P(axis_name)
    sharded = collectives.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(spec, spec),
        out_specs=(spec, P(), {"total_cost": P(), "alpha": P()}),
        check_vma=False,
    )
    # The pin must hold while the returned step runs, not only while
    # make_scenario_mpc_step does.
    return f32_matmuls(sharded)


def scenario_mpc_step(
    system: System,
    x0_batch,
    us_batch,
    mesh,
    axis_name: str = "scenario",
    ilqr_config: Optional[_ilqr.ILQRConfig] = None,
):
    """One scenario-consensus update (see :func:`make_scenario_mpc_step`;
    for repeated stepping build the step once or use
    :func:`scenario_mpc_solve`)."""
    fn = make_scenario_mpc_step(system, mesh, axis_name, ilqr_config)
    return fn(x0_batch, us_batch)


def scenario_mpc_solve(
    system: System,
    x0_batch,
    us_batch,
    mesh,
    iterations: int = 5,
    axis_name: str = "scenario",
    ilqr_config: Optional[_ilqr.ILQRConfig] = None,
):
    """Iterate the consensus step.  Returns ``(us, du0_last, history)``
    where ``history`` is the per-iteration total cost (non-increasing by
    construction of the line search).  Every iteration re-linearizes,
    re-reduces the first-step KKT block across the mesh, and line-searches
    the consensus step; each reads its total back to the host."""
    step = make_scenario_mpc_step(system, mesh, axis_name, ilqr_config)
    history = []
    du0 = None
    for _ in range(iterations):
        us_batch, du0, stats = step(x0_batch, us_batch)
        history.append(float(stats["total_cost"]))
    return us_batch, du0, history
