"""Closed-loop simulation: run a controller against (optionally noisy)
dynamics.

Counterpart of ``simplemath_tpu/models/simulate.py``: the deployment shape
for the MPC stack (BASELINE.json config 5), a loop over control ticks with
the solver inside and no host round trip: on the card the tick is one CUDA
graph, replayed once a tick (utils/graphs.py).  The noise comes from a
``torch.Generator`` (the JAX package takes a PRNG key; the two draw
different bits).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.fx.experimental.proxy_tensor import disable_proxy_modes_tracing

from ..utils import graphs
from . import ilqr as _ilqr
from .dynamics import System, as_tensor


class SimResult(NamedTuple):
    xs: torch.Tensor  # (T+1, nx) closed-loop state trajectory
    us: torch.Tensor  # (T, nu) applied controls
    costs: torch.Tensor  # (T,) solver cost per tick


def _tick(static, carry, x_t, bounds):
    """One MPC cycle, the body of the JAX package's ``lax.scan``: replan
    from the warm start, clamp, apply the first control to the dynamics
    plus this tick's noise, shift the warm start."""
    system, cfg = static
    x, us_warm = carry
    res = _ilqr.solve(system, x, us_warm, cfg)
    us = res.us
    if bounds:
        us = torch.clamp(us, *bounds)
    u0 = us[0]
    (noise,) = x_t
    x_next = system.step(x, u0) + noise
    us_next = torch.cat([us[1:], us[-1:]])
    return (x_next, us_next), (x_next, u0, res.cost)


_TICKS = graphs.Scan(_tick)


def closed_loop(
    system: System,
    x0,
    horizon: int,
    ticks: int,
    ilqr_config: Optional[_ilqr.ILQRConfig] = None,
    u_min=None,
    u_max=None,
    noise_std: float = 0.0,
    generator: Optional[torch.Generator] = None,
):
    """Simulate ``ticks`` MPC cycles: replan (warm-started), apply the first
    control, step the (noisy) dynamics.  One compiled program: on the card
    the tick is a CUDA graph replayed ``ticks`` times (utils/graphs.py).
    ``generator`` draws the noise, all of it before the first tick
    (default: one on the state's device seeded with 0)."""
    cfg = ilqr_config or _ilqr.ILQRConfig(iterations=2, alphas=(1.0, 0.5, 0.1))
    x = as_tensor(x0, torch.float32)
    if generator is None:
        generator = torch.Generator(x.device).manual_seed(0)
    # A generator cannot be an input of an exported program: in an export's
    # trace the noise is drawn outside it and the program holds it as a
    # constant, as a JAX export holds the noise of its constant key.
    with disable_proxy_modes_tracing():
        noises = noise_std * torch.randn(
            (ticks, system.nx), generator=generator, dtype=torch.float32, device=x.device
        )
    bounds = ()
    if u_min is not None:
        bounds = tuple(as_tensor(b, torch.float32, x.device) for b in (u_min, u_max))
    us_warm = torch.zeros((horizon, system.nu), dtype=torch.float32, device=x.device)
    _, (xs_tail, us_applied, costs) = _TICKS(
        (system, cfg), (x, us_warm), ticks, xs=(noises,), consts=bounds
    )
    return SimResult(xs=torch.cat([x[None], xs_tail]), us=us_applied, costs=costs)
