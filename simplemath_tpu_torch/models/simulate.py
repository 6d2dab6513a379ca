"""Closed-loop simulation: run a controller against (optionally noisy)
dynamics.

Counterpart of ``simplemath_tpu/models/simulate.py``: the deployment shape
for the MPC stack (BASELINE.json config 5), a loop over control ticks with
the solver inside and no host round trip.  The noise comes from a
``torch.Generator`` (the JAX package takes a PRNG key; the two draw
different bits).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import ilqr as _ilqr
from .dynamics import System, as_tensor


class SimResult(NamedTuple):
    xs: torch.Tensor  # (T+1, nx) closed-loop state trajectory
    us: torch.Tensor  # (T, nu) applied controls
    costs: torch.Tensor  # (T,) solver cost per tick


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
    control, step the (noisy) dynamics.  ``generator`` draws the noise
    (default: one on the state's device seeded with 0)."""
    cfg = ilqr_config or _ilqr.ILQRConfig(iterations=2, alphas=(1.0, 0.5, 0.1))
    x = as_tensor(x0, torch.float32)
    if generator is None:
        generator = torch.Generator(x.device).manual_seed(0)
    noises = noise_std * torch.randn(
        (ticks, system.nx), generator=generator, dtype=torch.float32, device=x.device
    )
    if u_min is not None:
        lo, hi = (as_tensor(b, torch.float32, x.device) for b in (u_min, u_max))
    us_warm = torch.zeros((horizon, system.nu), dtype=torch.float32, device=x.device)
    xs, us_applied, costs = [x], [], []
    for t in range(ticks):
        res = _ilqr.solve(system, x, us_warm, cfg)
        us = res.us
        if u_min is not None:
            us = torch.clamp(us, lo, hi)
        u0 = us[0]
        x = system.step(x, u0) + noises[t]
        us_warm = torch.cat([us[1:], us[-1:]])
        xs.append(x)
        us_applied.append(u0)
        costs.append(res.cost)
    return SimResult(xs=torch.stack(xs), us=torch.stack(us_applied),
                     costs=torch.stack(costs))
