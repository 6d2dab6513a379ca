"""The port's twin of the entry point ``__graft_entry__.entry()``.

``entry()`` returns a forward step on the flagship model (a batched
cartpole iLQR solve, ``ILQRConfig(iterations=3)``, batch 32, horizon 20)
and its arguments, zeros on ``config.device``:

    step, args = entry()
    cost = step(*args)      # (32,) final costs
"""

from __future__ import annotations

import torch

from .config import config


def entry():
    from .models import ILQRConfig, make_cartpole
    from .models.ilqr import solve_batched

    system = make_cartpole()
    cfg = ILQRConfig(iterations=3)

    def step(x0_batch, us_batch):
        result = solve_batched(system, x0_batch, us_batch, cfg)
        return result.cost

    batch, horizon = 32, 20
    x0s = torch.zeros((batch, system.nx), dtype=torch.float32, device=config.device)
    us = torch.zeros((batch, horizon, system.nu), dtype=torch.float32, device=config.device)
    return step, (x0s, us)
