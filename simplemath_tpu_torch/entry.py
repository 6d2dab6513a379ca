"""The port's twin of the entry point ``__graft_entry__.entry()``.

``entry()`` returns a forward step on the flagship model (a batched
cartpole iLQR solve, ``ILQRConfig(iterations=3)``, batch 32, horizon 20)
and its arguments, zeros on ``config.device``.  The step runs
``solve_batched_jit``, compiled as ``jax.jit(fn)`` compiles
``__graft_entry__.entry()``'s step: on the card, CUDA graphs captured at
the first call and replayed.  Every ``entry()`` shares one cartpole, and
so its graphs: they are cached on the system object (utils/graphs.py).

    step, args = entry()
    cost = step(*args)      # (32,) final costs
"""

from __future__ import annotations

import functools

import torch

from .config import config


@functools.lru_cache(maxsize=None)
def _cartpole():
    from .models import make_cartpole

    return make_cartpole()


def entry():
    from .models import ILQRConfig
    from .models.ilqr import solve_batched_jit

    system = _cartpole()
    cfg = ILQRConfig(iterations=3)

    def step(x0_batch, us_batch):
        result = solve_batched_jit(system, x0_batch, us_batch, cfg)
        return result.cost

    batch, horizon = 32, 20
    x0s = torch.zeros((batch, system.nx), dtype=torch.float32, device=config.device)
    us = torch.zeros((batch, horizon, system.nu), dtype=torch.float32, device=config.device)
    return step, (x0s, us)
