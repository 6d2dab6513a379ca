"""Batched cartpole swing-up on the PyTorch port: 8192 scenarios, H=100,
one card (BASELINE.json config 4); the twin of examples/batched_cartpole.py.

Run: python examples/torch_batched_cartpole.py [--batch N] [--sharded] [--device cuda|cpu]

``--sharded`` splits the batch over the ranks of the port's parallel layer
(one rank without a launcher; under ``torchrun`` one a card).
"""

import argparse
import time

import numpy as np
import torch

import simplemath_tpu_torch as sm
from simplemath_tpu_torch.models import ILQRConfig, make_cartpole
from simplemath_tpu_torch.models.ilqr import solve_batched
from simplemath_tpu_torch.utils import MetricsLogger


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=8192)
    parser.add_argument("--horizon", type=int, default=100)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--sharded", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    sm.configure(device=args.device)
    device = torch.device(args.device)

    system = make_cartpole()
    cfg = ILQRConfig(iterations=args.iters)
    rng = np.random.default_rng(0)
    x0s = torch.from_numpy((0.2 * rng.standard_normal((args.batch, system.nx))).astype(np.float32))
    x0s = x0s.to(device)
    us = torch.zeros((args.batch, args.horizon, system.nu), dtype=torch.float32, device=device)

    log = MetricsLogger("cartpole")
    if args.sharded:
        from simplemath_tpu_torch import parallel

        mesh = parallel.make_mesh()
        print(f"mesh: {dict(mesh.shape)}")
        t0 = time.perf_counter()
        result, stats = parallel.solve_batched_sharded(system, x0s, us, cfg, mesh)
        mean_cost = float(stats["mean_cost"])
    else:
        t0 = time.perf_counter()
        result = solve_batched(system, x0s, us, cfg)
        mean_cost = float(result.cost.mean())
    dt = time.perf_counter() - t0  # ends in the host read of mean_cost
    log.log(0, mean_cost=mean_cost, wall_s=dt)

    print(f"batch={args.batch} horizon={args.horizon} iters={args.iters}")
    print(f"mean final cost: {mean_cost:.2f}")
    print(f"wall (first run): {dt:.2f}s -> {args.batch / dt:.0f} solves/s")
    trace = result.cost_trace.cpu().numpy()
    print("mean cost per iteration:", np.round(trace.mean(axis=0), 1))
    return result


if __name__ == "__main__":
    main()
