"""Quadrotor MPC closed loop on the PyTorch port: hover recovery from an
offset, with control bounds (BASELINE.json config 5's workload, one
scenario); the twin of examples/mpc_quadrotor.py.

Run: python examples/torch_mpc_quadrotor.py [--ticks 100] [--device cuda|cpu]
"""

import argparse

import numpy as np
import torch

import simplemath_tpu_torch as sm
from simplemath_tpu_torch.models import make_quadrotor
from simplemath_tpu_torch.models.sqp_mpc import MPCController


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--horizon", type=int, default=50)
    parser.add_argument("--ticks", type=int, default=100)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    sm.configure(device=args.device)

    system = make_quadrotor()
    ctrl = MPCController(
        system,
        horizon=args.horizon,
        u_min=np.array([-5.0, -1.0, -1.0, -1.0], np.float32),
        u_max=np.array([5.0, 1.0, 1.0, 1.0], np.float32),
        replan_iters=2,
    )

    x = torch.zeros(12, dtype=torch.float32, device=torch.device(args.device))
    x[0:3] = torch.tensor([1.0, -1.0, 0.5])
    for t in range(args.ticks):
        u0, cost = ctrl.replan(x)
        x = system.step(x, u0)
        if t % 20 == 0:
            pos = x[0:3].cpu().numpy()
            print(f"t={t:3d}  |pos|={np.linalg.norm(pos):.3f}  cost={float(cost):.1f}")

    print("final position error:", float(torch.linalg.norm(x[0:3])))
    return x


if __name__ == "__main__":
    main()
