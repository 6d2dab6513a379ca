"""Parallel-in-time RTI SQP-MPC on the quadrotor on the PyTorch port (one
associative-scan Riccati pass a tick); the twin of examples/rti_mpc.py.

Run: python examples/torch_rti_mpc.py [--ticks 120] [--device cuda|cpu]
"""

import argparse

import numpy as np
import torch

import simplemath_tpu_torch as sm
from simplemath_tpu_torch.models import make_quadrotor
from simplemath_tpu_torch.models.rti import rti_closed_loop


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--horizon", type=int, default=40)
    parser.add_argument("--ticks", type=int, default=120)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    sm.configure(device=args.device)

    system = make_quadrotor()
    x0 = torch.zeros(12, dtype=torch.float32, device=torch.device(args.device))
    x0[0:3] = torch.tensor([0.5, -0.5, 0.3])
    xs, us, costs, defects = rti_closed_loop(system, x0, horizon=args.horizon, ticks=args.ticks)
    xs_np = xs.cpu().numpy()
    for t in range(0, args.ticks, 20):
        print(
            f"t={t:3d}  |pos|={np.linalg.norm(xs_np[t, 0:3]):.3f}"
            f"  cost={float(costs[t]):9.2f}  defect={float(defects[t]):.2e}"
        )
    print("final position error:", float(torch.linalg.norm(xs[-1, 0:3])))
    return xs


if __name__ == "__main__":
    main()
