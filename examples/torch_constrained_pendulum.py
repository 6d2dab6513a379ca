"""Constrained swing-up on the PyTorch port: augmented-Lagrangian iLQR on
torque bounds; the twin of examples/constrained_pendulum.py.

Run: python examples/torch_constrained_pendulum.py [--device cuda|cpu]
"""

import argparse

import numpy as np
import torch

import simplemath_tpu_torch as sm
from simplemath_tpu_torch.models import make_pendulum
from simplemath_tpu_torch.models.sqp_mpc import SQPConfig, solve_constrained


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--horizon", type=int, default=50)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    sm.configure(device=args.device)
    device = torch.device(args.device)

    system = make_pendulum()
    x0 = torch.zeros(2, dtype=torch.float32, device=device)  # hanging at rest
    us0 = torch.zeros((args.horizon, 1), dtype=torch.float32, device=device)

    res = solve_constrained(system, x0, us0, u_min=-2.0, u_max=2.0, config=SQPConfig())
    print(f"cost            : {float(res.cost):.3f}")
    print(f"max violation   : {float(res.max_violation):.2e}")
    print(f"max |u|         : {float(res.us.abs().max()):.4f}  (bound 2.0)")
    print(f"max multiplier  : {float((res.lam_lo + res.lam_hi).max()):.3f}")
    print(f"final theta     : {float(res.xs[-1, 0]):.3f}  (target {np.pi:.3f})")
    return res


if __name__ == "__main__":
    main()
