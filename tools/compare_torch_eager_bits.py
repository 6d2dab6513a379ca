#!/usr/bin/env python3
"""Hold the port's eager solver results to another checkout's, bit for bit, on the CPU.

    python3 tools/compare_torch_eager_bits.py --root DIR

Runs the same eager solves, on the same seeded inputs, with this checkout's
``simplemath_tpu_torch`` and with the one under ``DIR`` (say, the parent
commit unpacked with ``git archive <commit> | tar -x -C DIR``), each in a
process of its own, and compares every array they return: ``solve`` (the
pendulum; the quadrotor with the associative backward pass),
``solve_batched`` (the cartpole, the ``sm`` pendulum, the coupled cartpole
with ``psd="eigh"``), ``solve_batched_jit`` (the bicycle), ``solve_constrained``
(the quadrotor with a box; the pendulum without multipliers), three
``MPCController.replan`` calls, a noisy ``closed_loop`` and
``rti_closed_loop``.  Prints the number of arrays and those whose dtype,
shape or bytes differ; exits 1 if any does.  Imports no jax.
"""

import argparse
import dataclasses
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent


def solve_all(out_path):
    """Run every solve of the docstring with the package on ``sys.path``
    and save its arrays to ``out_path``."""
    import torch

    import simplemath_tpu_torch as sm
    from simplemath_tpu_torch.models import (
        ILQRConfig, MPCController, ilqr, make_bicycle, make_cartpole, make_pendulum,
        make_quadrotor, make_sm_pendulum, rti, simulate, sqp_mpc,
    )
    from simplemath_tpu_torch.models.sqp_mpc import SQPConfig

    sm.configure(device="cpu")
    rng = np.random.default_rng(42)
    out = {}

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    def put(name, tree):
        for i, leaf in enumerate(torch.utils._pytree.tree_leaves(tree)):
            out[f"{name}_{i}"] = leaf.detach().numpy().copy()

    def coupled(base):  # tests/test_torch_psd.py::coupled, the cartpole's terms
        def stage_cost(x, u):
            return base.stage_cost(x, u) + 0.1 * x[1] * u[0] - 0.01 * x[1] ** 2

        return dataclasses.replace(base, name="cartpole_coupled", stage_cost=stage_cost,
                                   separable_cost=False)

    cart, pend, quad = make_cartpole(), make_pendulum(), make_quadrotor()
    box = (t([-5.0, -1, -1, -1]), t([5.0, 1, 1, 1]))
    put("solve_pendulum", ilqr.solve(pend, t([0.1, 0.0]), torch.zeros(20, 1), ILQRConfig(iterations=5)))
    put("solve_quadrotor_associative", ilqr.solve(
        quad, t(0.1 * rng.standard_normal(12)), torch.zeros(10, 4),
        ILQRConfig(iterations=3, backward="associative")))
    put("solve_batched_cartpole", ilqr.solve_batched(
        cart, t(0.2 * rng.standard_normal((16, 4))), torch.zeros(16, 12, 1), ILQRConfig(iterations=4)))
    put("solve_batched_sm_pendulum", ilqr.solve_batched(
        make_sm_pendulum(), t(0.2 * rng.standard_normal((8, 2))), torch.zeros(8, 10, 1),
        ILQRConfig(iterations=3)))
    put("solve_batched_coupled", ilqr.solve_batched(
        coupled(cart), t(0.2 * rng.standard_normal((8, 4))), torch.zeros(8, 10, 1),
        ILQRConfig(iterations=3, psd="eigh")))
    put("solve_batched_jit_bicycle", ilqr.solve_batched_jit(
        make_bicycle(), t(0.2 * rng.standard_normal((4, 4))), torch.zeros(4, 10, 2),
        ILQRConfig(iterations=2)))
    put("constrained_quadrotor", sqp_mpc.solve_constrained(
        quad, t(0.1 * rng.standard_normal(12)), torch.zeros(10, 4), *box,
        SQPConfig(sqp_iterations=3, ilqr_iterations=2)))
    put("constrained_pendulum_penalty", sqp_mpc.solve_constrained(
        pend, t([0.1, 0.0]), torch.zeros(20, 1), -2.0, 2.0,
        SQPConfig(sqp_iterations=3, ilqr_iterations=3, use_multipliers=False)))
    ctrl = MPCController(quad, 10, u_min=box[0], u_max=box[1])
    x = t(0.1 * rng.standard_normal(12))
    for i in range(3):
        put(f"replan{i}", ctrl.replan(x))
    put("closed_loop", simulate.closed_loop(pend, t([0.1, 0.0]), 10, 4, noise_std=0.01))
    put("rti_closed_loop", rti.rti_closed_loop(quad, t(0.1 * rng.standard_normal(12)), 10, 4))
    np.savez(out_path, **out)


def run(root, out_path):
    env = dict(os.environ, PYTHONPATH=str(root), SM_DEVICE="cpu")
    code = (f"import sys; sys.path.insert(0, {str(ROOT / 'tools')!r}); "
            f"import compare_torch_eager_bits as c; c.solve_all({str(out_path)!r})")
    # From the checkout's root: ``-c`` puts the working directory first on the path.
    subprocess.run([sys.executable, "-c", code], env=env, cwd=root, check=True)


def main(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", required=True, help="the other checkout's root")
    args = parser.parse_args(argv)
    with tempfile.TemporaryDirectory() as d:
        mine, theirs = pathlib.Path(d, "this.npz"), pathlib.Path(d, "other.npz")
        run(ROOT, mine)
        run(pathlib.Path(args.root).resolve(), theirs)
        a, b = np.load(mine), np.load(theirs)
        names = sorted(set(a.files) | set(b.files))
        differ = [k for k in names if k not in a.files or k not in b.files
                  or a[k].dtype != b[k].dtype or a[k].shape != b[k].shape
                  or a[k].tobytes() != b[k].tobytes()]
    print(f"{len(names)} arrays; differing: {differ}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
