#!/usr/bin/env python3
"""How far the gradient of the fused matmul root is from float64, on the
card: the port's, plain torch's, each against torch's in float64.

    python3 tools/probe_torch_matmul_grad.py [--seeds S ...]

``chip_smoke.py``'s phase 5c holds ``torch.func.grad`` of
``sum(tanh(x @ w + b) * 2 - b)`` at ``N_MM`` = 2048 (x and w standard
normal, w scaled by 2048^-0.5, b a standard normal row, all float32) to
plain torch's autograd.  For each seed (default 1000-1007, fresh draws in
phase 5c's order) this probe computes three gradients of the same
function on the same inputs: the port's (``sm.fuse``, under
``matmul.exact_float32()``), plain torch's in float32 (TF32 off), and
plain torch's in float64.  For each of dx, dw, db and each float32 side it
prints the largest error against float64, absolute, and relative to the
bound that the float32 products give: ``2e-5 * (|A| @ |B|)`` of the
backward's products (dx = g @ w^T, dw = x^T @ g, with g = 2 (1 - tanh^2)
of float64), and ``2e-5 * sum_i (|g_i| + 1)`` for db, a sum over the rows
(``PERF.md`` §2's product and sum bounds).  It also prints phase 5c's
former measure, the largest ``|port - torch| / (1 + |torch|)``.  One JSON
line a seed, then a summary line.  Imports no jax.
"""

import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def seed_row(seed, dev, sm, matmul):
    import torch

    rng = np.random.default_rng(seed)
    n = cs.N_MM
    scale = n ** -0.5
    # Phase 5c's draws, in its order (its tangent t_x is drawn and unused here).
    x, _, w = (torch.from_numpy((scale ** k * rng.standard_normal((n, n))).astype(np.float32)).to(dev)
               for k in (0, 0, 1))
    b = torch.from_numpy(rng.standard_normal((1, n)).astype(np.float32)).to(dev)
    layer = sm.fuse(lambda x, w, b: sm.tanh(x @ w + b) * 2.0 - b)

    def plain(x, w, b):
        return torch.tanh(x @ w + b) * 2.0 - b

    def grad(f, *args):
        return torch.func.grad(lambda *a: f(*a).sum(), (0, 1, 2))(*args)

    with matmul.exact_float32():
        port = grad(lambda *a: layer(*a).torch().float(), x, w, b)
        f32 = grad(plain, x, w, b)
        f64 = grad(plain, x.double(), w.double(), b.double())
    torch.cuda.synchronize()
    want, tol = cs.matmul_root_grad_bound(x, w, b)
    row = {"seed": seed}
    for name, p, t, r64, r, bound in zip(("dx", "dw", "db"), port, f32, f64, want, tol):
        cs.check(float((r64 - r).abs().max()) <= 1e-9 * float(r.abs().max()) + 1e-9,
                 f"{name}: float64 autograd and the closed form disagree")
        part = {}
        for side, v in (("port", p), ("torch", t)):
            err = (v.double() - r64).abs()
            part[side] = {"max_abs": float(err.max()), "max_over_bound": float((err / bound).max())}
        part["port_vs_torch_former_measure"] = float(
            ((p.double() - t.double()).abs() / (1.0 + t.double().abs())).max())
        row[name] = part
    return row


def main(args):
    import torch

    if not torch.cuda.is_available():
        print("probe_torch_matmul_grad: no CUDA device is visible", file=sys.stderr)
        return 1
    import simplemath_tpu_torch as sm
    from simplemath_tpu_torch.ops import matmul

    seeds = [int(s) for s in args[args.index("--seeds") + 1:]] if "--seeds" in args else \
        list(range(1000, 1008))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    rows = []
    for seed in seeds:
        rows.append(seed_row(seed, dev, sm, matmul))
        print(json.dumps({"card": card, **rows[-1]}), flush=True)
    summary = {
        f"{name}_{side}_{key}": max(r[name][side][key] for r in rows)
        for name in ("dx", "dw", "db") for side in ("port", "torch")
        for key in ("max_abs", "max_over_bound")}
    summary["former_measure_max"] = max(r[n]["port_vs_torch_former_measure"]
                                        for r in rows for n in ("dx", "dw", "db"))
    print(json.dumps({"card": card, "seeds": seeds, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
