#!/usr/bin/env python3
"""Export and serve the batched iLQR solve on a card, beside the compiled solve.

    python3 tools/probe_torch_export.py [CASE ...]

A CASE is ``system:batch:horizon:iterations`` with ``system`` one of
``cartpole`` and ``sm_pendulum``; by default a small cartpole (64 x H=20, 3
iterations), the cartpole at BASELINE config 3's width (8192 x H=100, 10
iterations) and the ``sm``-written pendulum (4096 x H=50, 10 iterations).
For each case: ``utils.export.export_solver_step`` (the initial rollout and
one iteration as two programs whose horizon loops are ``scan`` nodes), the
blob's MB and each program's nodes, ``load_step``, the served step's first
call (warm-up, capture, instantiate) and then three rounds of served,
compiled (``solve_batched_jit``), compiled, served on seeded inputs, every
served call after the first under CUDA sync debug mode "error"; whether the
served results have ``solve_batched_jit``'s bits.  A case that fails prints
its traceback and the next runs.  Prints the card's name and power limit,
the Python, torch and CUDA versions, then one JSON line a case.  Exits 1 if
a case failed or no card is visible.  Imports no jax.
"""

import json
import pathlib
import statistics
import subprocess
import sys
import time
import traceback

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from simplemath_tpu_torch.models import (  # noqa: E402
    ILQRConfig, make_cartpole, make_sm_pendulum, solve_batched_jit,
)
from simplemath_tpu_torch.ops import elementwise  # noqa: E402
from simplemath_tpu_torch.utils import export  # noqa: E402

SYSTEMS = {"cartpole": make_cartpole, "sm_pendulum": make_sm_pendulum}
CASES = ("cartpole:64:20:3", "cartpole:8192:100:10", "sm_pendulum:4096:50:10")


def wall(fn, sync_debug=None):
    torch.cuda.synchronize()
    t = time.perf_counter()
    if sync_debug:
        torch.cuda.set_sync_debug_mode(sync_debug)
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return time.perf_counter() - t, out


def case(name, batch, horizon, iters):
    system, cfg = SYSTEMS[name](), ILQRConfig(iterations=iters)
    t0 = time.perf_counter()
    blob = export.export_solver_step(system, cfg, batch, horizon)
    t1 = time.perf_counter()
    step = export.load_step(blob)
    t2 = time.perf_counter()
    g = torch.Generator().manual_seed(0)
    x0 = (0.2 * torch.randn(batch, system.nx, generator=g)).cuda()
    us = torch.zeros(batch, horizon, system.nu, device="cuda")
    elementwise.reset_launches()
    first_s, first = wall(lambda: step(x0, us))
    launches = {k: v for k, v in elementwise.LAUNCHES.items() if v}
    solve_batched_jit(system, x0, us, cfg)  # the compiled solve's own first call
    served_s, jit_s, same = [], [], True
    for _ in range(3):
        for mode in ("served", "jit", "jit", "served"):
            if mode == "served":
                t, out = wall(lambda: step(x0, us), sync_debug="error")
                served_s.append(t)
                same = same and torch.equal(out[0], first[0]) and torch.equal(out[1], first[1])
            else:
                t, ref = wall(lambda: solve_batched_jit(system, x0, us, cfg))
                jit_s.append(t)
    served, jit = statistics.median(served_s), statistics.median(jit_s)
    return {
        "case": f"{name}:{batch}:{horizon}:{iters}", "export_s": t1 - t0, "load_s": t2 - t1,
        "MB": len(blob) / 1e6, "nodes": step.nodes, "first_call_s": first_s,
        "launches_first_call": launches, "served_s": served_s, "jit_s": jit_s,
        "served_solves_per_s": batch / served, "jit_solves_per_s": batch / jit,
        "bits_equal": bool(same and torch.equal(first[0], ref.us) and torch.equal(first[1], ref.cost)),
    }


def main(argv):
    if not torch.cuda.is_available():
        print("probe_torch_export: no CUDA device is visible", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    failed = 0
    for spec in argv or CASES:
        name, *sizes = spec.split(":")
        try:
            print(json.dumps(case(name, *map(int, sizes))), flush=True)
        except Exception:
            failed += 1
            print(f"{spec} failed:\n{traceback.format_exc()}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
