#!/usr/bin/env python3
"""Export and serve the port's solvers on a card, beside their compiled or
eager calls.

    python3 tools/probe_torch_export.py [CASE ...]

A CASE is ``system:batch:horizon:iterations`` with ``system`` one of
``cartpole`` and ``sm_pendulum``: the batched iLQR solve served by
``utils.export.export_solver_step`` (the initial rollout and one iteration
as two programs whose horizon loops are ``scan`` nodes) beside
``solve_batched_jit``.  Or it is one of the whole solvers exported as one
program by ``export_step``, its iteration, SQP, tick and horizon loops
nested ``scan`` nodes:

* ``constrained:H:SQP:ILQR``: ``solve_constrained`` of the quadrotor (a box
  on the controls), beside its eager call;
* ``replan_coupled:H:ITERS``: ``MPCController.plan`` of the coupled
  quadrotor (``psd="eigh"``, tests/test_torch_psd.py), beside its compiled
  call;
* ``closed_loop:H:TICKS``: ``closed_loop`` of the cartpole, beside its
  compiled call;
* ``rti:H:TICKS``: ``rti_closed_loop`` of the quadrotor, beside its
  compiled call;
* ``sm_pendulum_solve:B:H:ITERS``: the whole ``solve_batched`` of the
  ``sm``-written pendulum (``chip_smoke.py`` phase 10's nested program),
  beside its eager call.

By default a small cartpole (64 x H=20, 3 iterations), the cartpole at
BASELINE config 3's width (8192 x H=100, 10 iterations), the
``sm``-written pendulum (4096 x H=50, 10 iterations), then
``constrained:50:2:2`` and ``constrained:50:8:8`` (BASELINE config 4 at two
depths, the second ``SQPConfig()``'s: one program, the same nodes),
``replan_coupled:50:2``, ``closed_loop:50:20`` and ``rti:50:20``.  For each
case: export s, the blob's MB, the nodes of each program (every level),
load s, the loaded step's first call (for a served solve: warm-up,
capture, instantiate) and the kernel launches it counted, then rounds of
loaded, reference, reference, loaded on seeded inputs (three of a served
solve, one of a whole solver), every loaded call after the first under
CUDA sync debug mode "error"; whether the loaded results have the
reference's bits (and a whole solver's, its eager call's).  A case that
fails prints its traceback and the next runs.  Prints the card's name and
power limit, the Python, torch and CUDA versions, then one JSON line a
case.  Exits 1 if a case failed or no card is visible.  Imports no jax.
"""

import dataclasses
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
    ILQRConfig, MPCController, closed_loop, make_cartpole, make_quadrotor, make_sm_pendulum,
    rti, solve_batched_jit,
)
from simplemath_tpu_torch.models import ilqr  # noqa: E402
from simplemath_tpu_torch.models.sqp_mpc import SQPConfig, solve_constrained  # noqa: E402
from simplemath_tpu_torch.ops import elementwise, linalg_small  # noqa: E402
from simplemath_tpu_torch.utils import export, graphs  # noqa: E402

SYSTEMS = {"cartpole": make_cartpole, "sm_pendulum": make_sm_pendulum}
CASES = ("cartpole:64:20:3", "cartpole:8192:100:10", "sm_pendulum:4096:50:10",
         "constrained:50:2:2", "constrained:50:8:8", "replan_coupled:50:2", "closed_loop:50:20",
         "rti:50:20")
BOX = ([-5.0, -1.0, -1.0, -1.0], [5.0, 1.0, 1.0, 1.0])  # examples/torch_mpc_quadrotor.py


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


def coupled_quadrotor():
    """The quadrotor with tests/test_torch_psd.py's cross and concave
    terms: a coupled cost, so ``psd="auto"`` projects with ``psd_project``."""
    base = make_quadrotor()

    def stage_cost(x, u):
        return base.stage_cost(x, u) + 0.05 * x[9] * u[1] - 0.049 * x[9] ** 2

    return dataclasses.replace(base, name="quadrotor_coupled", stage_cost=stage_cost,
                               separable_cost=False)


def whole(name, *sizes):
    """(function, arguments, reference or None): a whole solver of the
    docstring's list at ``sizes``; the reference is its compiled call."""
    g = torch.Generator().manual_seed(1)
    x12 = (0.1 * torch.randn(12, generator=g)).cuda()
    if name == "constrained":
        h, sqp, inner = sizes
        quad, cfg = make_quadrotor(), SQPConfig(sqp_iterations=sqp, ilqr_iterations=inner)
        lo, hi = (torch.tensor(b, device="cuda") for b in BOX)
        return (lambda x, u, lo, hi: tuple(solve_constrained(quad, x, u, lo, hi, cfg))[:4],
                (x12, torch.zeros(h, 4, device="cuda"), lo, hi), None)
    if name == "replan_coupled":
        h, iters = sizes
        ctrl = MPCController(coupled_quadrotor(), h, *BOX, replan_iters=iters)
        return ctrl.plan, (x12, torch.zeros(h, 4, device="cuda")), ctrl.plan
    if name == "closed_loop":
        h, ticks = sizes
        cart = make_cartpole()

        def fn(x):
            return tuple(closed_loop(cart, x, h, ticks))

        return fn, (torch.tensor([0.0, 0.0, 0.3, 0.0], device="cuda"),), fn
    if name == "rti":
        h, ticks = sizes
        quad = make_quadrotor()

        def fn(x):
            return tuple(rti.rti_closed_loop(quad, x, h, ticks))

        return fn, (x12,), fn
    if name == "sm_pendulum_solve":
        b, h, iters = sizes
        pendulum, cfg = make_sm_pendulum(), ILQRConfig(iterations=iters)
        x0 = (0.2 * torch.randn(b, 2, generator=g)).cuda()
        return (lambda x, u: tuple(ilqr.solve_batched(pendulum, x, u, cfg)[:3]),
                (x0, torch.zeros(b, h, 1, device="cuda")), None)
    raise ValueError(f"unknown case {name}")


def equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def whole_case(name, *sizes):
    fn, args, reference = whole(name, *sizes)
    with graphs.eager():
        want = fn(*args)  # the eager call, the first of the process for this function
    t0 = time.perf_counter()
    blob = export.export_step(fn, *args)
    t1 = time.perf_counter()
    run = export.load_step(blob)
    t2 = time.perf_counter()
    for c in (elementwise, linalg_small):
        c.reset_launches()
    first_s, first = wall(lambda: run(*args))
    launches = {k: v for c in (elementwise, linalg_small) for k, v in c.LAUNCHES.items() if v}
    kind = "compiled" if reference else "eager"
    reference = reference or fn
    reference(*args)  # its own first call
    loaded_s, ref_s, ok = [], [], equal(first, want)
    for mode in ("loaded", "reference", "reference", "loaded"):
        if mode == "loaded":
            t, out = wall(lambda: run(*args), sync_debug="error")
            loaded_s.append(t)
            ok = ok and equal(out, first)
        else:
            t, ref = wall(lambda: reference(*args))
            ref_s.append(t)
            ok = ok and equal(ref, want)
    return {
        "case": ":".join(map(str, (name, *sizes))), "export_s": t1 - t0, "load_s": t2 - t1,
        "MB": len(blob) / 1e6, "nodes": export.program_nodes(run), "first_call_s": first_s,
        "launches_first_call": launches, "loaded_s": loaded_s,
        "reference": kind,
        "reference_s": ref_s, "bits_equal": bool(ok),
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
            run = case if name in SYSTEMS else whole_case
            print(json.dumps(run(name, *map(int, sizes))), flush=True)
        except Exception:
            failed += 1
            print(f"{spec} failed:\n{traceback.format_exc()}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
