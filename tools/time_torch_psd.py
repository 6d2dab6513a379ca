#!/usr/bin/env python3
"""``psd="eigh"`` through the served and the parallel compiled programs,
on one card: the parts of the coupled-cost slice that do not fit in
``chip_smoke.py``'s time limit.

    python3 tools/time_torch_psd.py

In one process, an NCCL world of one rank (parallel.mesh.ensure_world):

* the coupled cartpole (``chip_smoke.coupled``, 8192 x H=100, 10
  iterations) exported by ``utils.export.export_solver_step``, loaded and
  served (``ServedSolver``: its programs as CUDA graphs), in rounds of
  served, compiled, compiled, served beside ``solve_batched_jit`` on the
  same inputs: export s, nodes, load s, the ``sm::psd_project`` nodes of
  the iteration program, the launches its graphs recorded, solves/s; every
  served result ``solve_batched_jit``'s bits;
* ``parallel.make_sharded_train_step`` of the same system and inputs,
  compiled against its eager loop (``chip_smoke.compiled_workload``: bits,
  build s, the launches and collectives a replay), its costs and controls
  the unsharded solve's bits;
* ``sqp_mpc.scenario_mpc_solve`` of the coupled quadrotor (1024 x H=50, 3
  iterations), compiled against its eager loop (its consensus step
  projects no Hessian, in the port as in the JAX package).

Then ``graphs.release()`` and ``destroy_process_group``.  Prints one JSON
line with the card's name and power limit (``nvidia-smi``); exits non-zero
if a check fails or no card is visible.  ``run(..., small=True)`` runs it
at a tiny size (8 x H=6, 2 iterations; 4 scenarios).  To rehearse it on
the CPU, install tests/torch_standin.py's ``patches()`` and no-ops for
``torch.cuda.synchronize``, ``set_sync_debug_mode`` and
``memory_reserved``, set ``sm.configure(device="cpu")`` and call
``run(torch.device("cpu"), "cpu", small=True)``.
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    import torch

    if not torch.cuda.is_available():
        print("time_torch_psd: no CUDA device is visible", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    print(json.dumps(run(torch.device("cuda"), card)))
    return 0


def run(dev, card, small=False):
    """The three workloads on ``dev``; returns their figures."""
    import torch

    import simplemath_tpu_torch as sm
    from simplemath_tpu_torch import parallel
    from simplemath_tpu_torch.models import (
        ILQRConfig, ilqr, make_cartpole, make_quadrotor, sqp_mpc,
    )
    from simplemath_tpu_torch.parallel import sharded
    from simplemath_tpu_torch.utils import export, graphs

    assert "jax" not in sys.modules
    sm.configure(device=dev.type)
    (batch, horizon), iters = ((8, 6), 2) if small else (cs.CARTPOLE, cs.SOLVE_ITERS)
    scenarios, quad_h, mpc_iters = (4, 6, 2) if small else cs.SCENARIO_MPC
    rounds = 1 if small else 3
    rng = np.random.default_rng(cs.SEED + 16)
    out = {"card": card, "torch": torch.__version__}

    system = cs.coupled(make_cartpole())
    cfg = ILQRConfig(iterations=iters)
    x0 = torch.from_numpy((0.2 * rng.standard_normal((batch, 4))).astype(np.float32)).to(dev)
    us = torch.zeros((batch, horizon, 1), device=dev)

    # The served solve.
    t0 = time.perf_counter()
    blob = export.export_solver_step(system, cfg, batch, horizon)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    step = export.load_step(blob)
    load_s = time.perf_counter() - t0
    psd_nodes = sum(str(n.target).startswith("sm.psd_project")
                    for m in step.iteration.modules() if isinstance(m, torch.fx.GraphModule)
                    for n in m.graph.nodes if n.op == "call_function")
    cs.check(psd_nodes == 2, f"the served iteration holds {psd_nodes} sm::psd_project nodes, not 2")
    programs = (export._SERVED_INIT, export._SERVED_ITERATIONS)
    before = {id(e): e for p in programs for e in p.cached()}
    first_s, first = cs.wall_s(lambda: step(x0, us))
    built = cs._new_entries(programs, before)
    stats = cs._graph_stats(built)
    _, ref = cs.wall_s(lambda: ilqr.solve_batched_jit(system, x0, us, cfg))
    served_s, jit_s, same = [], [], cs._same_bits(first, (ref.us, ref.cost))
    for _ in range(rounds):
        for mode in ("served", "compiled", "compiled", "served"):
            if mode == "served":
                t, res = cs.wall_s(lambda: step(x0, us),
                                   sync_debug="error" if dev.type == "cuda" else None)
                served_s.append(t)
                same = same and cs._same_bits(res, first)
            else:
                jit_s.append(cs.wall_s(lambda: ilqr.solve_batched_jit(system, x0, us, cfg))[0])
    cs.check(same, "served coupled cartpole: not solve_batched_jit's bits")
    if dev.type == "cuda":
        cs.check(stats["launches"].get("psd_project", 0) == 2,
                 f"the served coupled cartpole's graphs hold {stats['launches']}")
    out["served"] = {
        "batch": batch, "horizon": horizon, "iterations": iters, "export_s": export_s,
        "nodes": step.nodes, "psd_project_nodes": psd_nodes, "MB": len(blob) / 1e6,
        "load_s": load_s, "first_call_s": first_s, "launches": stats["launches"],
        "served_s": served_s, "compiled_s": jit_s, "bits_equal": same,
        "served_solves_per_s": batch / statistics.median(served_s),
        "compiled_solves_per_s": batch / statistics.median(jit_s)}
    cs.log(f"served coupled cartpole on {card}: {json.dumps(out['served'])}")
    del step, blob, built

    # The sharded train step, in a world of one rank; a system of its own,
    # so that its block solve builds its own graphs.
    mesh = parallel.make_mesh()
    train = parallel.make_sharded_train_step(cs.coupled(make_cartpole()), mesh, cfg, "scenario")

    def train_eager():
        with graphs.eager():
            return train(x0, us)

    row, (r, _) = cs.compiled_workload(
        "sharded coupled cartpole", card,
        (ilqr._BATCHED_INIT, ilqr._BATCHED_ITERATIONS, sharded._STATS_AND_GATHERS),
        train_eager, lambda: train(x0, us), lambda t: batch / t, 1,
        profiled=ilqr._BATCHED_ITERATIONS)
    unsharded = cs._same_bits((r.cost, r.us), (ref.cost, ref.us))
    cs.check(unsharded, "the sharded coupled cartpole differs from the unsharded solve")
    if dev.type == "cuda":
        cs.check(row["launches"].get("psd_project") == 2,
                 f"the sharded step's graphs hold {row['launches']}")
    row.update({"batch": batch, "horizon": horizon, "iterations": iters,
                "unsharded_bits_equal": unsharded, "rate": "solves/s"})
    out["sharded"] = row

    # The scenario-consensus step of the coupled quadrotor.
    quad = cs.coupled(make_quadrotor())
    qx0 = torch.from_numpy((0.1 * rng.standard_normal((scenarios, 12))).astype(np.float32)).to(dev)
    qus = torch.zeros((scenarios, quad_h, 4), device=dev)

    def solve():
        return sqp_mpc.scenario_mpc_solve(quad, qx0, qus, mesh, iterations=mpc_iters)

    def solve_eager():
        with graphs.eager():
            return solve()

    row, (_, _, history) = cs.compiled_workload(
        "scenario MPC, coupled quadrotor", card, (sqp_mpc._SCENARIO_STEP,), solve_eager, solve,
        lambda t: 1e3 * t / mpc_iters, 1, checked=lambda: cs.wall_s(solve))
    cs.check(np.isfinite(history).all() and all(b <= a for a, b in zip(history, history[1:])),
             f"coupled scenario MPC: a total cost rose: {history}")
    row.update({"scenarios": scenarios, "horizon": quad_h, "iterations": mpc_iters,
                "history": history, "rate": "ms a consensus step"})
    out["scenario_mpc"] = row
    out["released_graphs"] = graphs.release()
    torch.distributed.destroy_process_group()
    return out


if __name__ == "__main__":
    sys.exit(main())
