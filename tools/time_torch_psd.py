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

    python3 tools/time_torch_psd.py --kernel [--root DIR] [-D... nvcc flags]

times the projection's kernel alone at ``chip_smoke.PSD_SHAPES`` (random
symmetric float32 matrices from the seed): this tree's
PSD units and, with ``--root``, DIR's (another checkout, for
example the parent commit unpacked by ``git archive`` into a directory that
``.gitignore`` lists), each compiled alone with the package's nvcc flags
into its own library under ``build/psd_kernel/``, all started together,
with any extra nvcc flags given (``-DPSD_NREG_F32=11`` builds the thread path
up to n = 11: ptxas' report of it is how ``N_REG`` was chosen).
Both are held to ``psd_project_plain``'s bits on the same inputs, then
timed by CUDA events (``chip_smoke.time_ms``) in turns, this, DIR, DIR,
this, three rounds, each launch through the library's
``sm_psd_project_launch`` on the same tensors.  Prints one JSON line: the
card's name and power limit, ptxas' registers, stack and spill bytes of
every kernel of each library, and for each shape the path this tree takes
(``linalg_small.path``), the median ms of each, DIR's over this tree's, the
bound (``chip_smoke.psd_ops``) and each share of it, and the Jacobi sweeps
that the data took; then the same for the coupled cartpole's and
quadrotor's own joint blocks (``solver_blocks``).
"""

import json
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main(args):
    import torch

    if not torch.cuda.is_available():
        print("time_torch_psd: no CUDA device is visible", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    if "--kernel" in args:
        root = args[args.index("--root") + 1] if "--root" in args else None
        flags = [a for a in args if a.startswith("-D")]
        print(json.dumps(kernel(torch.device("cuda"), card, root, flags)))
    else:
        print(json.dumps(run(torch.device("cuda"), card)))
    return 0


def _kernel_name(mangled):
    """A psd kernel's mangled name, readable: its path, type and n."""
    m = re.search(r"psd_(thread|block|project)_kernelI([fd])(?:Li(\d+)E)?", mangled)
    if not m:
        return None
    path = {"project": "team"}.get(m.group(1), m.group(1))
    return f"{path} {'f32' if m.group(2) == 'f' else 'f64'}" + (f" n={m.group(3)}" if m.group(3) else "")


def build_alone(trees, flags=()):
    """Each tree's PSD units compiled alone (one ``nvcc -c`` a unit, a
    tree's all started together: ``_build.units`` where the tree builds the
    thread path an instantiation a unit, else its ``csrc/psd_project*.cu``)
    and linked into a shared library, with the package's nvcc flags and
    ``flags``: {tag: (ctypes library, ptxas report)}."""
    import ctypes

    from simplemath_tpu_torch import _build

    out_dir = pathlib.Path(ROOT) / "build" / "psd_kernel"
    out_dir.mkdir(parents=True, exist_ok=True)
    all_flags = (*_build.NVCC_FLAGS, *flags)
    procs = {}
    for tag, tree in trees.items():
        csrc = pathlib.Path(tree) / "simplemath_tpu_torch" / "csrc"
        if (csrc / _build.PER_INSTANTIATION).exists():
            todo = [(f"{tag}_{name}", src, defines) for name, src, defines in _build.units(all_flags)
                    if src.startswith("psd_")]
        else:
            todo = [(f"{tag}_{src.stem}", src.name, ()) for src in sorted(csrc.glob("psd_project*.cu"))]
        procs[tag] = [(out_dir / f"{name}.o", (out, rc))
                      for (name, _, _), (_, out, rc, _) in
                      zip(todo, _build.compile_units(todo, out_dir, all_flags, csrc))]
    built = {}
    for tag, compiles in procs.items():
        text = ""
        for _, (out, rc) in compiles:
            text += out
            cs.check(rc == 0, f"nvcc failed on {trees[tag]}:\n{text[-4000:]}")
        so = out_dir / f"{tag}.so"
        link = subprocess.run([_build.nvcc(), "-shared", *_build.NVCC_FLAGS[:2], "-o", str(so),
                               *(str(obj) for obj, _ in compiles)], capture_output=True, text=True)
        cs.check(link.returncode == 0, f"nvcc failed to link {trees[tag]}:\n{link.stderr[-4000:]}")
        lib = ctypes.CDLL(str(so))
        lib.sm_psd_project_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                              ctypes.c_int, ctypes.c_int, ctypes.c_double,
                                              ctypes.c_void_p]
        lib.sm_psd_project_launch.restype = ctypes.c_int
        report = {_kernel_name(k): v for k, v in _build.ptxas(text).items() if _kernel_name(k)}
        built[tag] = lib, report
    return built


def solver_blocks(dev, rng):
    """The coupled systems' own joint Hessian blocks at their initial
    trajectories (``chip_smoke._joint_blocks``): the cartpole's at
    ``chip_smoke.CARTPOLE`` and the quadrotor's at two states of H =
    ``chip_smoke.QUAD_H``, zero controls."""
    import torch

    from simplemath_tpu_torch.models import make_cartpole, make_quadrotor

    batch, horizon = cs.CARTPOLE
    x0 = torch.from_numpy((0.2 * rng.standard_normal((batch, 4))).astype(np.float32)).to(dev)
    xq = torch.from_numpy((0.1 * rng.standard_normal((2, 12))).astype(np.float32)).to(dev)
    return {
        "cartpole_joint_blocks": cs._joint_blocks(cs.coupled(make_cartpole()), x0,
                                                  torch.zeros((batch, horizon, 1), device=dev)),
        "quadrotor_joint_blocks": cs._joint_blocks(cs.coupled(make_quadrotor()), xq,
                                                   torch.zeros((2, cs.QUAD_H, 4), device=dev)),
    }


def kernel(dev, card, root=None, flags=()):
    """``--kernel``: the projection's kernel alone, this tree's against
    ``root``'s, in turns on the same inputs: random symmetric matrices at
    ``chip_smoke.PSD_SHAPES``, then the solvers' own joint blocks
    (``solver_blocks``)."""
    import ctypes

    import torch

    from simplemath_tpu_torch.ops import linalg_small

    trees = {"this": ROOT, **({"root": os.path.abspath(root)} if root else {})}
    t0 = time.perf_counter()
    built = build_alone(trees, flags)
    rng = np.random.default_rng(cs.SEED + 17)
    out = {"card": card, "torch": torch.__version__, "trees": trees, "flags": list(flags),
           "build_s": time.perf_counter() - t0,
           "ptxas": {tag: report for tag, (_, report) in built.items()}, "shapes": {}}
    # The thread path's largest float32 n in this tree's build.
    n_reg = next((int(f.split("=")[1]) for f in flags if f.startswith("-DPSD_NREG_F32=")),
                 linalg_small.N_REG[torch.float32])
    cases = {}
    for batch, n in cs.PSD_SHAPES:
        A = torch.from_numpy(rng.standard_normal((batch, n, n)).astype(np.float32)).to(dev)
        cases[f"{batch}x{n}"] = (A + A.mT) * 0.5
    for name, blk in solver_blocks(dev, rng).items():
        cases[name] = blk.reshape(-1, *blk.shape[-2:]).contiguous()
    for name, H in cases.items():
        batch, n = H.shape[0], H.shape[-1]
        want = linalg_small.psd_project_plain(H, cs.PSD_EPS)
        _, _, sweeps = linalg_small.jacobi_plain((H + H.mT) * 0.5)
        results = {tag: torch.empty_like(H) for tag in built}

        def launch(tag):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = built[tag][0].sm_psd_project_launch(H.data_ptr(), results[tag].data_ptr(), batch,
                                                     n, 0, ctypes.c_double(cs.PSD_EPS), stream)
            cs.check(rc == 0, f"{tag}'s psd kernel launch failed: cudaError {rc}")

        for tag in built:
            launch(tag)
        torch.cuda.synchronize()
        bits = {tag: torch.equal(r, want) for tag, r in results.items()}
        cs.check(all(bits.values()), f"psd {name}: not the plain version's bits: {bits}")
        times = {tag: [] for tag in built}
        order = ("this", "root", "root", "this") if root else ("this",)
        for _ in range(3):
            for tag in order:
                times[tag].append(cs.time_ms(lambda: launch(tag), n=10))
        b = cs.bound(2 * n * n * 4 * batch, cs.psd_ops(n) * batch)
        ms = {tag: statistics.median(t) for tag, t in times.items()}
        row = {"batch": batch, "n": n, "path": "thread" if n <= n_reg else "block",
               "sweeps_mean": float(sweeps.double().mean()), "sweeps_max": int(sweeps.max()),
               "bits_equal": bits, "ms": ms, "all_ms": times, "bound_ms": b[0], "bound_by": b[1],
               "share_of_bound": {tag: b[0] / t for tag, t in ms.items()}}
        if root:
            row["root_over_this"] = ms["root"] / ms["this"]
        out["shapes"][name] = row
        cs.log(f"psd kernel {name} on {card}: {json.dumps(row)}")
    return out


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
    sys.exit(main(sys.argv[1:]))
