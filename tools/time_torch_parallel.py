#!/usr/bin/env python3
"""The port's parallel layer over several cards: collectives, the sharded
cartpole solve and the scaling reports, one process a card.

    python3 tools/time_torch_parallel.py [--ranks N] [--backend nccl|gloo] [--device cuda|cpu]
                                         [--timeout SECONDS]

Starts N ranks (default: one a visible card, NCCL), each on its own card.
They check every collective of ``simplemath_tpu_torch.parallel`` over NCCL
against the values it must give, solve the cartpole (8192 x H=100, 10
iterations) sharded over all ranks and hold it, on rank 0, against the
unsharded solve of the same inputs on one card (bit for bit, and the psum
total against their sum), run the same solve through the compiled train step
(``make_sharded_train_step``: CUDA graphs that hold the NCCL collectives;
the eager sharded solve's bits, its first call and later ones timed beside
the compiled solve of the rank's block alone), then
run ``weak_scaling_report`` (2048 scenarios a rank, H=100, 3 iterations,
over 1, 2, 4, ... ranks) and ``sharding_overhead_report`` (8192
scenarios), each twice: first inside ``graphs.eager()`` (the eager loops),
then compiled (the train step and ``solve_batched_jit`` as CUDA graphs).
Each rank then frees its graphs (``utils.graphs.release()``) before
``destroy_process_group``, and rank 0 records how long that took.
Prints one JSON object with the card's name and power limit; exits non-zero
if a check fails or the ranks outlast ``--timeout`` (default 1200 s), and
then prints what rank 0 had finished, marked ``"partial": true``, and the end
of every rank's log, where each rank notes the stages it has passed.  ``--device cpu --backend gloo`` runs the same on the CPU
(where the compiled programs run eagerly).
"""

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, HORIZON, ITERS = 8192, 100, 10


def rank_main(rank, world, port, backend, device, out):
    import torch
    import torch.distributed as dist

    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    sys.path.insert(0, ROOT)
    import simplemath_tpu_torch as sm
    from simplemath_tpu_torch import parallel
    from simplemath_tpu_torch.models import ILQRConfig, make_cartpole, solve_batched, solve_batched_jit
    from simplemath_tpu_torch.parallel.mesh import PartitionSpec as P
    from simplemath_tpu_torch.parallel.scaling import sharding_overhead_report, weak_scaling_report
    from simplemath_tpu_torch.utils import graphs

    assert "jax" not in sys.modules
    sm.configure(device=device)
    dev = torch.device(device, torch.cuda.current_device()) if device == "cuda" else torch.device("cpu")
    res = {"rank": rank, "world": world, "backend": backend}
    t_start = time.perf_counter()

    def progress(what):
        # One line a stage in the rank's log: where a hung or slow run was.
        print(f"rank {rank} {time.perf_counter() - t_start:.1f} s: {what}", flush=True)

    progress("joined the world")
    mesh = parallel.make_mesh()

    # Collectives over the scenario axis, each against the values it must give.
    x = torch.arange(world * 4 * 3, dtype=torch.float32, device=dev).reshape(world * 4, 3)

    def fn(xb):
        return (parallel.psum(torch.sum(xb), "scenario"), parallel.pmax(torch.amax(xb), "scenario"),
                parallel.pmin(torch.amin(xb), "scenario"), parallel.all_gather(xb, "scenario"),
                parallel.ppermute_ring(xb, "scenario"), parallel.reduce_scatter(xb, "scenario"),
                parallel.axis_index("scenario").reshape(1))

    s, mx, mn, g, ring, rs, idx = parallel.shard_map(
        fn, mesh=mesh, in_specs=P("scenario"),
        out_specs=(P(), P(), P(), P("scenario"), P("scenario"), P("scenario"), P("scenario")))(x)
    blocks = x.reshape(world, 4, 3)
    checks = {
        "psum": float(s) == float(x.sum()), "pmax": float(mx) == float(x.max()),
        "pmin": float(mn) == float(x.min()),
        "all_gather": torch.equal(g, torch.cat([x] * world)),
        "ppermute_ring": torch.equal(ring, torch.roll(blocks, 1, 0).reshape(-1, 3)),
        "reduce_scatter": torch.equal(rs, blocks.sum(0)),
        "axis_index": idx.cpu().tolist() == list(range(world)),
    }
    res["collectives"] = checks
    progress("collectives checked")

    # The sharded cartpole against the unsharded solve (rank 0).
    g_ = torch.Generator().manual_seed(0)
    x0 = (0.2 * torch.randn((BATCH, 4), generator=g_)).to(dev)
    us = torch.zeros((BATCH, HORIZON, 1), device=dev)
    cartpole, cfg = make_cartpole(), ILQRConfig(iterations=ITERS)
    parallel.solve_batched_sharded(cartpole, x0, us, ILQRConfig(iterations=1), mesh)
    if device == "cuda":
        torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    r, stats = parallel.solve_batched_sharded(cartpole, x0, us, cfg, mesh)
    if device == "cuda":
        torch.cuda.synchronize()
    res["sharded_s"] = time.perf_counter() - t0
    res["sharded_solves_per_s"] = BATCH / res["sharded_s"]
    progress("eager sharded solve")
    if rank == 0:
        t0 = time.perf_counter()
        ref = solve_batched(cartpole, x0, us, cfg)
        if device == "cuda":
            torch.cuda.synchronize()
        res["unsharded_s"] = time.perf_counter() - t0
        res["unsharded_solves_per_s"] = BATCH / res["unsharded_s"]
        res["equal_costs"] = torch.equal(r.cost, ref.cost)
        res["equal_controls"] = torch.equal(r.us, ref.us)
        total, want = float(stats["total_cost"]), float(ref.cost.double().sum())
        res["psum_total"], res["unsharded_sum"] = total, want
        res["psum_ok"] = abs(total - want) <= 1e-5 * abs(want)
    counts = tuple(n for n in (1, 2, 4, 8) if n <= world)

    def reports(suffix):
        # Rank 0 writes what it has after each pass, so a fault in a later
        # (compiled) pass leaves the earlier figures readable.
        res["weak_scaling" + suffix] = weak_scaling_report(
            per_device_batch=2048, horizon=HORIZON, iterations=3, device_counts=counts)
        progress("weak_scaling" + suffix)
        res["overhead" + suffix] = sharding_overhead_report(total_batch=BATCH, horizon=HORIZON,
                                                            iterations=3)
        progress("overhead" + suffix)
        if rank == 0:
            with open(out, "w") as f:
                json.dump(res, f)

    # The eager reports first: they are what earlier measurements are held
    # against, and they must not depend on the compiled programs working.
    with graphs.eager():
        reports("_eager")
    dist.barrier()
    # The compiled train step (the first call builds its graphs), and the
    # compiled solve of this rank's block alone (the step's own graphs):
    # the difference is the step's statistics, gathers and the copies
    # between its graphs.  Medians of 3 calls.
    step = parallel.make_sharded_train_step(cartpole, mesh, cfg, "scenario")
    per = BATCH // world
    xb, ub = x0[rank * per:(rank + 1) * per], us[rank * per:(rank + 1) * per]

    def timed(fn):
        if device == "cuda":
            torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        out = fn()
        if device == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    progress("compiled train step: building")
    res["compiled_first_s"], (rc, stats_c) = timed(lambda: step(x0, us))
    progress("compiled train step: built and run")
    runs = sorted(timed(lambda: step(x0, us))[0] for _ in range(3))
    blocks = sorted(timed(lambda: solve_batched_jit(cartpole, xb, ub, cfg))[0] for _ in range(3))
    res["compiled_s"], res["compiled_block_s"] = runs[1], blocks[1]
    res["compiled_solves_per_s"] = BATCH / res["compiled_s"]
    res["compiled_equal"] = (torch.equal(rc.cost, r.cost) and torch.equal(rc.us, r.us)
                             and torch.equal(stats_c["total_cost"], stats["total_cost"]))
    reports("")
    # Free the compiled programs before the process group: their graphs
    # hold the NCCL resources of the collectives they captured.
    res["graphs_released"] = graphs.release()
    progress(f"compiled programs freed: {res['graphs_released']} graphs")
    dist.barrier()
    progress("barrier passed")
    t0 = time.perf_counter()
    dist.destroy_process_group()
    res["destroy_process_group_s"] = time.perf_counter() - t0
    progress("process group destroyed")
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    ok = all(checks.values()) and res["compiled_equal"] and (
        rank != 0 or (res["equal_costs"] and res["equal_controls"] and res["psum_ok"]))
    return 0 if ok else 1


def main(argv):
    opts = dict(zip(argv[::2], argv[1::2]))
    if "--rank" in opts:
        return rank_main(int(opts["--rank"]), int(opts["--world"]), opts["--port"],
                         opts["--backend"], opts["--device"], opts["--out"])
    import torch

    device = opts.get("--device", "cuda")
    ranks = int(opts.get("--ranks", torch.cuda.device_count() if device == "cuda" else 4))
    backend = opts.get("--backend", "nccl" if device == "cuda" else "gloo")
    card = "cpu"
    if device == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip().splitlines()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.json")
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(ranks)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r),
                                   "--world", str(ranks), "--port", str(port), "--backend", backend,
                                   "--device", device, "--out", out],
                                  stdout=log, stderr=subprocess.STDOUT) for r, log in enumerate(logs)]
        rcs, deadline = [], time.monotonic() + float(opts.get("--timeout", 1200))
        try:
            for p in procs:
                try:
                    rcs.append(p.wait(timeout=max(1.0, deadline - time.monotonic())))
                except subprocess.TimeoutExpired:
                    rcs.append(124)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        res = None
        if os.path.exists(out):
            with open(out) as f:
                res = json.load(f)
        if any(rcs) or res is None:
            for r, log in enumerate(logs):
                log.seek(0)
                print(f"rank {r} exited {rcs[r]}:\n{log.read()[-2000:]}", file=sys.stderr)
            if res is not None:
                # What rank 0 finished before the fault (the eager reports
                # come first), marked as partial.
                print(json.dumps({**res, "card": card, "partial": True}))
            return 1
    res["card"] = card
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
