#!/usr/bin/env python3
"""The port's parallel layer over several cards: collectives, the sharded
cartpole solve and the scaling reports, one process a card.

    python3 tools/time_torch_parallel.py [--ranks N] [--backend nccl|gloo] [--device cuda|cpu]

Starts N ranks (default: one a visible card, NCCL), each on its own card.
They check every collective of ``simplemath_tpu_torch.parallel`` over NCCL
against the values it must give, solve the cartpole (8192 x H=100, 10
iterations) sharded over all ranks and hold it, on rank 0, against the
unsharded solve of the same inputs on one card (bit for bit, and the psum
total against their sum), then run ``weak_scaling_report`` (2048 scenarios
a rank, H=100, 3 iterations, over 1, 2, 4, ... ranks) and
``sharding_overhead_report`` (8192 scenarios).  Prints one JSON object
with the card's name and power limit; exits non-zero if a check fails.
``--device cpu --backend gloo`` runs the same on the CPU.
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
    from simplemath_tpu_torch.models import ILQRConfig, make_cartpole, solve_batched
    from simplemath_tpu_torch.parallel.mesh import PartitionSpec as P
    from simplemath_tpu_torch.parallel.scaling import sharding_overhead_report, weak_scaling_report

    assert "jax" not in sys.modules
    sm.configure(device=device)
    dev = torch.device(device, torch.cuda.current_device()) if device == "cuda" else torch.device("cpu")
    res = {"rank": rank, "world": world, "backend": backend}
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
    dist.barrier()
    counts = tuple(n for n in (1, 2, 4, 8) if n <= world)
    res["weak_scaling"] = weak_scaling_report(per_device_batch=2048, horizon=HORIZON,
                                              iterations=3, device_counts=counts)
    res["overhead"] = sharding_overhead_report(total_batch=BATCH, horizon=HORIZON, iterations=3)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()
    ok = all(checks.values()) and (rank != 0 or (res["equal_costs"] and res["equal_controls"]
                                                 and res["psum_ok"]))
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
        rcs = []
        try:
            for p in procs:
                rcs.append(p.wait(timeout=1200))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(rcs) or not os.path.exists(out):
            for r, log in enumerate(logs):
                log.seek(0)
                print(f"rank {r} exited {rcs[r] if r < len(rcs) else None}:\n{log.read()[-3000:]}",
                      file=sys.stderr)
            return 1
        with open(out) as f:
            res = json.load(f)
    res["card"] = card
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
