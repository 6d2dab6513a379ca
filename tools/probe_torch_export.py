#!/usr/bin/env python3
"""Time the export of the cartpole solve step at full width on a card.

    python3 tools/probe_torch_export.py [--iters N]

Traces ``models.ilqr.solve_batched`` of the cartpole at 8192 x H=100 with
``make_fx`` on real card tensors, removes dead code, exports the graph
with ``torch.export``, saves and loads it (``utils.export``), serves it on
seeded inputs beside the live solve, and prints one JSON line: seconds of
each stage, the graph's nodes before and after dead-code elimination, the
artifact's MB, the served and live wall times, and whether the served step
gave the live solve's bits.  Prints the card's name and power limit first.
Imports no jax.
"""

import io
import json
import pathlib
import subprocess
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from simplemath_tpu_torch.models import ILQRConfig, make_cartpole  # noqa: E402
from simplemath_tpu_torch.models.ilqr import solve_batched  # noqa: E402
from simplemath_tpu_torch.utils import export  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("probe_torch_export: no CUDA device is visible", file=sys.stderr)
        return 1
    from torch.fx.experimental.proxy_tensor import make_fx

    iters = int(sys.argv[sys.argv.index("--iters") + 1]) if "--iters" in sys.argv else 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(sys.version, torch.__version__, torch.version.cuda)
    system, cfg = make_cartpole(), ILQRConfig(iterations=iters)

    def step(x0s, us):
        r = solve_batched(system, x0s, us, cfg)
        return r.us, r.cost

    x0 = torch.zeros(8192, 4, device="cuda")
    u0 = torch.zeros(8192, 100, 1, device="cuda")
    t0 = time.perf_counter()
    gm = make_fx(step, tracing_mode="real")(x0, u0)
    t1 = time.perf_counter()
    n0 = len(gm.graph.nodes)
    gm.graph.eliminate_dead_code()
    gm.recompile()
    n1 = len(gm.graph.nodes)
    t2 = time.perf_counter()
    ep = torch.export.export(export._Traced(gm), (x0, u0), strict=False)
    t3 = time.perf_counter()
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    t4 = time.perf_counter()
    served = export.load_step(buf.getvalue())
    t5 = time.perf_counter()
    g = torch.Generator().manual_seed(0)
    xs = (0.2 * torch.randn(8192, 4, generator=g)).cuda()
    us = torch.zeros(8192, 100, 1, device="cuda")

    def wall(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t, out

    first_s, _ = wall(lambda: served(xs, us))
    served_s, out = wall(lambda: served(xs, us))
    solve_batched(system, xs, us, cfg)
    live_s, ref = wall(lambda: solve_batched(system, xs, us, cfg))
    print(json.dumps({
        "iters": iters, "make_fx_s": t1 - t0, "nodes": n0, "nodes_dce": n1, "export_s": t3 - t2,
        "ep_nodes": len(ep.graph.nodes), "save_s": t4 - t3, "MB": len(buf.getvalue()) / 1e6,
        "load_s": t5 - t4, "served_first_s": first_s, "served_s": served_s, "live_s": live_s,
        "us_equal": torch.equal(out[0], ref.us), "cost_equal": torch.equal(out[1], ref.cost)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
