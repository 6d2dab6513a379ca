#!/usr/bin/env python3
"""First contact of the compiled entry points (utils/graphs.py) with a card.

    python3 tools/probe_torch_graphs.py

Builds the kernel library, then captures and replays each compiled entry
point beside its eager counterpart on the same inputs and prints, case by
case, the eager and compiled wall seconds (the first compiled call builds
its graphs, the second is replays alone, under sync debug mode "error"),
whether every output has the eager bits (and the largest difference), and
each graph's stats (warm-up, capture and instantiation seconds, pool MB,
the kernel launches recorded at capture): ``solve_batched_jit`` of the
cartpole (64 x H=20, 3 iterations) and the ``sm``-written pendulum (256 x
H=20, 2), ``MPCController.replan`` (quadrotor, H=50, three calls), a noisy
bounded pendulum ``closed_loop`` (H=20, 10 ticks), ``rti_closed_loop``
(quadrotor, H=50, 20 and 60 ticks), a replay with TF32 turned on,
``psd="eigh"`` under capture (must raise ``CaptureError``), then the
cartpole at 8192 x H=100 and the ``sm`` pendulum at 4096 x H=50, 10
iterations each.  A case that fails prints its traceback and the next
runs.  Prints the card's name and power limit first.  Imports no jax.
"""
import pathlib
import subprocess
import sys
import time
import traceback

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import torch

print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout, flush=True)
from simplemath_tpu_torch import _build
from simplemath_tpu_torch.utils import graphs
from simplemath_tpu_torch.models import (ILQRConfig, MPCController, closed_loop, ilqr, make_cartpole,
                                         make_pendulum, make_quadrotor, make_sm_pendulum, rti,
                                         sqp_mpc)
t0 = time.time(); _build.library(); print("build", time.time() - t0, flush=True)
dev = torch.device("cuda")
rng = np.random.default_rng(0)


def same(a, b):
    la = torch.utils._pytree.tree_leaves(a)
    lb = torch.utils._pytree.tree_leaves(b)
    return all(torch.equal(x, y) for x, y in zip(la, lb)), [float((x.double() - y.double()).abs().max()) for x, y in zip(la, lb)]


def timed(fn, mode=None):
    torch.cuda.synchronize(); t = time.perf_counter()
    if mode:
        torch.cuda.set_sync_debug_mode(mode)
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return time.perf_counter() - t, out


def case(name, fn):
    try:
        fn()
    except Exception:
        print(f"CASE {name} FAILED", flush=True)
        traceback.print_exc()
        sys.stdout.flush()


def batched(mk, B, H, iters):
    s = mk()
    x0 = torch.from_numpy((0.2 * rng.standard_normal((B, s.nx))).astype(np.float32)).to(dev)
    us = torch.zeros((B, H, s.nu), device=dev)
    c = ILQRConfig(iterations=iters)
    te, ref = timed(lambda: ilqr.solve_batched(s, x0, us, c))
    tb, got = timed(lambda: ilqr.solve_batched_jit(s, x0, us, c))
    tr, got2 = timed(lambda: ilqr.solve_batched_jit(s, x0, us, c), "error")
    te2, ref2 = timed(lambda: ilqr.solve_batched(s, x0, us, c))
    print(mk.__name__, B, H, iters, "eager", te, te2, "build", tb, "replay", tr, same(ref, got), same(ref, got2), flush=True)
    for e in ilqr._BATCHED_INIT.cached():
        print("  init", e.graph.stats)
    for e in ilqr._BATCHED_ITERATIONS.cached():
        print("  iter", e.graph.stats)
    ilqr._BATCHED_INIT.entries.clear(); ilqr._BATCHED_ITERATIONS.entries.clear()


case("cartpole small", lambda: batched(make_cartpole, 64, 20, 3))
case("sm pendulum small", lambda: batched(make_sm_pendulum, 256, 20, 2))


def replan():
    q = make_quadrotor()
    x = torch.from_numpy((0.1 * rng.standard_normal(12)).astype(np.float32)).to(dev)
    a = MPCController(q, horizon=50, replan_iters=2)
    b = MPCController(q, horizon=50, replan_iters=2)
    for i in range(3):
        t1, ra = timed(lambda: a.replan(x), "error" if i else None)
        with graphs.eager():
            t2, rb = timed(lambda: b.replan(x))
        print("replan", i, t1, t2, same(ra, rb), torch.equal(a.us_warm, b.us_warm), flush=True)
    print("  ", [e.graph.stats for e in sqp_mpc._REPLAN.cached()])


case("replan", replan)


def loops():
    p = make_pendulum()
    x0 = torch.tensor([3.0, 0.0], device=dev)
    g = lambda: torch.Generator(dev).manual_seed(3)
    t1, a = timed(lambda: closed_loop(p, x0, 20, 10, noise_std=0.01, generator=g(), u_min=-4., u_max=4.))
    t3, a2 = timed(lambda: closed_loop(p, x0, 20, 10, noise_std=0.01, generator=g(), u_min=-4., u_max=4.), "error")
    with graphs.eager():
        t2, b = timed(lambda: closed_loop(p, x0, 20, 10, noise_std=0.01, generator=g(), u_min=-4., u_max=4.))
    print("closed_loop", t1, t3, t2, same(a, b), same(a2, b), flush=True)
    q = make_quadrotor()
    x = torch.from_numpy((0.1 * rng.standard_normal(12)).astype(np.float32)).to(dev)
    for ticks in (20, 60):
        t1, a = timed(lambda: rti.rti_closed_loop(q, x, 50, ticks))
        t3, a2 = timed(lambda: rti.rti_closed_loop(q, x, 50, ticks), "error")
        with graphs.eager():
            t2, b = timed(lambda: rti.rti_closed_loop(q, x, 50, ticks))
        print("rti", ticks, t1, t3, t2, same(a, b), same(a2, b), flush=True)
    print("  ", [e.graph.stats for e in rti._TICKS.cached()])


case("loops", loops)


def tf32():
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        s = make_cartpole()
        x0 = torch.from_numpy((0.2 * rng.standard_normal((64, 4))).astype(np.float32)).to(dev)
        us = torch.zeros((64, 20, 1), device=dev)
        c = ILQRConfig(iterations=2)
        print("tf32 flag on during replay:", same(ilqr.solve_batched(s, x0, us, c), ilqr.solve_batched_jit(s, x0, us, c))[0])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


case("tf32", tf32)


def eigh():
    s = make_cartpole()
    x0 = torch.zeros((4, 4), device=dev); us = torch.zeros((4, 10, 1), device=dev)
    try:
        ilqr.solve_batched_jit(s, x0, us, ILQRConfig(iterations=1, psd="eigh"))
        print("eigh: no error!")
    except graphs.CaptureError as e:
        print("eigh raised CaptureError:", e)


case("eigh", eigh)
case("cartpole full", lambda: batched(make_cartpole, 8192, 100, 10))
case("sm pendulum full", lambda: batched(make_sm_pendulum, 4096, 50, 10))
print("done", flush=True)
