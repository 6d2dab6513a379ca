#!/usr/bin/env python3
"""Which ``torch.distributed`` collectives take CUDA tensors, by backend,
with two ranks on one card.

    python3 tools/probe_torch_collectives.py [--timeout S]

Starts two processes for each case, both ranks on ``cuda:0``: gloo with
CUDA tensors, and NCCL (which may refuse two ranks on one device).  Each
rank tries ``all_reduce`` (SUM, AVG, MAX), ``all_gather_into_tensor``,
``reduce_scatter_tensor`` and ``batch_isend_irecv`` on CUDA tensors and
reports, per collective, "ok" (the right values), "wrong" or the error's
first line.  A case whose ranks do not finish within the timeout is
killed and reported as such.  Prints one JSON object.  The port's gloo
worlds stage card tensors through the host whatever this finds
(simplemath_tpu_torch/parallel/collectives.py).
"""

import json
import os
import socket
import subprocess
import sys

RANK_CODE = r"""
import json, sys
import torch, torch.distributed as dist
backend, rank, port = sys.argv[1], int(sys.argv[2]), sys.argv[3]
torch.cuda.set_device(0)
out = {}
try:
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=2)
except Exception as e:
    print(json.dumps({"init": f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"}))
    sys.exit(0)
dev = torch.device("cuda", 0)

def attempt(name, fn):
    try:
        out[name] = "ok" if fn() else "wrong"
        torch.cuda.synchronize()
    except Exception as e:
        out[name] = f"{type(e).__name__}: {(str(e).splitlines() or [''])[0][:200]}"

def reduce(op, want):
    def fn():
        t = torch.full((4,), float(rank + 1), device=dev)
        dist.all_reduce(t, op)
        return bool((t.cpu() == want).all())
    return fn

def gather():
    t = torch.full((3,), float(rank), device=dev)
    o = torch.empty(6, device=dev)
    dist.all_gather_into_tensor(o, t)
    return o.cpu().tolist() == [0, 0, 0, 1, 1, 1]

def scatter():
    t = torch.arange(4, dtype=torch.float32, device=dev) + rank
    o = torch.empty(2, device=dev)
    dist.reduce_scatter_tensor(o, t)
    return o.cpu().tolist() == ([1.0, 3.0] if rank == 0 else [5.0, 7.0])

def p2p():
    s = torch.full((2,), float(rank), device=dev)
    r = torch.empty(2, device=dev)
    peer = 1 - rank
    for q in dist.batch_isend_irecv([dist.P2POp(dist.isend, s, peer),
                                     dist.P2POp(dist.irecv, r, peer)]):
        q.wait()
    return r.cpu().tolist() == [float(peer)] * 2

attempt("all_reduce_sum", reduce(dist.ReduceOp.SUM, 3.0))
attempt("all_reduce_avg", reduce(dist.ReduceOp.AVG, 1.5))
attempt("all_reduce_max", reduce(dist.ReduceOp.MAX, 2.0))
attempt("all_gather_into_tensor", gather)
attempt("reduce_scatter_tensor", scatter)
attempt("batch_isend_irecv", p2p)
print(json.dumps(out))
dist.destroy_process_group()
"""


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def case(backend, timeout):
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, "-c", RANK_CODE, backend, str(r), port],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    ranks = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
            lines = [ln for ln in out.splitlines() if ln.startswith("{")]
            ranks.append(json.loads(lines[-1]) if lines else
                         {"exit": p.returncode, "stderr": err.strip().splitlines()[-1:]})
        except subprocess.TimeoutExpired:
            ranks.append({"timeout_s": timeout})
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()
    return ranks


def main():
    timeout = float(sys.argv[sys.argv.index("--timeout") + 1]) if "--timeout" in sys.argv else 90
    import torch

    result = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "device": torch.cuda.get_device_name(0),
              "gloo_cuda_tensors": case("gloo", timeout),
              "nccl_two_ranks_one_card": case("nccl", timeout)}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    os.environ.setdefault("NCCL_DEBUG", "WARN")
    sys.exit(main())
