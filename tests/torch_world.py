"""Run a script in a world of processes of the port on the CPU (gloo).

The parallel twins (tests/test_torch_parallel.py, test_torch_horizon.py,
test_torch_scaling.py) hold the port's ``torch.distributed`` layer against
the JAX package's ``shard_map`` layer on the 8 virtual CPU devices of
tests/conftest.py.  The port runs one process per rank, so each test module
starts one world of ``n`` ranks (a module-scoped fixture) that runs every
check of the module; each test then asserts its own part of the world's
output.  The ranks import the port and torch, never jax: this process
imported jax (tests/conftest.py).

Each rank joins the world through ``parallel.initialize_from_env`` with
``SM_DEVICE=cpu`` (gloo), reads the inputs this process wrote
(``INPUTS``, a dict of numpy arrays), runs ``script`` with ``part`` to
record each named check's results (numpy arrays), and writes them; a
check that raises records its traceback under ``<name>:error`` instead, so
the other checks still report.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import textwrap

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRELUDE = textwrap.dedent(
    """
    import os, sys, traceback
    import numpy as np
    import torch
    from simplemath_tpu_torch.parallel import multihost

    multihost.initialize_from_env()
    RANK, WORLD = multihost.process_index(), multihost.process_count()
    INPUTS = dict(np.load(os.environ["SM_WORLD_IN"]))
    OUT = {}

    def _np(v):
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy()
        return np.asarray(v)

    def part(name):
        def run(fn):
            try:
                for k, v in (fn() or {}).items():
                    OUT[f"{name}:{k}"] = _np(v)
            except Exception:
                OUT[f"{name}:error"] = np.asarray(traceback.format_exc())
            return fn
        return run
    """
)

_EPILOGUE = textwrap.dedent(
    """
    OUT["jax_imported"] = np.asarray("jax" in sys.modules)
    np.savez(os.path.join(os.environ["SM_WORLD_OUT"], f"rank{RANK}.npz"), **OUT)
    from simplemath_tpu_torch.utils import graphs

    graphs.release()  # before the group, as a user of compiled collectives does
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    """
)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_world(n: int, script: str, inputs: dict, timeout: float = 240.0):
    """Run ``script`` on ``n`` ranks; returns each rank's results, a list
    of dicts of numpy arrays (key ``<part>:<name>``)."""
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(os.path.join(tmp, "inputs.npz"), **inputs)
        env = {
            **os.environ,
            "SM_DEVICE": "cpu",
            "COORDINATOR_ADDRESS": f"localhost:{free_port()}",
            "NUM_PROCESSES": str(n),
            "SM_WORLD_IN": os.path.join(tmp, "inputs.npz"),
            "SM_WORLD_OUT": tmp,
            "OMP_NUM_THREADS": "1",
        }
        code = _PRELUDE + textwrap.dedent(script) + _EPILOGUE
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(n)]
        procs = [
            subprocess.Popen(
                [sys.executable, "-c", code], env={**env, "PROCESS_ID": str(r)},
                stdout=log, stderr=subprocess.STDOUT, cwd=ROOT,
            )
            for r, log in enumerate(logs)
        ]
        errs = []
        try:
            for r, p in enumerate(procs):
                if p.wait(timeout=timeout) != 0:
                    logs[r].seek(0)
                    errs.append(f"rank {r} exited {p.returncode}:\n{logs[r].read()[-3000:]}")
        except subprocess.TimeoutExpired:
            errs.append(f"the world of {n} ranks ran past {timeout} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in logs:
                log.close()
        if errs:
            raise RuntimeError("\n".join(errs))
        return [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(n)]


def results(world, name: str, rank: int = 0) -> dict:
    """One part's results on one rank; raises with the rank's traceback if
    the part failed there."""
    out = world[rank]
    if f"{name}:error" in out:
        raise AssertionError(f"rank {rank}, part {name}:\n{out[f'{name}:error']}")
    prefix = name + ":"
    found = {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}
    assert found, f"part {name} recorded nothing on rank {rank}"
    return found
