"""The port's scaling harness and multi-process helpers
(``parallel/scaling.py``, ``parallel/multihost.py``): twins of
tests/test_scaling.py.

The port runs one process per rank: the weak-scaling and overhead reports
run in one gloo world of 4 ranks (tests/torch_world.py), the two-process
``initialize_from_env`` case in a world of 2 whose ranks join through it
(as every world of tests/torch_world.py does), and the single-process
helpers in this process, which joins no world.
"""

import os
import subprocess
import sys

import pytest
import torch.distributed as dist

from simplemath_tpu.parallel import scaling as jscaling
from simplemath_tpu_torch.parallel import multihost

from torch_world import ROOT, results, run_world

_REPORTS = """
from simplemath_tpu_torch.parallel.scaling import sharding_overhead_report, weak_scaling_report


@part("weak")
def _():
    rep = weak_scaling_report(per_device_batch=8, horizon=10, iterations=2,
                              device_counts=(1, 2, 4))
    out = {f"{k}:{n}": v for k in ("times_s", "efficiency") for n, v in rep[k].items()}
    out.update({"device_counts": rep["device_counts"], "backend": rep["backend"],
                "efficiency_meaningful": rep["efficiency_meaningful"],
                "keys": ",".join(sorted(rep))})
    return out


@part("overhead")
def _():
    return sharding_overhead_report(total_batch=17, horizon=10, iterations=2, n_devices=2)
"""

_INIT = """
@part("init")
def _():
    start, size = multihost.host_local_batch_slice(8)
    mesh = multihost.pod_mesh()
    return {"result": [multihost.process_count(), start, size, mesh.devices.size]}
"""


@pytest.fixture(scope="module")
def reports():
    return run_world(4, _REPORTS, {})


def test_weak_scaling_report_cpu_world(reports):
    rep = results(reports, "weak")
    assert rep["device_counts"].tolist() == [1, 2, 4]
    for n in (1, 2, 4):
        assert float(rep[f"times_s:{n}"]) > 0
        assert float(rep[f"efficiency:{n}"]) > 0
    assert float(rep["efficiency:1"]) == pytest.approx(1.0)
    # ranks on the CPU share its cores: the report must say so
    assert not bool(rep["efficiency_meaningful"])
    assert str(rep["backend"]) == "gloo"
    # the JAX package's report has the same fields
    assert str(rep["keys"]).split(",") == sorted([
        "system", "per_device_batch", "horizon", "iterations", "backend",
        "device_counts", "times_s", "efficiency", "efficiency_meaningful"])
    assert "weak_scaling_report" in dir(jscaling)
    # every rank reports the same (the slowest rank's) times
    for r in range(1, 4):
        other = results(reports, "weak", r)
        assert all((other[k] == v).all() for k, v in rep.items())


def test_sharding_overhead_report(reports):
    rep = results(reports, "overhead")
    # 17 rounded down to a multiple of the rank count
    assert int(rep["total_batch"]) == 16
    assert int(rep["n_devices"]) == 2
    assert float(rep["unsharded_s"]) > 0 and float(rep["sharded_s"]) > 0
    assert float(rep["sharded_over_unsharded"]) == pytest.approx(
        float(rep["sharded_s"]) / float(rep["unsharded_s"]))


def test_host_local_batch_slice_single_process():
    assert multihost.host_local_batch_slice(64) == (0, 64)


def test_host_local_batch_slice_multi_process(monkeypatch):
    monkeypatch.setattr(multihost, "process_count", lambda: 4)
    monkeypatch.setattr(multihost, "process_index", lambda: 2)
    assert multihost.host_local_batch_slice(32) == (16, 8)
    with pytest.raises(ValueError, match="not divisible"):
        multihost.host_local_batch_slice(7)


def test_initialize_from_env_noop_when_unset(monkeypatch):
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    monkeypatch.delenv("NUM_PROCESSES", raising=False)
    multihost.initialize_from_env()  # must not raise or initialize anything
    assert not dist.is_initialized()
    assert multihost.process_count() == 1


def test_initialize_from_env_two_processes():
    """Two real processes stitched into one gloo world by
    initialize_from_env: host_local_batch_slice and pod_mesh end to end
    (one device a rank: the pod mesh holds the 2 ranks)."""
    world = run_world(2, _INIT, {})
    got = sorted(results(world, "init", r)["result"].tolist() for r in range(2))
    assert got == [[2, 0, 4, 2], [2, 4, 4, 2]]


def test_a_process_outside_a_world_is_a_world_of_one():
    """As a JAX process on one device: without ``init_process_group`` the
    first mesh makes a world of one rank (gloo on the CPU), and a sharded
    solve over it is the unsharded solve."""
    code = (
        "import torch\n"
        "from simplemath_tpu_torch import parallel\n"
        "from simplemath_tpu_torch.models import ILQRConfig, make_pendulum, solve_batched\n"
        "mesh = parallel.make_mesh()\n"
        "info = parallel.device_info()\n"
        "assert mesh.devices.size == 1 and info['n_devices'] == 1 and info['backend'] == 'gloo'\n"
        "x0, us = 0.3 * torch.ones((4, 2)), torch.zeros((4, 10, 1))\n"
        "r, stats = parallel.solve_batched_sharded(make_pendulum(), x0, us, ILQRConfig(2), mesh)\n"
        "ref = solve_batched(make_pendulum(), x0, us, ILQRConfig(2))\n"
        "assert torch.equal(r.cost, ref.cost) and torch.equal(r.us, ref.us)\n"
        "assert float(stats['total_cost']) == float(ref.cost.sum())\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120,
                   env={**os.environ, "SM_DEVICE": "cpu"})
