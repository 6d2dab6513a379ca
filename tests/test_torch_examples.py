"""The examples' twins (examples/torch_*.py) on the CPU, each ``main`` at a
small size.  Where the JAX example prints values (quickstart,
fused_pipeline, quantized_views), it runs in the same test and the twin
prints the same lines: the same strings, but for ``ema[0,0]``, which is
held within float32's ``rtol=1e-6`` (XLA:CPU may contract a multiply-add
the port rounds twice).  fused_pipeline's twin is given the JAX example's
own inputs (``jax.random`` draws them there)."""

import os
import runpy
import sys

import numpy as np
import pytest

import simplemath_tpu as jsm
import simplemath_tpu_torch as sm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's default device is the card; these tests ask for the CPU."""
    old = sm.config.device
    sm.configure(device="cpu")
    yield
    sm.configure(device=old)


def _twin(name):
    """The twin's module namespace (examples/ is not a package)."""
    return runpy.run_path(os.path.join(EXAMPLES, f"torch_{name}.py"))


def _lines(capsys):
    return [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]


def test_twins_import_nothing_of_jax():
    for name in ("quickstart", "fused_pipeline", "quantized_views", "batched_cartpole",
                 "constrained_pendulum", "mpc_quadrotor", "rti_mpc"):
        with open(os.path.join(EXAMPLES, f"torch_{name}.py")) as f:
            src = f.read()
        assert "import jax" not in src and "simplemath_tpu " not in src
        assert "simplemath_tpu." not in src.replace("simplemath_tpu_torch", "")
        assert '"--device", default="cuda"' in src


def test_quickstart_prints_what_the_jax_example_prints(capsys):
    runpy.run_path(os.path.join(EXAMPLES, "quickstart.py"), run_name="__main__")
    want = _lines(capsys)
    _twin("quickstart")["main"](["--device", "cpu"])
    assert _lines(capsys) == want


def test_fused_pipeline_prints_what_the_jax_example_prints(capsys):
    old = jsm.config.kernel_backend
    try:
        g = runpy.run_path(os.path.join(EXAMPLES, "fused_pipeline.py"))
    finally:
        jsm.configure(kernel_backend=old)
    want = _lines(capsys)
    _twin("fused_pipeline")["run"](np.asarray(g["a"].jax()), np.asarray(g["e_row"].jax()))
    got = _lines(capsys)
    assert got[:-1] == want[:-1]
    assert got[-1].startswith("ema[0,0] = ") and want[-1].startswith("ema[0,0] = ")
    np.testing.assert_allclose(float(got[-1].split("= ")[1]), float(want[-1].split("= ")[1]),
                               rtol=1e-6)


def test_fused_pipeline_main_at_a_small_size(capsys):
    z = _twin("fused_pipeline")["main"](["--n", "64", "--device", "cpu"])
    lines = _lines(capsys)
    assert lines[0] == "launches: {'elementwise:fused': 1}"
    assert lines[3] == "max |fused - chain| = 0.0"
    assert z.shape == (64, 64) and np.isfinite(z.numpy()).all()


def test_quantized_views_prints_what_the_jax_example_prints(capsys):
    runpy.run_path(os.path.join(EXAMPLES, "quantized_views.py"))
    want = _lines(capsys)
    _twin("quantized_views")["main"](["--device", "cpu"])
    assert _lines(capsys) == want


@pytest.fixture
def _own_world():
    """A world of one that the test makes (``--sharded`` outside a
    launcher) is taken down after it, so that later tests find none."""
    import torch.distributed as dist

    was = dist.is_initialized()
    yield
    if not was and dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("sharded", [False, True], ids=["one_card", "sharded"])
def test_batched_cartpole(capsys, sharded, _own_world):
    argv = ["--batch", "16", "--horizon", "10", "--iters", "2", "--device", "cpu"]
    result = _twin("batched_cartpole")["main"](argv + (["--sharded"] if sharded else []))
    lines = _lines(capsys)
    assert "batch=16 horizon=10 iters=2" in lines
    cost = float(next(ln for ln in lines if ln.startswith("mean final cost:")).split(": ")[1])
    assert np.isfinite(cost) and abs(cost - float(result.cost.mean())) < 0.01
    assert result.cost_trace.shape == (16, 2)
    assert any(ln.startswith("mesh: ") for ln in lines) == sharded


def test_constrained_pendulum(capsys):
    res = _twin("constrained_pendulum")["main"](["--horizon", "20", "--device", "cpu"])
    lines = _lines(capsys)
    assert [ln.split(":")[0].strip() for ln in lines] == [
        "cost", "max violation", "max |u|", "max multiplier", "final theta"]
    assert float(res.us.abs().max()) <= 2.0 + 1e-4
    assert float(res.max_violation) < 1e-3


def test_mpc_quadrotor(capsys):
    x = _twin("mpc_quadrotor")["main"](["--horizon", "10", "--ticks", "21", "--device", "cpu"])
    lines = _lines(capsys)
    assert lines[0].startswith("t=  0") and lines[1].startswith("t= 20")
    assert lines[-1].startswith("final position error:")
    err = float(lines[-1].split(":")[1])
    assert np.isfinite(err) and err < np.linalg.norm([1.0, -1.0, 0.5])
    assert x.shape == (12,)


def test_rti_mpc(capsys):
    xs = _twin("rti_mpc")["main"](["--horizon", "8", "--ticks", "21", "--device", "cpu"])
    lines = _lines(capsys)
    assert lines[0].startswith("t=  0") and lines[1].startswith("t= 20")
    assert lines[-1].startswith("final position error:")
    assert np.isfinite(xs.numpy()).all()


def test_main_takes_the_device(monkeypatch):
    """``--device`` sets the port's device (the card by default)."""
    monkeypatch.setattr(sys, "argv", ["torch_quickstart.py"])
    ns = _twin("quickstart")
    ns["main"](["--device", "cpu"])
    assert sm.config.device == "cpu"
