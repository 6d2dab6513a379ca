"""Elastic execution / failure detection of the port
(simplemath_tpu_torch/utils/elastic.py) on the CPU: twins of the seven
tests of tests/test_elastic.py, with their contract (a faulted-and-resumed
run is bitwise identical to an uninterrupted one, corruption is detected,
an out-of-process resume continues from the latest atomic checkpoint), and
a run that the JAX package checkpointed (its npz backend) resumed by the
port.  That one is held against the JAX package's own continued run within
float32's tolerance (``rtol=1e-6``): XLA:CPU may contract the step's
multiply-add, the port rounds the product first."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simplemath_tpu_torch as sm
from simplemath_tpu.utils import elastic as jelastic
from simplemath_tpu_torch.utils.elastic import (
    ElasticConfig,
    RestartBudgetExceeded,
    StateCorruption,
    resume_state,
    run_elastic,
    save_state,
    state_is_finite,
)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's default device is the card; these tests ask for the CPU."""
    old = sm.config.device
    sm.configure(device="cpu")
    yield
    sm.configure(device=old)


def _step(state, i):
    # A deterministic "solver iteration": contraction + step-dependent bias.
    x, c = state
    return 0.9 * x + 0.01 * torch.tensor(float(i), dtype=torch.float32), c + 1


def _init():
    return (torch.ones((4, 8), dtype=torch.float32), torch.tensor(0, dtype=torch.int32))


def _run_plain(n):
    s = _init()
    for i in range(n):
        s = _step(s, i)
    return s


def test_uninterrupted_matches_plain_loop(tmp_path):
    cfg = ElasticConfig(directory=str(tmp_path), checkpoint_every=4)
    out = run_elastic(_step, _init(), 10, cfg)
    ref = _run_plain(10)
    assert torch.equal(out[0], ref[0])
    assert int(out[1]) == 10


def test_injected_preemption_resumes_bitwise_identical(tmp_path):
    cfg = ElasticConfig(directory=str(tmp_path), checkpoint_every=3)
    fired = {"n": 0}

    def fault(step):
        if step == 7 and fired["n"] == 0:
            fired["n"] += 1
            raise RuntimeError("simulated preemption")
        return None

    out = run_elastic(_step, _init(), 12, cfg, inject_fault=fault)
    ref = _run_plain(12)
    assert fired["n"] == 1
    assert torch.equal(out[0], ref[0]) and int(out[1]) == 12


def test_restart_budget_exceeded(tmp_path):
    cfg = ElasticConfig(directory=str(tmp_path), checkpoint_every=2, max_restarts=2)

    def always_fault(step):
        if step == 3:
            raise RuntimeError("hard device failure")
        return None

    with pytest.raises(RestartBudgetExceeded):
        run_elastic(_step, _init(), 8, cfg, inject_fault=always_fault)
    # The last good checkpoint survives for out-of-process resume.
    resumed = resume_state(str(tmp_path), like=_init())
    assert resumed is not None and resumed[1] == 2


def test_deterministic_corruption_detected(tmp_path):
    cfg = ElasticConfig(directory=str(tmp_path), checkpoint_every=4)

    def corrupt(step):
        if step == 5:  # every attempt — deterministic divergence
            return lambda s: (s[0] * torch.nan, s[1])
        return None

    with pytest.raises(StateCorruption):
        run_elastic(_step, _init(), 10, cfg, inject_fault=corrupt)


def test_transient_corruption_rolled_back(tmp_path):
    cfg = ElasticConfig(directory=str(tmp_path), checkpoint_every=4)
    fired = {"n": 0}

    def corrupt_once(step):
        if step == 5 and fired["n"] == 0:
            fired["n"] += 1
            return lambda s: (s[0] + torch.inf, s[1])
        return None

    out = run_elastic(_step, _init(), 10, cfg, inject_fault=corrupt_once)
    ref = _run_plain(10)
    assert fired["n"] == 1
    assert torch.equal(out[0], ref[0])


def test_out_of_process_resume(tmp_path):
    cfg = ElasticConfig(directory=str(tmp_path), checkpoint_every=5)
    # "Process 1" runs 5 of 20 steps and dies (we just stop).
    run_elastic(_step, _init(), 5, cfg)
    # "Process 2" starts over with the same directory — picks up at 5.
    segments = []
    out = run_elastic(_step, _init(), 20, cfg, on_segment=lambda step, s: segments.append(step))
    assert segments[0] == 10  # first new segment boundary, not 5
    ref = _run_plain(20)
    assert torch.equal(out[0], ref[0]) and int(out[1]) == 20


def test_checkpoint_rotation(tmp_path):
    cfg = ElasticConfig(directory=str(tmp_path), checkpoint_every=2, keep=2)
    run_elastic(_step, _init(), 10, cfg)
    dirs = [d for d in os.listdir(tmp_path) if d.startswith("step_")]
    assert len(dirs) == 2
    assert max(dirs) == "step_" + "10".zfill(12)
    assert os.path.exists(tmp_path / "LATEST.json")


def test_overshot_checkpoint_raises(tmp_path):
    save_state(str(tmp_path), _run_plain(6), 6)
    with pytest.raises(ValueError, match="beyond"):
        run_elastic(_step, _init(), 4, ElasticConfig(directory=str(tmp_path)))


def test_state_is_finite_sweeps_floating_leaves_only():
    assert state_is_finite(_init())
    assert not state_is_finite((torch.tensor([1.0, torch.nan]), torch.tensor(3)))
    assert state_is_finite({"n": torch.tensor(2**31 - 1, dtype=torch.int32), "k": 4})


@jax.jit
def _jax_step(state, i):
    x, c = state
    return 0.9 * x + 0.01 * jnp.float32(i), c + 1


def test_the_port_resumes_a_jax_npz_checkpoint(tmp_path, monkeypatch):
    """The JAX package runs 5 of 20 steps and checkpoints them with its npz
    backend (orbax blocked); the port resumes from the same directory at
    step 5 and finishes, and the result is the JAX package's continued run."""
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    jinit = (jnp.ones((4, 8), jnp.float32), jnp.int32(0))
    jcfg = jelastic.ElasticConfig(directory=str(tmp_path), checkpoint_every=5)
    jelastic.run_elastic(lambda s, i: _jax_step(s, i), jinit, 5, jcfg)
    with open(os.path.join(jelastic._ckpt_path(str(tmp_path), 5), "meta.json")) as f:
        assert '"npz"' in f.read()
    segments = []
    out = run_elastic(_step, _init(), 20, ElasticConfig(directory=str(tmp_path),
                                                       checkpoint_every=5),
                      on_segment=lambda step, s: segments.append(step))
    assert segments == [10, 15, 20]
    want = jinit
    for i in range(20):
        want = _jax_step(want, i)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(want[0]), rtol=1e-6)
    assert int(out[1]) == int(want[1]) == 20 and out[1].dtype == torch.int32
