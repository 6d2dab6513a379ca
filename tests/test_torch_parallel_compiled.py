"""The parallel layer's compiled programs on the CPU: the port's
``make_sharded_train_step`` and ``scenario_mpc_solve`` against the JAX
package's jitted ones, and their capture as CUDA graphs through the
stand-in graph (tests/torch_standin.py).

One gloo world of 2 ranks (tests/torch_world.py) runs every check of this
module; the JAX side runs the same numpy inputs on a mesh of 2 of the 8
virtual CPU devices of tests/conftest.py, so both split the batch in the
same 2 blocks.  On the CPU the compiled programs run their bodies eagerly,
as JAX's ``jit`` does there.  Sizes are tiny: batch 8, H <= 10, 2
iterations.

Tolerances, those of tests/test_torch_parallel.py: a sharded solve's costs
within ``rtol=1e-4`` and its controls within ``rtol=1e-3`` and 1e-4 x the
largest control; the scenario MPC's total costs within ``rtol=1e-4`` and
its controls and ``du0`` within ``rtol=1e-3`` and 1e-4 x the largest.

Inside the world each compiled program is also captured into the stand-in
(its capture records the ATen ops and the collectives, a replay re-runs
them): it must capture once, replay with the eager bits, record its
collectives in ``Graph.stats`` and issue none from Python at a replay, and
read nothing on the host during the capture.  A gloo group that would copy
card tensors through the host must raise ``graphs.CaptureError`` before
anything is built: the world's ranks have no card, so that check makes
gloo take the CPU tensors "through the host" (``collectives._through_host``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from simplemath_tpu import models as jmodels
from simplemath_tpu import parallel as jpar
from simplemath_tpu.models import sqp_mpc as jsqp
from simplemath_tpu.parallel import scaling as jscaling

from torch_world import results, run_world

pytestmark = pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multiple (virtual) devices")

N = 2  # ranks of the port's world, and devices of the JAX mesh
BATCH, HORIZON, ITERS = 8, 10, 2
SYSTEMS = {"cartpole": (4, 1), "sm_pendulum": (2, 1), "quadrotor": (12, 4), "pendulum": (2, 1)}

_SCRIPT = """
import sys
sys.path.insert(0, "tests")
import torch
import torch_standin
from simplemath_tpu_torch import parallel
from simplemath_tpu_torch.models import (
    ILQRConfig, ilqr, make_cartpole, make_pendulum, make_quadrotor, make_sm_pendulum, sqp_mpc,
)
from simplemath_tpu_torch.parallel import collectives, sharded
from simplemath_tpu_torch.parallel.scaling import sharding_overhead_report
from simplemath_tpu_torch.utils import graphs

T = {k: torch.from_numpy(v) for k, v in INPUTS.items()}
mesh = parallel.make_mesh()
cfg = ILQRConfig(iterations=ITERS)
MAKE = {"cartpole": make_cartpole, "sm_pendulum": make_sm_pendulum, "pendulum": make_pendulum,
        "quadrotor": make_quadrotor}
PROGRAMS = (ilqr._BATCHED_INIT, ilqr._BATCHED_ITERATIONS, sharded._STATS_AND_GATHERS,
            sqp_mpc._SCENARIO_STEP)


def flat(res, stats):
    return {**res._asdict(), **stats}


def same_bits(a, b):
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y) for x, y in zip(a, b))


def leaves(tree):
    return [t for t in torch.utils._pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


for name in ("cartpole", "sm_pendulum"):
    @part(f"step_{name}")
    def _(name=name):
        step = parallel.make_sharded_train_step(MAKE[name](), mesh, cfg, "scenario")
        return flat(*step(T[f"{name}_x0"], T[f"{name}_us"]))


for name in ("pendulum", "quadrotor"):
    @part(f"scenario_{name}")
    def _(name=name):
        us, du0, history = sqp_mpc.scenario_mpc_solve(
            MAKE[name](), T[f"{name}_x0"], T[f"{name}_us"], mesh, iterations=ITERS)
        return {"us": us, "du0": du0, "history": torch.tensor(history, dtype=torch.float64)}


@part("overhead")
def _():
    rep = sharding_overhead_report(total_batch=BATCH, horizon=HORIZON, iterations=ITERS)
    return {"keys": ",".join(sorted(rep)), "ratio": rep["sharded_over_unsharded"]}


def captured(run, programs):
    # (bits equal on the first and the second call, captures after each,
    # the collectives the capture recorded, COUNTS moved by the replays)
    with torch_standin.eager_reference():
        want = leaves(run())
    with torch_standin.installed(PROGRAMS) as standin:
        first = leaves(run())
        captures = standin.captures
        recorded = {}
        for p in programs:
            for entry in p.cached():
                for k, v in entry.graph.stats["collectives"].items():
                    recorded[k] = recorded.get(k, 0) + v
        before = dict(collectives.COUNTS)
        again = leaves(run())
        moved = {k: v - before.get(k, 0) for k, v in collectives.COUNTS.items()
                 if v != before.get(k, 0)}
        replays = [e.graph.graph.replays for p in programs for e in p.cached()]
        out = {"first_equal": same_bits(first, want), "again_equal": same_bits(again, want),
               "captures": captures, "captures_after": standin.captures, "moved": str(moved),
               "replays": replays}
    out.update({f"recorded:{k}": v for k, v in recorded.items()})
    return out


@part("standin_step")
def _():
    step = parallel.make_sharded_train_step(make_cartpole(), mesh, cfg, "scenario")
    return captured(lambda: step(T["cartpole_x0"], T["cartpole_us"]),
                    (sharded._STATS_AND_GATHERS,))


@part("standin_scenario")
def _():
    quad = make_quadrotor()
    return captured(lambda: sqp_mpc.scenario_mpc_solve(quad, T["quadrotor_x0"], T["quadrotor_us"],
                                                       mesh, iterations=ITERS),
                    (sqp_mpc._SCENARIO_STEP,))


@part("gloo_on_the_card")
def _():
    real_through_host, real_graph = collectives._through_host, graphs.Graph
    built = []

    class Counted(real_graph):
        def __init__(self, fn, device):
            built.append(device)
            super().__init__(fn, device)

    collectives._through_host = lambda group, device: torch.distributed.get_backend(group) == "gloo"
    graphs.Graph = Counted
    messages = []
    before = dict(collectives.COUNTS)
    try:
        with torch_standin.installed(PROGRAMS) as standin:
            step = parallel.make_sharded_train_step(make_cartpole(), mesh, cfg, "scenario")
            for run in (lambda: step(T["cartpole_x0"], T["cartpole_us"]),
                        lambda: sqp_mpc.scenario_mpc_solve(
                            make_quadrotor(), T["quadrotor_x0"], T["quadrotor_us"], mesh,
                            iterations=ITERS)):
                try:
                    run()
                    messages.append("no error")
                except graphs.CaptureError as e:
                    messages.append(str(e))
            cached = sum(len(p.cached()) for p in PROGRAMS)
            captures = standin.captures
        counts_unchanged = dict(collectives.COUNTS) == before
        with graphs.eager():  # the eager loop still runs on such a mesh
            r, _ = step(T["cartpole_x0"], T["cartpole_us"])
    finally:
        collectives._through_host, graphs.Graph = real_through_host, real_graph
    return {"messages": "\\n".join(messages), "graphs_built": len(built), "cached": cached,
            "captures": captures, "counts_unchanged": counts_unchanged, "eager_cost": r.cost}


@part("release")
def _():
    # The teardown call: every graph freed, the step built again after it.
    with torch_standin.installed(PROGRAMS):
        step = parallel.make_sharded_train_step(make_cartpole(), mesh, cfg, "scenario")
        first, _ = step(T["cartpole_x0"], T["cartpole_us"])
        built = [e for p in PROGRAMS for e in p.cached()]
        freed = graphs.release()
        left = sum(len(p.cached()) for p in graphs._PROGRAMS)
        reset = all(e.graph.graph.ops is None for e in built)
        again, _ = step(T["cartpole_x0"], T["cartpole_us"])
        rebuilt = sum(len(p.cached()) for p in PROGRAMS)
        graphs.release()
    return {"built": len(built), "freed": freed, "left": left, "reset": reset,
            "rebuilt": rebuilt, "same": torch.equal(first.cost, again.cost)}
"""


def _inputs():
    rng = np.random.default_rng(14)
    inputs = {}
    for name, (nx, nu) in SYSTEMS.items():
        scale = 0.1 if name == "quadrotor" else 0.2
        inputs[f"{name}_x0"] = (scale * rng.standard_normal((BATCH, nx))).astype(np.float32)
        inputs[f"{name}_us"] = np.zeros((BATCH, HORIZON, nu), np.float32)
    return inputs


@pytest.fixture(scope="module")
def jax_mesh():
    return jpar.make_mesh((N,), ("scenario",), devices=jax.devices()[:N])


@pytest.fixture(scope="module")
def world():
    inputs = _inputs()
    script = f"ITERS, BATCH, HORIZON = {ITERS}, {BATCH}, {HORIZON}\n" + _SCRIPT
    return inputs, run_world(N, script, inputs, timeout=600)


def _part(world, name):
    """Rank 0's results of a part, after checking rank 1 returned the same."""
    _, ranks = world
    got = results(ranks, name, 0)
    other = results(ranks, name, 1)
    for k, v in got.items():
        np.testing.assert_array_equal(other[k], v, err_msg=f"rank 1, {name}:{k}")
    return got


def _scaled(got, want, rtol, frac):
    want = np.asarray(want)
    atol = frac * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["cartpole", "sm_pendulum"])
def test_compiled_train_step_matches_jax_jit(world, jax_mesh, name):
    """The sm-written pendulum is held to the JAX package's pendulum, the
    same system (tests/test_torch_models.py)."""
    inputs, _ = world
    got = _part(world, f"step_{name}")
    jsystem = jmodels.make_pendulum() if name == "sm_pendulum" else jmodels.make_cartpole()
    step = jpar.make_sharded_train_step(jsystem, jax_mesh, jmodels.ILQRConfig(iterations=ITERS),
                                        "scenario")
    res, stats = step(jnp.asarray(inputs[f"{name}_x0"]), jnp.asarray(inputs[f"{name}_us"]))
    for field in ("cost", "cost_trace", "grad_norm"):
        assert got[field].shape == np.asarray(getattr(res, field)).shape
    np.testing.assert_allclose(got["cost"], np.asarray(res.cost), rtol=1e-4)
    np.testing.assert_allclose(got["cost_trace"], np.asarray(res.cost_trace), rtol=1e-4)
    _scaled(got["us"], res.us, 1e-3, 1e-4)
    _scaled(got["xs"], res.xs, 1e-3, 1e-4)
    for key in ("total_cost", "mean_cost"):
        assert got[key].shape == ()
        np.testing.assert_allclose(float(got[key]), float(stats[key]), rtol=1e-4)
    np.testing.assert_allclose(float(got["max_grad_norm"]), float(stats["max_grad_norm"]),
                               rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("name", ["pendulum", "quadrotor"])
def test_compiled_scenario_mpc_solve_matches_jax(world, jax_mesh, name):
    inputs, _ = world
    got = _part(world, f"scenario_{name}")
    jsystem = jmodels.SYSTEMS[name]()
    us, du0, history = jsqp.scenario_mpc_solve(jsystem, inputs[f"{name}_x0"], inputs[f"{name}_us"],
                                               jax_mesh, iterations=ITERS)
    assert got["us"].shape == np.asarray(us).shape and got["du0"].shape == np.asarray(du0).shape
    np.testing.assert_allclose(got["history"], history, rtol=1e-4)
    _scaled(got["us"], us, 1e-3, 1e-4)
    _scaled(got["du0"], du0, 1e-3, 1e-4)
    for earlier, later in zip(got["history"], got["history"][1:]):
        assert later <= earlier + 1e-5 * abs(earlier)


def test_release_frees_every_graph_before_teardown(world):
    """``graphs.release()`` frees the train step's three graphs (the
    rollout, the iteration, the statistics and gathers), leaves no entry in
    any program, and the step builds them again at its next call; the
    world's ranks then destroy their process group (tests/torch_world.py)."""
    got = _part(world, "release")
    assert int(got["built"]) == 3 and int(got["freed"]) == 3
    assert int(got["left"]) == 0 and bool(got["reset"])
    assert int(got["rebuilt"]) == 3 and bool(got["same"])


def test_sharding_overhead_report_keeps_the_jax_keys(world):
    got = _part(world, "overhead")
    want = jscaling.sharding_overhead_report(total_batch=BATCH, horizon=HORIZON,
                                             iterations=ITERS, n_devices=N)
    assert str(got["keys"]).split(",") == sorted(want)
    assert float(got["ratio"]) > 0


def test_sharded_step_captures_once_and_replays_eager_bits(world):
    """Three graphs (the initial rollout, one iteration, the statistics and
    gathers), captured at the first call; the second call replays them.
    The last graph holds a psum and a pmax and the five gathers."""
    got = _part(world, "standin_step")
    assert bool(got["first_equal"]) and bool(got["again_equal"])
    assert int(got["captures"]) == 3 and int(got["captures_after"]) == 3
    assert int(got["recorded:psum"]) == 1 and int(got["recorded:pmax"]) == 1
    assert int(got["recorded:all_gather"]) == 5
    assert str(got["moved"]) == "{}", "a replay issued a collective from Python"
    assert got["replays"].tolist() == [2]


def test_consensus_step_captures_once_and_replays_eager_bits(world):
    """One graph for the whole step: its three psums and the gather of the
    controls; each of the 2 + 2 iterations of the two calls one replay."""
    got = _part(world, "standin_scenario")
    assert bool(got["first_equal"]) and bool(got["again_equal"])
    assert int(got["captures"]) == 1 and int(got["captures_after"]) == 1
    assert int(got["recorded:psum"]) == 3 and int(got["recorded:all_gather"]) == 1
    assert str(got["moved"]) == "{}", "a replay issued a collective from Python"
    assert got["replays"].tolist() == [2 * ITERS]


def test_gloo_on_the_card_raises_before_the_warmup(world):
    got = _part(world, "gloo_on_the_card")
    messages = str(got["messages"]).split("\n")
    assert len(messages) == 2
    for message in messages:
        assert "gloo" in message and "NCCL" in message and "graphs.eager()" in message, message
    assert int(got["graphs_built"]) == 0 and int(got["cached"]) == 0
    assert int(got["captures"]) == 0 and bool(got["counts_unchanged"])
    assert np.isfinite(got["eager_cost"]).all()
