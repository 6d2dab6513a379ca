"""The port's distributed layer (``simplemath_tpu_torch.parallel``) against
the JAX package's, on the CPU: twins of tests/test_distributed.py,
tests/test_kernels_sharded.py and the scenario-consensus cases of
tests/test_sqp_mpc.py.

The port runs one process per rank in a gloo world; one world of 2 ranks
(tests/torch_world.py) runs every check of this module, each rank handed
the same global numpy inputs, and each test asserts its part of the
world's output.  The JAX side runs the same inputs through ``shard_map``
on the 8 virtual CPU devices of tests/conftest.py.  Both ranks return the
global result, so rank 1's must equal rank 0's.

Tolerances: the JAX tests' own (sharded solve ``rtol=1e-4``; the kernels'
as in tests/test_kernels_sharded.py); scenario MPC costs within
``rtol=1e-4`` and controls within ``rtol=1e-3`` and 1e-4 x the largest
control, as the solver twins (tests/test_torch_models.py).

The port's ``sm.matmul`` of floats is ``torch.matmul``'s (ops/engine.py);
its matmul kernels take ``sm.fuse``'s matmul root, so the matmul twins run
the product as that root.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import simplemath_tpu as jsm
from simplemath_tpu import models as jmodels
from simplemath_tpu import parallel as jpar
from simplemath_tpu.models import ilqr as jilqr
from simplemath_tpu.models import sqp_mpc as jsqp

from torch_world import ROOT, results, run_world

pytestmark = pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multiple (virtual) devices")

N = 2  # ranks of the port's world

_SCRIPT = """
import torch
import simplemath_tpu_torch as sm
from simplemath_tpu_torch import parallel
from simplemath_tpu_torch.models import ILQRConfig, make_pendulum
from simplemath_tpu_torch.models.ilqr import solve_batched
from simplemath_tpu_torch.models.sqp_mpc import make_scenario_mpc_step, scenario_mpc_solve
from simplemath_tpu_torch.ops import dispatch
from simplemath_tpu_torch.parallel.mesh import PartitionSpec as P

T = {k: torch.from_numpy(v) for k, v in INPUTS.items()}
mesh = parallel.make_mesh()


@part("device_info")
def _():
    info = parallel.device_info()
    return {"n_devices": info["n_devices"], "n_processes": info["n_processes"],
            "backend": info["backend"], "platforms": ",".join(info["platforms"])}


@part("mesh_default")
def _():
    return {"size": mesh.devices.size, "names": ",".join(mesh.axis_names),
            "coordinate": mesh.coordinate("scenario")}


@part("mesh_2d")
def _():
    m2 = parallel.make_mesh((2, WORLD // 2), ("dcn", "scenario"))
    return {"dcn": m2.shape["dcn"], "scenario": m2.shape["scenario"],
            "ranks": m2.devices}


@part("mesh_mismatch")
def _():
    try:
        parallel.make_mesh((3,), ("scenario",))
    except ValueError as e:
        return {"message": str(e)}
    return {"message": "no error"}


@part("collectives")
def _():
    x = T["coll_x"]
    before = x.clone()

    def fn(x):
        s = parallel.psum(torch.sum(x), "scenario")
        m = parallel.pmax(torch.amax(x), "scenario")
        lo = parallel.pmin(torch.amin(x), "scenario")
        mean = parallel.pmean(torch.sum(x), "scenario")
        g = parallel.all_gather(x, "scenario")
        idx = parallel.axis_index("scenario").reshape(1)
        rs = parallel.reduce_scatter(x, "scenario")
        return s, m, lo, mean, g, idx, rs

    s, m, lo, mean, g, idx, rs = parallel.shard_map(
        fn, mesh=mesh, in_specs=P("scenario"),
        out_specs=(P(), P(), P(), P(), P("scenario"), P("scenario"), P("scenario")))(x)
    return {"s": s, "m": m, "lo": lo, "mean": mean, "g": g, "idx": idx, "rs": rs,
            "input_unchanged": torch.equal(x, before)}


@part("ring")
def _():
    out = parallel.shard_map(
        lambda x: parallel.ppermute_ring(x, "scenario", shift=1),
        mesh=mesh, in_specs=P("scenario"), out_specs=P("scenario"))(T["ring_x"])
    return {"out": out}


@part("sharded_solve")
def _():
    system = make_pendulum()
    cfg = ILQRConfig(iterations=3)
    res, stats = parallel.solve_batched_sharded(system, T["solve_x0s"], T["solve_us"], cfg, mesh)
    local = solve_batched(system, T["solve_x0s"], T["solve_us"], cfg)
    return {"cost": res.cost, "us": res.us, "local_cost": local.cost,
            "total_cost": stats["total_cost"], "max_grad_norm": stats["max_grad_norm"],
            "mean_cost": stats["mean_cost"]}


@part("bad_batch")
def _():
    x0s = torch.zeros((WORLD + 1, 2))
    us = torch.zeros((WORLD + 1, 20, 1))
    try:
        parallel.solve_batched_sharded(make_pendulum(), x0s, us, ILQRConfig(1), mesh)
    except ValueError as e:
        return {"message": str(e)}
    return {"message": "no error"}


def kernel_part(name, fn, in_specs, out_specs, *args):
    @part(name)
    def _():
        dispatch.reset()
        out = parallel.shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs)(*args)
        out = out if isinstance(out, tuple) else (out,)
        found = {f"out{i}": o.float() if o.dtype == torch.bfloat16 else o
                 for i, o in enumerate(out)}
        found.update({f"count:{k}": v for k, v in dispatch.counts().items()})
        return found


kernel_part("k_elementwise",
            lambda a, b: ((c := sm.add(sm.Array(a), sm.Array(b)).torch()),
                          parallel.psum(torch.sum(c), "scenario")),
            (P("scenario"), P("scenario")), (P("scenario"), P()), T["ew_a"], T["ew_b"])
fused = sm.fuse(lambda x, y: sm.exp(sm.pow(x, y)))
kernel_part("k_fused", lambda a, e: fused(a, e).torch(),
            (P("scenario"), P("scenario")), P("scenario"), T["fu_a"], T["fu_e"])
kernel_part("k_reduction",
            lambda x: parallel.psum(sm.Array(x).sum().torch(), "scenario"),
            (P("scenario"),), P(), T["rd_x"])
product = sm.fuse(lambda x, y: x @ y)
kernel_part("k_matmul",
            lambda a, b: ((c := product(a, b).torch()),
                          parallel.psum(torch.sum(c), "scenario")),
            (P("scenario"), P()), (P("scenario"), P()), T["mm_a"], T["mm_b"])
kernel_part("k_bmm", lambda a, b: product(a, b).torch(),
            (P("scenario"), P("scenario")), P("scenario"), T["bmm_a"], T["bmm_b"])
kernel_part("k_dot1d",
            lambda a, b: parallel.psum(sm.dot(sm.Array(a), sm.Array(b)).torch(), "scenario"),
            (P("scenario"), P("scenario")), P(), T["dot_a"], T["dot_b"])
layer = sm.fuse(lambda x, w, bias: sm.maximum(x @ w + bias, 0.0))
kernel_part("k_epilogue",
            lambda x, w, b: ((y := layer(x, w, b).torch()),
                             parallel.psum(torch.sum(y), "scenario")),
            (P("scenario"), P(), P()), (P("scenario"), P()), T["ep_x"], T["ep_w"], T["ep_b"])
kernel_part("k_axis",
            lambda a: ((rows := sm.array(a).sum(axis=1).torch()),
                       parallel.psum(torch.sum(rows), "scenario")),
            (P("scenario"),), (P("scenario"), P()), T["ax_a"])
kernel_part("k_view", lambda a, b: sm.add(sm.Array(a).T, sm.Array(b)).torch(),
            (P(None, "scenario"), P("scenario")), P("scenario"), T["vw_a"], T["vw_b"])


def mpc_part(name, x0s, us):
    @part(name)
    def _():
        us_new, du0, stats = make_scenario_mpc_step(make_pendulum(), mesh)(x0s, us)
        return {"us": us_new, "du0": du0, "total_cost": stats["total_cost"],
                "alpha": stats["alpha"]}


mpc_part("mpc_step", T["mpc_x0s"], T["mpc_us"])
mpc_part("mpc_adversarial", T["adv_x0s"], T["adv_us"])
mpc_part("mpc_warm", T["mpc_x0s"], T["jax_step1_us"])


@part("mpc_solve")
def _():
    _, _, history = scenario_mpc_solve(make_pendulum(), T["dec_x0s"], T["dec_us"], mesh,
                                       iterations=3)
    return {"history": torch.tensor(history, dtype=torch.float64)}
"""


def _inputs():
    rng = np.random.default_rng(0)
    f32 = np.float32
    n = 8  # blocks of the JAX mesh; the port's world splits the same arrays in 2
    key = jax.random.PRNGKey
    inputs = {
        "coll_x": np.arange(n * 4, dtype=f32).reshape(n, 4),
        "ring_x": np.arange(N, dtype=f32).reshape(N, 1),
        "solve_x0s": np.asarray(0.3 * jax.random.normal(key(0), (16, 2), dtype=jnp.float32)),
        "solve_us": np.zeros((16, 20, 1), f32),
        "ew_a": rng.standard_normal((n * 4, 256)).astype(f32),
        "ew_b": rng.standard_normal((n * 4, 256)).astype(f32),
        "fu_a": rng.uniform(0.5, 2.0, (n * 2, 128)).astype(f32),
        "fu_e": rng.uniform(-1.0, 1.0, (n * 2, 128)).astype(f32),
        "rd_x": rng.standard_normal((n * 8, 100)).astype(f32),
        "mm_a": (rng.standard_normal((n * 256, 256)) / 16).astype(f32),
        "mm_b": (rng.standard_normal((256, 288)) / 16).astype(f32),
        "bmm_a": (rng.standard_normal((n, 256, 260)) / 16).astype(f32),
        "bmm_b": (rng.standard_normal((n, 260, 256)) / 16).astype(f32),
        "dot_a": rng.standard_normal((n * 2048,)).astype(f32),
        "dot_b": rng.standard_normal((n * 2048,)).astype(f32),
        "ep_x": rng.standard_normal((n * 32, 300)).astype(f32),
        "ep_w": rng.standard_normal((300, 320)).astype(f32),
        "ep_b": rng.standard_normal((1, 320)).astype(f32),
        "ax_a": rng.standard_normal((n * 64, 256)).astype(f32),
        "vw_a": rng.standard_normal((256, n * 32)).astype(f32),
        "vw_b": rng.standard_normal((n * 32, 256)).astype(f32),
        "mpc_x0s": np.asarray(0.2 * jax.random.normal(key(0), (16, 2), dtype=jnp.float32)),
        "mpc_us": np.zeros((16, 20, 1), f32),
        "dec_x0s": np.asarray(0.3 * jax.random.normal(key(3), (16, 2), dtype=jnp.float32)),
        "dec_us": np.zeros((16, 20, 1), f32),
        "adv_x0s": np.asarray(0.2 * jax.random.normal(key(7), (16, 2), dtype=jnp.float32)),
        "adv_us": np.asarray(5.0 * jax.random.normal(key(8), (16, 20, 1), dtype=jnp.float32)),
    }
    return inputs


@pytest.fixture(scope="module")
def jax_mesh():
    return jpar.make_mesh()


@pytest.fixture(scope="module")
def jax_step(jax_mesh):
    return jax.jit(jsqp.make_scenario_mpc_step(jmodels.make_pendulum(), jax_mesh))


@pytest.fixture(scope="module")
def world(jax_step):
    inputs = _inputs()
    # The warm start of the state test: the JAX package's first step.
    us1, _, _ = jax_step(inputs["mpc_x0s"], inputs["mpc_us"])
    inputs["jax_step1_us"] = np.asarray(us1)
    return inputs, run_world(N, _SCRIPT, inputs)


def _part(world, name):
    """Rank 0's results of a part, after checking rank 1 returned the same."""
    _, ranks = world
    got = results(ranks, name, 0)
    for r in range(1, N):
        other = results(ranks, name, r)
        for k, v in got.items():
            if k in ("coordinate",):
                continue
            np.testing.assert_array_equal(other[k], v, err_msg=f"rank {r}, {name}:{k}")
    return got


def _scaled(got, want, rtol, frac):
    want = np.asarray(want)
    atol = frac * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=atol)


# ------------------------------------------------------ test_distributed twins
def test_device_info(world):
    got = _part(world, "device_info")
    assert int(got["n_devices"]) == N and int(got["n_processes"]) == N
    assert str(got["backend"]) == "gloo" and str(got["platforms"]) == "cpu"
    assert jpar.device_info()["n_devices"] >= 2


def test_make_mesh_default(world):
    got = _part(world, "mesh_default")
    assert int(got["size"]) == N and str(got["names"]) == "scenario"
    coords = [int(results(world[1], "mesh_default", r)["coordinate"]) for r in range(N)]
    assert coords == list(range(N))
    assert jpar.make_mesh().axis_names == ("scenario",)


def test_make_mesh_2d(world):
    got = _part(world, "mesh_2d")
    assert int(got["dcn"]) == 2 and int(got["scenario"]) == N // 2
    np.testing.assert_array_equal(got["ranks"], np.arange(N).reshape(2, N // 2))
    n = len(jax.devices())
    assert jpar.make_mesh((2, n // 2), ("dcn", "scenario")).shape["dcn"] == 2


def test_mesh_mismatch_raises(world):
    got = _part(world, "mesh_mismatch")
    with pytest.raises(ValueError, match="device count") as want:
        jpar.make_mesh((3,), ("scenario",))
    assert str(got["message"]) == str(want.value).replace(str(len(jax.devices())), str(N))


def test_collectives_in_shard_map(world):
    inputs, _ = world
    got = _part(world, "collectives")
    x = inputs["coll_x"]
    assert float(got["s"]) == float(x.sum())
    assert float(got["m"]) == float(x.max()) and float(got["lo"]) == float(x.min())
    assert float(got["mean"]) == float(x.sum()) / N
    # Each rank gathers every rank's block: the global array N times over.
    np.testing.assert_array_equal(got["g"], np.concatenate([x] * N))
    np.testing.assert_array_equal(got["idx"], np.arange(N, dtype=np.int32))
    # reduce_scatter of each rank's block, gathered: the blocks' sum, split.
    np.testing.assert_array_equal(got["rs"], x.reshape(N, -1, x.shape[1]).sum(axis=0))
    assert bool(got["input_unchanged"])

    # The JAX package's on its 8 devices (tests/test_distributed.py).
    mesh = jpar.make_mesh()
    n = mesh.devices.size
    xj = jnp.arange(n * n * 4, dtype=jnp.float32).reshape(n * n, 4)

    def fn(x):
        s = jpar.psum(jnp.sum(x), "scenario")
        m = jpar.pmax(jnp.max(x), "scenario")
        g = jpar.all_gather(x, "scenario")
        idx = jpar.axis_index("scenario").reshape(1)
        rs = jpar.reduce_scatter(x, "scenario")
        return s, m, g, idx, rs

    s, m, g, idx, rs = jpar.shard_map(
        fn, mesh=mesh, in_specs=P("scenario"),
        out_specs=(P(), P(), P("scenario"), P("scenario"), P("scenario")))(xj)
    assert float(s) == float(jnp.sum(xj)) and float(m) == float(jnp.max(xj))
    assert g.shape == (n * n * n, 4)
    np.testing.assert_array_equal(np.asarray(idx), np.arange(n))
    np.testing.assert_array_equal(np.asarray(rs),
                                  np.asarray(xj).reshape(n, n, 4).sum(axis=0))


def test_ring_permute(world):
    got = _part(world, "ring")
    np.testing.assert_array_equal(got["out"].ravel(), np.roll(np.arange(N), 1).astype(np.float32))
    mesh = jpar.make_mesh()
    n = mesh.devices.size
    out = jpar.shard_map(lambda x: jpar.ppermute_ring(x, "scenario", shift=1), mesh=mesh,
                         in_specs=P("scenario"), out_specs=P("scenario"))(
        jnp.arange(n, dtype=jnp.float32).reshape(n, 1))
    np.testing.assert_array_equal(np.asarray(out).ravel(), np.roll(np.arange(n), 1))


def test_sharded_solve_matches_local(world):
    inputs, _ = world
    got = _part(world, "sharded_solve")
    system = jmodels.make_pendulum()
    cfg = jmodels.ILQRConfig(iterations=3)
    x0s, us = inputs["solve_x0s"], inputs["solve_us"]
    local = jilqr.solve_batched(system, x0s, us, cfg)
    shard_res, stats = jpar.solve_batched_sharded(system, x0s, us, cfg, jpar.make_mesh())
    for want in (local.cost, shard_res.cost):
        np.testing.assert_allclose(got["cost"], np.asarray(want), rtol=1e-4)
    np.testing.assert_allclose(got["cost"], got["local_cost"], rtol=1e-4)
    assert got["total_cost"].shape == ()
    np.testing.assert_allclose(float(got["total_cost"]), float(jnp.sum(local.cost)), rtol=1e-4)
    np.testing.assert_allclose(float(got["total_cost"]), float(stats["total_cost"]), rtol=1e-4)
    np.testing.assert_allclose(float(got["mean_cost"]), float(got["total_cost"]) / 16, rtol=1e-6)
    assert float(got["max_grad_norm"]) >= 0


def test_sharded_solve_bad_batch_raises(world):
    got = _part(world, "bad_batch")
    mesh = jpar.make_mesh()
    n = mesh.devices.size
    with pytest.raises(ValueError, match="divisible") as want:
        jpar.solve_batched_sharded(jmodels.make_pendulum(), jnp.zeros((n + 1, 2)),
                                   jnp.zeros((n + 1, 20, 1)), jmodels.ILQRConfig(1), mesh)
    assert str(got["message"]) == f"scenario batch {N + 1} not divisible by mesh axes ('scenario',)={N}"
    assert str(want.value) == f"scenario batch {n + 1} not divisible by mesh axes ('scenario',)={n}"


# -------------------------------------------------- test_kernels_sharded twins
def _jax_sharded(fn, in_specs, out_specs, *args):
    return jax.jit(jpar.shard_map(fn, mesh=jpar.make_mesh(), in_specs=in_specs,
                                  out_specs=out_specs, check_vma=False))(*args)


def _counted(got, key):
    assert int(got.get(f"count:{key}", 0)) >= 1, {k: v for k, v in got.items() if "count" in k}


def test_elementwise_kernel_inside_shard_map(world):
    inputs, _ = world
    a, b = inputs["ew_a"], inputs["ew_b"]
    got = _part(world, "k_elementwise")
    c, total = _jax_sharded(
        lambda x, y: ((z := jsm.add(jsm.Array(x), jsm.Array(y)).jax()),
                      jax.lax.psum(jnp.sum(z), "scenario")),
        (P("scenario"), P("scenario")), (P("scenario"), P()), a, b)
    np.testing.assert_array_equal(got["out0"], np.asarray(c))
    np.testing.assert_allclose(got["out0"], a + b, rtol=1e-6)
    np.testing.assert_allclose(float(got["out1"]), float(total), rtol=1e-4)
    _counted(got, "elementwise:add")


def test_fused_kernel_inside_shard_map(world):
    inputs, _ = world
    a, e = inputs["fu_a"], inputs["fu_e"]
    got = _part(world, "k_fused")
    fused = jsm.fuse(lambda x, y: jsm.exp(jsm.pow(x, y)))
    want = _jax_sharded(lambda x, y: fused(x, y).jax(), (P("scenario"), P("scenario")),
                        P("scenario"), a, e)
    np.testing.assert_allclose(got["out0"], np.asarray(want), rtol=3e-5)
    np.testing.assert_allclose(got["out0"], np.exp(np.power(a.astype(np.float64), e)), rtol=3e-5)
    _counted(got, "elementwise:fused")


def test_reduction_kernel_inside_shard_map(world):
    inputs, _ = world
    x = inputs["rd_x"]
    got = _part(world, "k_reduction")
    want = _jax_sharded(lambda s: jax.lax.psum(jsm.Array(s).sum().jax(), "scenario"),
                        (P("scenario"),), P(), x)
    np.testing.assert_allclose(float(got["out0"]), x.sum(), rtol=1e-4)
    np.testing.assert_allclose(float(got["out0"]), float(want), rtol=1e-4)
    _counted(got, "reduce:sum")


def test_matmul_kernel_inside_shard_map(world):
    inputs, _ = world
    a, b = inputs["mm_a"], inputs["mm_b"]
    got = _part(world, "k_matmul")
    c, total = _jax_sharded(
        lambda x, y: ((z := jsm.matmul(jsm.Array(x), jsm.Array(y)).jax()),
                      jax.lax.psum(jnp.sum(z), "scenario")),
        (P("scenario"), P()), (P("scenario"), P()), a, b)
    np.testing.assert_allclose(got["out0"], a @ b, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got["out0"], np.asarray(c), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(got["out1"]), (a @ b).sum(), rtol=1e-3)
    np.testing.assert_allclose(float(got["out1"]), float(total), rtol=1e-3)
    _counted(got, "matmul:mm")


def test_bmm_kernel_inside_shard_map(world):
    inputs, _ = world
    a, b = inputs["bmm_a"], inputs["bmm_b"]
    got = _part(world, "k_bmm")
    c = _jax_sharded(lambda x, y: jsm.matmul(jsm.Array(x), jsm.Array(y)).jax(),
                     (P("scenario"), P("scenario")), P("scenario"), a, b)
    np.testing.assert_allclose(got["out0"], a @ b, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got["out0"], np.asarray(c), rtol=2e-4, atol=2e-4)
    _counted(got, "matmul:bmm")


def test_dot1d_kernel_inside_shard_map(world):
    inputs, _ = world
    a, b = inputs["dot_a"], inputs["dot_b"]
    got = _part(world, "k_dot1d")
    want = _jax_sharded(
        lambda x, y: jax.lax.psum(jsm.dot(jsm.Array(x), jsm.Array(y)).jax(), "scenario"),
        (P("scenario"), P("scenario")), P(), a, b)
    np.testing.assert_allclose(float(got["out0"]), np.dot(a.astype(np.float64), b), rtol=1e-4)
    np.testing.assert_allclose(float(got["out0"]), float(want), rtol=1e-4)
    _counted(got, "dot1d")


def test_matmul_epilogue_inside_shard_map(world):
    inputs, _ = world
    X, W, b = inputs["ep_x"], inputs["ep_w"], inputs["ep_b"]
    got = _part(world, "k_epilogue")
    layer = jsm.fuse(lambda x, w, bias: jsm.maximum(x @ w + bias, 0.0))
    y, total = _jax_sharded(
        lambda x, w, bias: ((z := layer(x, w, bias).jax()),
                            jax.lax.psum(jnp.sum(z), "scenario")),
        (P("scenario"), P(), P()), (P("scenario"), P()), X, W, b)
    want = np.maximum(X @ W + b, 0.0)
    np.testing.assert_allclose(got["out0"], want, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got["out0"], np.asarray(y), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(float(got["out1"]), want.sum(), rtol=1e-4)
    np.testing.assert_allclose(float(got["out1"]), float(total), rtol=1e-4)
    _counted(got, "matmul:mm_epilogue")


def test_axis_reduction_inside_shard_map(world):
    inputs, _ = world
    A = inputs["ax_a"]
    got = _part(world, "k_axis")
    rows, total = _jax_sharded(
        lambda a: ((r := jsm.array(a).sum(axis=1).jax()), jax.lax.psum(jnp.sum(r), "scenario")),
        (P("scenario"),), (P("scenario"), P()), A)
    np.testing.assert_allclose(got["out0"], A.sum(axis=1), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["out0"], np.asarray(rows), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(got["out1"]), A.sum(), rtol=1e-4)
    np.testing.assert_allclose(float(got["out1"]), float(total), rtol=1e-4)
    _counted(got, "reduce_axis:sum1")


def test_view_kernel_inside_shard_map(world):
    inputs, _ = world
    A, B = inputs["vw_a"], inputs["vw_b"]
    got = _part(world, "k_view")
    out = _jax_sharded(lambda a, b: jsm.add(jsm.Array(a).T, jsm.Array(b)).jax(),
                       (P(None, "scenario"), P("scenario")), P("scenario"), A, B)
    np.testing.assert_allclose(got["out0"], A.T + B, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got["out0"], np.asarray(out))
    _counted(got, "elementwise:add")


# ------------------------------------------------ scenario MPC (test_sqp_mpc)
def _cold_cost(x0s, us):
    system = jmodels.make_pendulum()
    return float(jnp.sum(jax.vmap(lambda x0, u: jilqr.trajectory_cost(
        system, jilqr.rollout(system.step, x0, u), u))(x0s, us)))


def _held_to_jax(got, want):
    us, du0, stats = want
    np.testing.assert_allclose(float(got["total_cost"]), float(stats["total_cost"]), rtol=1e-4)
    _scaled(got["us"], us, 1e-3, 1e-4)
    _scaled(got["du0"], du0, 1e-3, 1e-4)


def test_scenario_mpc_consensus_step(world, jax_step):
    inputs, _ = world
    got = _part(world, "mpc_step")
    us = inputs["mpc_us"]
    assert got["us"].shape == us.shape and got["du0"].shape == (1,)
    first = got["us"][:, 0, 0]
    np.testing.assert_allclose(first, first[0], rtol=1e-6)
    assert np.isfinite(float(got["total_cost"]))
    _held_to_jax(got, jax_step(inputs["mpc_x0s"], us))


def test_scenario_mpc_iterates_decrease_cost(world, jax_mesh):
    inputs, _ = world
    history = _part(world, "mpc_solve")["history"]
    x0s, us = inputs["dec_x0s"], inputs["dec_us"]
    x0_cost = _cold_cost(x0s, us)
    for earlier, later in zip(history, history[1:]):
        assert later <= earlier + 1e-5 * abs(earlier), history
    assert history[-1] < x0_cost * 0.999, (x0_cost, history)
    assert history[0] < x0_cost, (x0_cost, history)
    _, _, want = jsqp.scenario_mpc_solve(jmodels.make_pendulum(), x0s, us, jax_mesh, iterations=3)
    np.testing.assert_allclose(history, want, rtol=1e-4)


def test_scenario_mpc_linesearch_never_increases_cost(world, jax_step):
    inputs, _ = world
    got = _part(world, "mpc_adversarial")
    x0s, us = inputs["adv_x0s"], inputs["adv_us"]
    before = _cold_cost(x0s, us)
    assert float(got["total_cost"]) <= before + 1e-4 * abs(before)
    _held_to_jax(got, jax_step(x0s, us))


def test_scenario_mpc_continues_from_the_jax_warm_start(world, jax_step):
    """The solvers have no weights: their state is the warm start.  Fed the
    controls the JAX package's step returned, the port's next step is the
    JAX package's second step."""
    inputs, _ = world
    got = _part(world, "mpc_warm")
    _held_to_jax(got, jax_step(inputs["mpc_x0s"], inputs["jax_step1_us"]))


# --------------------------------------------------------------- the package
def test_parallel_exports_match_the_jax_package():
    # Each package's six submodules imported, whatever this process
    # imported before: a submodule is a name of its package once imported.
    import simplemath_tpu.parallel.scaling  # noqa: F401
    import simplemath_tpu_torch.parallel.scaling  # noqa: F401
    from simplemath_tpu_torch import models as tmodels
    from simplemath_tpu_torch import parallel as tpar

    def public(m):
        return sorted(n for n in dir(m) if not n.startswith("_"))

    assert public(tpar) == public(jpar)
    for name in ("make_scenario_mpc_step", "scenario_mpc_step", "scenario_mpc_solve"):
        assert hasattr(tmodels, name) and hasattr(jmodels, name)


def test_the_port_imports_no_jax(world):
    """A rank of the world, and a fresh process that imports the whole
    port, have no jax in ``sys.modules``; no module of the port names it."""
    _, ranks = world
    assert not any(bool(r["jax_imported"]) for r in ranks)
    code = ("import sys, pkgutil, importlib, simplemath_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, 'simplemath_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "assert 'jax' not in sys.modules and 'simplemath_tpu' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120,
                   env={**os.environ, "SM_DEVICE": "cpu"})
