"""The PSD projection (``psd="eigh"``) on the CPU: the port's plain Jacobi
projection (ops/linalg_small.py::psd_project_plain, the kernel's plain
version) against the JAX package's ``_eigh_project`` and against
``torch.linalg.eigh``'s projection, and the coupled-cost solves that take
it against the JAX package's jitted programs.

Inputs are made with numpy from a seed and fed to both packages.  The
projection onto the PSD cone is unique and 1-Lipschitz even where the
eigenvectors are not, so projections are compared, never eigenvectors,
within one bound for each matrix: ``C * n * eps_dtype * (||H||_F +
sqrt(n) * psd_eps)`` elementwise (``C = 8``; the eigensolvers' errors are
each about ``n * eps * ||H||``, and the clamp adds ``psd_eps`` on the
eigenvalues).

The coupled-cost system is the cartpole (and the quadrotor) with
``separable_cost=False`` and a stage cost that adds an x-u cross term and a
small concave term, as tests/test_complex_and_debug.py builds such systems:
some of its joint Hessian blocks are non-diagonal and indefinite, and
``psd="auto"`` takes ``"eigh"``.  The solves use the tolerances of
tests/test_torch_graphs.py: costs within ``rtol=1e-4``, controls within
``rtol=1e-3`` and 1e-4 x the largest control (closed loops ``rtol=1e-3,
atol=1e-4``).
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simplemath_tpu_torch as sm
from simplemath_tpu import models as jm
from simplemath_tpu.models import ilqr as jilqr
from simplemath_tpu.models import rti as jrti
from simplemath_tpu.models import sqp_mpc as jsqp
from simplemath_tpu.parallel import make_mesh as jmake_mesh
from simplemath_tpu.parallel import make_sharded_train_step as jmake_step
from simplemath_tpu_torch import models as tm
from simplemath_tpu_torch.models import ilqr, rti, sqp_mpc
from simplemath_tpu_torch.ops import library, linalg_small
from simplemath_tpu_torch.utils import export

from torch_world import results, run_world

C = 8.0
PSD_EPS = 1e-6
SIZES = (1, 2, 3, 4, 5, 8, 12, 16, 17, 32, 33, 64)
BATCHES = ((), (7,), (3, 4))
DTYPES = {"float32": (np.float32, torch.float32), "float64": (np.float64, torch.float64)}


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's default device is the card; these tests ask for the CPU."""
    old = sm.config.device
    sm.configure(device="cpu")
    yield
    sm.configure(device=old)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------ the oracles
_jax_project = jax.jit(jilqr._eigh_project, static_argnums=1)


def _torch_project(H, eps):
    """``torch.linalg.eigh``'s projection of the symmetric part."""
    S = (H + H.mT) * 0.5
    w, V = torch.linalg.eigh(S)
    return (V * torch.clamp_min(w, eps)[..., None, :]) @ V.mT


def _oracle(name, H):
    if name == "jax":
        return np.asarray(_jax_project(jnp.asarray(H), PSD_EPS))
    return _np(_torch_project(torch.from_numpy(H), PSD_EPS))


def _hold(got, want, H):
    """``got`` within the stated bound of ``want``, matrix by matrix."""
    n = H.shape[-1]
    fro = np.sqrt(np.sum(np.square(H.astype(np.float64)), axis=(-2, -1)))
    bound = C * n * np.finfo(H.dtype).eps * (fro + math.sqrt(n) * PSD_EPS)
    err = np.abs(got.astype(np.float64) - want.astype(np.float64)).max(axis=(-2, -1), initial=0.0)
    assert got.dtype == H.dtype and got.shape == H.shape
    assert np.all(err <= bound), f"error {err.max()} over the bound {bound.min()}"


def _random(rng, shape, dtype):
    """Non-symmetric matrices whose symmetric parts are indefinite."""
    return rng.standard_normal(shape).astype(dtype)


# ------------------------------------------------------------ projection
@pytest.mark.parametrize("oracle", ["jax", "torch"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("batch", BATCHES, ids=["scalar", "7", "3x4"])
@pytest.mark.parametrize("n", SIZES)
def test_plain_projection_matches(n, batch, dtype, oracle):
    H, got = _projected(n, batch, dtype)
    _hold(got, _oracle(oracle, H), H)


@functools.lru_cache(maxsize=None)
def _projected(n, batch, dtype):
    """(H, the port's projection of H), made once for both oracles, on one
    thread: the plain version is a chain of small ops, and torch's threads
    on each of them cost minutes where other processes hold the cores."""
    rng = np.random.default_rng(n * 31 + len(batch))
    H = _random(rng, batch + (n, n), DTYPES[dtype][0])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return H, _np(linalg_small.psd_project(torch.from_numpy(H), PSD_EPS))
    finally:
        torch.set_num_threads(threads)


def _special(name, n, rng):
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    if name == "zero":
        return np.zeros((n, n))
    if name == "identity":
        return np.eye(n)
    if name == "repeated":  # one eigenvalue three times, its eigenvectors not unique
        w = np.array([2.0, 2.0, 2.0, -1.0, 0.5])
        return (Q * w) @ Q.T
    if name == "diagonal":
        return np.diag(rng.standard_normal(n))
    if name == "all_negative":
        return (Q * -rng.uniform(0.5, 2.0, n)) @ Q.T
    if name == "psd":
        return (Q * rng.uniform(0.5, 2.0, n)) @ Q.T
    # Eigenvalues straddling the clamp: eps/2, eps, 2 eps, 0 and -eps.
    w = PSD_EPS * np.array([0.5, 1.0, 2.0, 0.0, -1.0])
    return (Q * w) @ Q.T


SPECIAL = ("zero", "identity", "repeated", "diagonal", "all_negative", "psd", "straddling_eps")


@pytest.mark.parametrize("oracle", ["jax", "torch"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("scale", [1e-6, 1.0, 1e6])
@pytest.mark.parametrize("case", SPECIAL)
def test_special_matrices_match(case, scale, dtype, oracle):
    rng = np.random.default_rng(SPECIAL.index(case))
    H = (scale * np.stack([_special(case, 5, rng) for _ in range(3)])).astype(DTYPES[dtype][0])
    got = _np(linalg_small.psd_project(torch.from_numpy(H), PSD_EPS))
    _hold(got, _oracle(oracle, H), H)


@pytest.mark.parametrize("bad", [np.nan, np.inf])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_a_non_finite_matrix_is_nan_alone(dtype, bad):
    """The JAX package gives all NaN for a matrix with a NaN (on the CPU);
    the port gives it for a NaN or an inf, and the batch's other matrices
    the values they have alone."""
    rng = np.random.default_rng(9)
    H = _random(rng, (4, 5, 5), DTYPES[dtype][0])
    H[2, 1, 3] = bad
    got = _np(linalg_small.psd_project(torch.from_numpy(H), PSD_EPS))
    assert np.isnan(got[2]).all()
    good = np.delete(H, 2, axis=0)
    alone = _np(linalg_small.psd_project(torch.from_numpy(good), PSD_EPS))
    np.testing.assert_array_equal(np.delete(got, 2, axis=0), alone)
    _hold(np.delete(got, 2, axis=0), _oracle("jax", good), good)
    if bad is np.nan:
        assert np.isnan(_oracle("jax", H)[2]).all()


def test_jax_batch_of_nan_and_diagonals():
    """A batch of ``[[1, nan], [nan, 1]]`` and ``diag(1, -1)``: all NaN and
    ``diag(1, eps)`` in both packages."""
    H = np.array([[[1.0, np.nan], [np.nan, 1.0]], [[1.0, 0.0], [0.0, -1.0]]], np.float32)
    got = _np(linalg_small.psd_project(torch.from_numpy(H), PSD_EPS))
    want = _oracle("jax", H)
    assert np.isnan(got[0]).all() and np.isnan(want[0]).all()
    np.testing.assert_array_equal(got[1], np.diag(np.float32([1.0, PSD_EPS])))
    _hold(got[1:], want[1:], H[1:])


def test_converges_within_the_cap_of_sweeps():
    """Random matrices up to n = 64 pass the convergence test before
    ``MAX_SWEEPS``, in float32 and float64."""
    rng = np.random.default_rng(2)
    for dtype in (torch.float32, torch.float64):
        for n in (5, 16, 64):
            S = torch.from_numpy(rng.standard_normal((6, n, n))).to(dtype)
            _, _, sweeps = linalg_small.jacobi_plain((S + S.mT) * 0.5)
            assert 0 < int(sweeps.max()) < linalg_small.MAX_SWEEPS


def test_schedule_pairs_every_index_once_a_sweep():
    for n in range(1, 20):
        met = [pair for r in linalg_small.rounds(n) for pair in r]
        assert sorted(met) == [(p, q) for p in range(n) for q in range(p + 1, n)]
        for r in linalg_small.rounds(n):
            flat = [i for pair in r for i in pair]
            assert len(flat) == len(set(flat))


def test_integer_matrices_raise_type_error():
    with pytest.raises(TypeError, match="float32 or float64"):
        linalg_small.psd_project(torch.zeros((3, 3), dtype=torch.int32), PSD_EPS)


def test_vmap_gives_the_batched_values():
    """The plain version under ``torch.func.vmap`` gives the batched call's
    bits (the JAX package's ``vmap(solve)`` reaches its projection so)."""
    H = torch.from_numpy(_random(np.random.default_rng(4), (6, 4, 4), np.float32))
    want = linalg_small.psd_project(H, PSD_EPS)
    assert torch.equal(torch.func.vmap(lambda h: linalg_small.psd_project(h, PSD_EPS))(H), want)


@pytest.mark.parametrize("mapped", ["dim0", "dim1", "nested", "unbatched"])
def test_op_batching_rule_gives_the_batched_values(mapped):
    """``sm::psd_project``'s batching rule (the route of a CUDA tensor under
    ``vmap``) gives the batched call's bits, whichever dim is mapped."""
    H = torch.from_numpy(_random(np.random.default_rng(7), (3, 5, 4, 4), np.float32))
    want = linalg_small.psd_project(H, PSD_EPS)

    def project(h):
        return library.psd_project(h, PSD_EPS)

    if mapped == "dim0":
        got = torch.func.vmap(project)(H)
    elif mapped == "dim1":
        got = torch.func.vmap(project, in_dims=1)(H.movedim(0, 1))
    elif mapped == "nested":
        got = torch.func.vmap(torch.func.vmap(project))(H)
    else:  # the op on an unmapped operand inside a vmap
        got = torch.func.vmap(lambda z: project(H) + z)(torch.zeros(2, 3, 5, 4, 4))[1]
    assert torch.equal(got, want)


def test_traced_projection_is_one_op():
    """``utils.export`` records the projection as one ``sm::psd_project``
    node, and the loaded artifact gives the live bits."""
    H = torch.from_numpy(_random(np.random.default_rng(5), (3, 5, 5), np.float32))
    program = export.export_program(lambda h: linalg_small.psd_project(h, PSD_EPS), H)
    assert library.sm_nodes(program.graph) == ["sm.psd_project.default"]
    loaded = export.load_step(export.export_step(lambda h: linalg_small.psd_project(h, PSD_EPS), H))
    assert torch.equal(loaded(H), linalg_small.psd_project(H, PSD_EPS))


def test_plain_reads_nothing_on_the_host():
    """The plain version under the export's guard, which raises at a host
    read (``aten._local_scalar_dense``)."""
    H = torch.from_numpy(_random(np.random.default_rng(6), (2, 6, 6), np.float64))
    with export._NoHostReads():
        got = linalg_small.psd_project_plain(H, PSD_EPS)
    assert torch.equal(got, linalg_small.psd_project(H, PSD_EPS))


# ------------------------------------------- the repaired symmetrization
def test_asymmetric_hessians_are_symmetrized_as_jax_does():
    """``jnp.linalg.eigh`` decomposes ``(H + Hᵀ)/2``; ``torch.linalg.eigh``
    would read the lower triangle alone (``[[1, 0], [0, 1]]`` here)."""
    lxx = np.array([[1.0, 2.0], [0.0, 1.0]], np.float32)
    args = (lxx[None], np.eye(1, dtype=np.float32)[None], np.zeros((1, 1, 2), np.float32), lxx)
    got = ilqr.psd_cost_hessians(*map(torch.from_numpy, args), "eigh", PSD_EPS)
    want = jax.jit(jilqr.psd_cost_hessians, static_argnums=(4, 5))(*map(jnp.asarray, args),
                                                                   "eigh", PSD_EPS)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5, atol=1e-6)
    # The joint block's lxx and the terminal Vxx_T: [[1, 1], [1, 1]] + eps.
    for g in (got[0][0], got[3]):
        np.testing.assert_allclose(_np(g), [[1.0, 1.0], [1.0, 1.0]], atol=2e-6)


# ------------------------------------------------- coupled-cost solves
# The x-u cross term and the concave term of each coupled system: the
# cartpole's on the cart's velocity (no stage cost of its own) and the
# force; the quadrotor's on the roll rate and the roll torque, the concave
# term just under the roll rate's own 0.05 x9^2, so that every (x9, u1)
# block is indefinite and the closed loops stay finite (with -0.1 x9^2 the
# RTI loop at H=50 diverges, in the JAX package too).
CROSS = {"cartpole": lambda x, u: 0.1 * x[1] * u[0],
         "quadrotor": lambda x, u: 0.05 * x[9] * u[1]}
CONCAVE = {"cartpole": lambda x: -0.01 * x[1] ** 2, "quadrotor": lambda x: -0.049 * x[9] ** 2}


def coupled(base):
    """``base`` with its ``CROSS`` and ``CONCAVE`` terms added to the stage
    cost: a coupled cost (``separable_cost=False``)."""
    def stage_cost(x, u):
        return base.stage_cost(x, u) + CROSS[base.name](x, u) + CONCAVE[base.name](x)

    return dataclasses.replace(base, name=f"{base.name}_coupled", stage_cost=stage_cost,
                               separable_cost=False)


def _systems(name):
    return coupled(tm.SYSTEMS[name]()), coupled(jm.SYSTEMS[name]())


def _hold_solve(rt, rj):
    assert np.isfinite(_np(rt.cost)).all() and np.isfinite(_np(rt.us)).all()
    np.testing.assert_allclose(_np(rt.cost), np.asarray(rj.cost), rtol=1e-4)
    scale = max(1.0, float(np.abs(np.asarray(rj.us)).max()))
    np.testing.assert_allclose(_np(rt.us), np.asarray(rj.us), rtol=1e-3, atol=1e-4 * scale)


def _cartpole_inputs(batch=4, horizon=12, seed=3):
    rng = np.random.default_rng(seed)
    return ((0.2 * rng.standard_normal((batch, 4))).astype(np.float32),
            np.zeros((batch, horizon, 1), np.float32))


def test_coupled_system_takes_eigh_and_moves_blocks():
    """The coupled cartpole's joint blocks are indefinite somewhere, and
    the projection moves them."""
    system, _ = _systems("cartpole")
    assert ilqr._psd_mode(ilqr.ILQRConfig(), system) == "eigh"
    x0, us = map(torch.from_numpy, _cartpole_inputs())
    xs = torch.func.vmap(lambda x, u: ilqr.rollout(system.step, x, u))(x0, us)
    lxx, luu, lux = ilqr.linearize_soa(system, xs, us)[4:7]
    blk = torch.cat([torch.cat([lxx, lux.mT], -1), torch.cat([lux, luu], -1)], -2)
    assert bool((torch.linalg.eigvalsh(blk).amin(-1) < 0).any())
    moved = (linalg_small.psd_project(blk, PSD_EPS) - blk).abs().amax((-2, -1)) > 1e-6
    assert 0.0 < float(moved.float().mean()) <= 1.0


def test_coupled_solve_batched_jit_matches_jax():
    system, jsystem = _systems("cartpole")
    x0, us = _cartpole_inputs()
    got = ilqr.solve_batched_jit(system, torch.from_numpy(x0), torch.from_numpy(us),
                                 ilqr.ILQRConfig(iterations=3))
    want = jilqr.solve_batched_jit(jsystem, jnp.asarray(x0), jnp.asarray(us),
                                   jilqr.ILQRConfig(iterations=3))
    _hold_solve(got, want)
    np.testing.assert_allclose(_np(got.cost_trace), np.asarray(want.cost_trace), rtol=1e-4)
    trace = _np(got.cost_trace)
    assert np.all(trace[:, 1:] <= trace[:, :-1])


def test_coupled_replan_matches_jax():
    system, jsystem = _systems("quadrotor")
    ctrl = sqp_mpc.MPCController(system, horizon=10, replan_iters=2)
    jctrl = jsqp.MPCController(jsystem, horizon=10, replan_iters=2)
    x = (0.1 * np.random.default_rng(4).standard_normal(12)).astype(np.float32)
    for _ in range(2):
        u0, cost = ctrl.replan(torch.from_numpy(x))
        ju0, jcost = jctrl.replan(jnp.asarray(x))
        assert bool(torch.isfinite(u0).all()) and bool(torch.isfinite(cost))
        np.testing.assert_allclose(_np(u0), np.asarray(ju0), rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(_np(cost), np.asarray(jcost), rtol=1e-4)
        np.testing.assert_allclose(_np(ctrl.us_warm), np.asarray(jctrl.us_warm),
                                   rtol=1e-3, atol=1e-3)
        x = _np(system.step(torch.from_numpy(x), u0))


def test_coupled_rti_closed_loop_matches_jax():
    system, jsystem = _systems("quadrotor")
    x0 = (0.1 * np.random.default_rng(6).standard_normal(12)).astype(np.float32)
    want = jax.jit(lambda x: jrti.rti_closed_loop(jsystem, x, 10, 6))(jnp.asarray(x0))
    got = rti.rti_closed_loop(system, torch.from_numpy(x0), 10, 6)
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-3, atol=1e-4)


def test_coupled_export_solver_step_serves_the_live_bits():
    """``export_solver_step`` of the coupled cartpole traces under the
    export's host-read guard; the iteration holds ``sm::psd_project``
    twice (the joint blocks and the terminal Hessian), and the loaded
    solver gives ``solve_batched_jit``'s bits, and the JAX package's
    values."""
    system, jsystem = _systems("cartpole")
    cfg = ilqr.ILQRConfig(iterations=2)
    blob = export.export_solver_step(system, cfg, batch=4, horizon=6, platforms=("cpu",))
    served = export.load_step(blob)
    ops = [n.target for m in served.iteration.modules() if isinstance(m, torch.fx.GraphModule)
           for n in m.graph.nodes if n.op == "call_function"]
    assert sum(str(t).startswith("sm.psd_project") for t in ops) == 2
    x0, us = _cartpole_inputs(4, 6)
    us_got, cost_got = served(torch.from_numpy(x0), torch.from_numpy(us))
    live = ilqr.solve_batched_jit(system, torch.from_numpy(x0), torch.from_numpy(us), cfg)
    assert torch.equal(us_got, live.us) and torch.equal(cost_got, live.cost)
    want = jilqr.solve_batched_jit(jsystem, jnp.asarray(x0), jnp.asarray(us),
                                   jilqr.ILQRConfig(iterations=2))
    _hold_solve(live, want)


# ------------------------------- the sharded and scenario programs (gloo)
N, BATCH, HORIZON, ITERS = 2, 8, 8, 2

_WORLD = """
import dataclasses
import torch
from simplemath_tpu_torch import parallel
from simplemath_tpu_torch.models import ILQRConfig, make_cartpole, make_quadrotor, sqp_mpc

T = {k: torch.from_numpy(v) for k, v in INPUTS.items()}
mesh = parallel.make_mesh()
CROSS = {"cartpole": lambda x, u: 0.1 * x[1] * u[0],
         "quadrotor": lambda x, u: 0.05 * x[9] * u[1]}
CONCAVE = {"cartpole": lambda x: -0.01 * x[1] ** 2, "quadrotor": lambda x: -0.049 * x[9] ** 2}


def coupled(base):
    def stage_cost(x, u):
        return base.stage_cost(x, u) + CROSS[base.name](x, u) + CONCAVE[base.name](x)

    return dataclasses.replace(base, name=f"{base.name}_coupled", stage_cost=stage_cost,
                               separable_cost=False)


@part("step")
def _():
    step = parallel.make_sharded_train_step(coupled(make_cartpole()), mesh,
                                            ILQRConfig(iterations=ITERS), "scenario")
    res, stats = step(T["cartpole_x0"], T["cartpole_us"])
    return {**res._asdict(), **stats}


@part("scenario")
def _():
    us, du0, history = sqp_mpc.scenario_mpc_solve(
        coupled(make_quadrotor()), T["quadrotor_x0"], T["quadrotor_us"], mesh, iterations=ITERS)
    return {"us": us, "du0": du0, "history": torch.tensor(history, dtype=torch.float64)}
"""


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(16)
    inputs = {"cartpole_x0": (0.2 * rng.standard_normal((BATCH, 4))).astype(np.float32),
              "cartpole_us": np.zeros((BATCH, HORIZON, 1), np.float32),
              "quadrotor_x0": (0.1 * rng.standard_normal((BATCH, 12))).astype(np.float32),
              "quadrotor_us": np.zeros((BATCH, HORIZON, 4), np.float32)}
    return inputs, run_world(N, f"ITERS = {ITERS}\n" + _WORLD, inputs, timeout=600)


def _part(world, name):
    _, ranks = world
    got = results(ranks, name, 0)
    for k, v in results(ranks, name, 1).items():
        np.testing.assert_array_equal(v, got[k], err_msg=f"rank 1, {name}:{k}")
    return got


@pytest.fixture(scope="module")
def jax_mesh():
    if len(jax.devices()) < N:
        pytest.skip("needs multiple (virtual) devices")
    return jmake_mesh((N,), ("scenario",), devices=jax.devices()[:N])


def test_coupled_sharded_train_step_matches_jax(world, jax_mesh):
    inputs, _ = world
    got = _part(world, "step")
    _, jsystem = _systems("cartpole")
    step = jmake_step(jsystem, jax_mesh, jm.ILQRConfig(iterations=ITERS), "scenario")
    res, stats = step(jnp.asarray(inputs["cartpole_x0"]), jnp.asarray(inputs["cartpole_us"]))
    assert np.isfinite(got["cost"]).all() and np.isfinite(got["us"]).all()
    np.testing.assert_allclose(got["cost"], np.asarray(res.cost), rtol=1e-4)
    np.testing.assert_allclose(got["cost_trace"], np.asarray(res.cost_trace), rtol=1e-4)
    scale = max(1.0, float(np.abs(np.asarray(res.us)).max()))
    np.testing.assert_allclose(got["us"], np.asarray(res.us), rtol=1e-3, atol=1e-4 * scale)
    np.testing.assert_allclose(float(got["total_cost"]), float(stats["total_cost"]), rtol=1e-4)


def test_coupled_scenario_mpc_solve_matches_jax(world, jax_mesh):
    """The consensus step projects no Hessian, in either package."""
    inputs, _ = world
    got = _part(world, "scenario")
    _, jsystem = _systems("quadrotor")
    us, du0, history = jsqp.scenario_mpc_solve(jsystem, inputs["quadrotor_x0"],
                                               inputs["quadrotor_us"], jax_mesh, iterations=ITERS)
    assert np.isfinite(got["history"]).all() and np.all(np.diff(got["history"]) <= 0)
    np.testing.assert_allclose(got["history"], history, rtol=1e-4)
    for g, w in ((got["us"], us), (got["du0"], du0)):
        scale = max(1.0, float(np.abs(np.asarray(w)).max()))
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-3, atol=1e-4 * scale)
