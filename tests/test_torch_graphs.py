"""The compiled entry points (utils/graphs.py) on the CPU: each against the
JAX package's compiled counterpart, and the capture layer's logic through a
stand-in for ``torch.cuda.CUDAGraph``.

The entry points run their eager body loop on the CPU, as JAX's ``jit``
does there.  Against JAX, with the same numpy inputs and the tolerances of
the tests of each module: a batched solve's costs within ``rtol=1e-4`` and
its controls within ``rtol=1e-3`` and 1e-4 x the largest control
(test_torch_models.py); closed-loop states, controls and costs within
``rtol=1e-3, atol=1e-4`` (test_torch_simulate.py, test_torch_rti.py); a
controller's warm start within ``rtol=1e-3, atol=1e-3``
(test_torch_sqp_mpc.py); ``entry()``'s costs within ``rtol=1e-4``
(test_torch_numerical_parity.py).

The stand-in (tests/torch_standin.py) records the ATen ops that run
between ``capture_begin`` and ``capture_end`` and re-runs them at
``replay``: what a CUDA graph does with its kernels and their addresses.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree

import __graft_entry__ as graft
import torch_standin
from torch_standin import StandInGraph, eager_reference
import simplemath_tpu_torch as sm
from simplemath_tpu import models as jm
from simplemath_tpu.models import ilqr as jilqr
from simplemath_tpu.models import rti as jrti
from simplemath_tpu.models import simulate as jsim
from simplemath_tpu.models import sqp_mpc as jsqp
from simplemath_tpu_torch import entry as tentry
from simplemath_tpu_torch import models as tm
from simplemath_tpu_torch.models import dynamics, ilqr, rti, simulate, sqp_mpc
from simplemath_tpu_torch.models.sqp_mpc import MPCController
from simplemath_tpu_torch.ops import codegen
from simplemath_tpu_torch.utils import graphs


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's default device is the card; these tests ask for the CPU."""
    old = sm.config.device
    sm.configure(device="cpu")
    yield
    sm.configure(device=old)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _leaves(tree):
    return [t for t in _pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _bits_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y) for x, y in zip(la, lb))


def _hold_solve(rt, rj):
    np.testing.assert_allclose(_np(rt.cost), np.asarray(rj.cost), rtol=1e-4)
    scale = max(1.0, float(np.abs(np.asarray(rj.us)).max()))
    np.testing.assert_allclose(_np(rt.us), np.asarray(rj.us), rtol=1e-3, atol=1e-4 * scale)


# ------------------------------------------------------------- against JAX
@pytest.mark.parametrize("name", ["cartpole", "sm_pendulum"])
def test_solve_batched_jit_matches_jax(name):
    """The sm-written pendulum is held to the JAX package's pendulum: the
    two are the same system (test_torch_models.py holds the sm pendulum to
    the native one)."""
    rng = np.random.default_rng(3)
    system = tm.make_sm_pendulum() if name == "sm_pendulum" else tm.SYSTEMS[name]()
    jsystem = jm.make_pendulum() if name == "sm_pendulum" else jm.SYSTEMS[name]()
    x0 = (0.2 * rng.standard_normal((4, system.nx))).astype(np.float32)
    us = np.zeros((4, 12, system.nu), np.float32)
    got = ilqr.solve_batched_jit(system, torch.from_numpy(x0), torch.from_numpy(us),
                                 ilqr.ILQRConfig(iterations=3))
    want = jilqr.solve_batched_jit(jsystem, jnp.asarray(x0), jnp.asarray(us),
                                   jilqr.ILQRConfig(iterations=3))
    _hold_solve(got, want)
    np.testing.assert_allclose(_np(got.cost_trace), np.asarray(want.cost_trace), rtol=1e-4)
    assert got.cost_trace.shape == want.cost_trace.shape == (4, 3)
    assert got.grad_norm.shape == want.grad_norm.shape == (4,)


def test_replan_three_calls_match_jax():
    system, jsystem = tm.make_quadrotor(), jm.make_quadrotor()
    ctrl = MPCController(system, horizon=12, replan_iters=2, u_min=-3.0, u_max=3.0)
    jctrl = jsqp.MPCController(jsystem, horizon=12, replan_iters=2, u_min=-3.0, u_max=3.0)
    x = (0.1 * np.random.default_rng(4).standard_normal(12)).astype(np.float32)
    for _ in range(3):
        u0, cost = ctrl.replan(torch.from_numpy(x))
        ju0, jcost = jctrl.replan(jnp.asarray(x))
        np.testing.assert_allclose(_np(u0), np.asarray(ju0), rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(_np(cost), np.asarray(jcost), rtol=1e-4)
        np.testing.assert_allclose(_np(ctrl.us_warm), np.asarray(jctrl.us_warm),
                                   rtol=1e-3, atol=1e-3)
        x = _np(system.step(torch.from_numpy(x), u0))


def test_closed_loop_with_noise_matches_jax(monkeypatch):
    """Both packages draw their noise from their own generators; the port is
    handed the JAX package's normals in place of its draw."""
    system, jsystem = tm.make_pendulum(), jm.make_pendulum()
    x0 = np.array([np.pi - 0.3, 0.0], np.float32)
    kw = dict(horizon=12, ticks=8, u_min=-4.0, u_max=4.0, noise_std=0.02)
    key = jax.random.PRNGKey(5)
    normals = np.asarray(jax.random.normal(key, (kw["ticks"], 2), dtype=jnp.float32))
    want = jax.jit(lambda x: jsim.closed_loop(jsystem, x, key=key, **kw))(jnp.asarray(x0))
    monkeypatch.setattr(torch, "randn", lambda *a, **k: torch.from_numpy(normals.copy()))
    got = simulate.closed_loop(system, torch.from_numpy(x0), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-3, atol=1e-4)
    assert not np.array_equal(_np(got.xs),
                              _np(simulate.closed_loop(system, torch.from_numpy(x0),
                                                       **{**kw, "noise_std": 0.0}).xs))


def test_rti_closed_loop_matches_jax():
    system, jsystem = tm.make_quadrotor(), jm.make_quadrotor()
    x0 = (0.1 * np.random.default_rng(6).standard_normal(12)).astype(np.float32)
    want = jax.jit(lambda x: jrti.rti_closed_loop(jsystem, x, 12, 10))(jnp.asarray(x0))
    got = rti.rti_closed_loop(system, torch.from_numpy(x0), 12, 10)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-3, atol=1e-4)


def test_entry_step_matches_jax_jit():
    step, args = tentry.entry()
    jstep, jargs = graft.entry()
    np.testing.assert_allclose(_np(step(*args)), np.asarray(jax.jit(jstep)(*jargs)), rtol=1e-4)


# --------------------------------------------------- the capture stand-in
_PROGRAMS = (ilqr._BATCHED_INIT, ilqr._BATCHED_ITERATIONS, simulate._TICKS, rti._TICKS,
             sqp_mpc._REPLAN)


@pytest.fixture
def standin(monkeypatch):
    """Entry points on CPU tensors captured into the stand-in."""
    for obj, name, value in torch_standin.patches():
        monkeypatch.setattr(obj, name, value)
    monkeypatch.setattr(StandInGraph, "captures", 0)
    for p in _PROGRAMS:
        p.entries.clear()
    yield StandInGraph
    for p in _PROGRAMS:
        p.entries.clear()


def _cartpole_inputs(batch=3, horizon=8, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    x0 = torch.from_numpy((0.2 * rng.standard_normal((batch, 4))).astype(np.float32))
    return x0.to(dtype), torch.zeros((batch, horizon, 1), dtype=dtype)


def _quad_x(seed=1):
    return torch.from_numpy((0.1 * np.random.default_rng(seed).standard_normal(12)).astype(np.float32))


def _solve(system):
    x0, us = _cartpole_inputs()
    if system.nx != 4:
        x0 = x0[:, :system.nx].contiguous()
    return lambda: ilqr.solve_batched_jit(system, x0, us, ilqr.ILQRConfig(iterations=3))


def _replans(system_factory, **kw):
    def run():
        ctrl = MPCController(system_factory(), horizon=8, replan_iters=2, **kw)
        outs = [ctrl.replan(_quad_x(seed)) for seed in range(3)]
        return outs, ctrl.us_warm.clone()
    return run


_WORKLOADS = {
    "solve_batched_jit-cartpole": lambda: _solve(tm.make_cartpole()),
    "solve_batched_jit-sm_pendulum": lambda: _solve(tm.make_sm_pendulum()),
    "replan": lambda: _replans(tm.make_quadrotor, u_min=-2.0, u_max=2.0),
    "closed_loop": lambda: (lambda: simulate.closed_loop(
        tm.make_pendulum(), torch.tensor([3.0, 0.0]), 8, 5, noise_std=0.01, u_min=-4.0,
        u_max=4.0, generator=torch.Generator().manual_seed(2))),
    "rti_closed_loop": lambda: (lambda: rti.rti_closed_loop(tm.make_quadrotor(), _quad_x(), 8, 6)),
    "entry": lambda: (lambda: (lambda step, args: step(*args))(*tentry.entry())),
}


@pytest.mark.parametrize("name", list(_WORKLOADS))
def test_captured_body_loop_gives_eager_bits(standin, name):
    run = _WORKLOADS[name]()
    with eager_reference():
        want = run()
    got = run()
    assert standin.captures > 0
    assert _bits_equal(got, want)
    again = run()  # replays of the cached graphs alone
    assert _bits_equal(again, want)


def test_scan_replays_the_body_once_a_step(standin):
    run = _solve(tm.make_cartpole())
    run()
    (entry,) = ilqr._BATCHED_ITERATIONS.cached()
    (init,) = ilqr._BATCHED_INIT.cached()
    assert standin.captures == 2  # the initial rollout and one iteration
    assert entry.graph.graph.replays == 3 and init.graph.graph.replays == 1
    assert entry.slots[0].shape == (3, 3)  # (iterations, batch) of costs
    run()
    assert standin.captures == 2 and entry.graph.graph.replays == 6


def test_second_call_leaves_first_results(standin):
    system = tm.make_cartpole()
    cfg = ilqr.ILQRConfig(iterations=2)
    first = ilqr.solve_batched_jit(system, *_cartpole_inputs(seed=0), cfg)
    kept = _pytree.tree_map_only(torch.Tensor, torch.clone, first)
    second = ilqr.solve_batched_jit(system, *_cartpole_inputs(seed=1), cfg)
    assert standin.captures == 2
    assert _bits_equal(first, kept)
    assert not torch.equal(first.xs, second.xs)
    leaves = _leaves(first) + _leaves(second)
    ptrs = [t.untyped_storage().data_ptr() for t in leaves]
    assert len(set(ptrs)) == len(ptrs), "results alias each other or the static tensors"

    ctrl = MPCController(tm.make_quadrotor(), horizon=6)
    u_a, _ = ctrl.replan(_quad_x(1))
    kept = u_a.clone()
    ctrl.replan(_quad_x(2))
    assert torch.equal(u_a, kept)


def test_cache_key_separates_systems_configs_shapes_dtypes(standin):
    iterations = ilqr._BATCHED_ITERATIONS
    a, b = tm.make_cartpole(), tm.make_cartpole()
    cfg = ilqr.ILQRConfig(iterations=2)
    calls = [
        (a, _cartpole_inputs(), cfg),
        (a, _cartpole_inputs(seed=5), cfg),                         # same key: a replay
        (b, _cartpole_inputs(), cfg),                               # another system
        (a, _cartpole_inputs(), ilqr.ILQRConfig(iterations=2, reg_init=1e-5)),  # config
        (a, _cartpole_inputs(), ilqr.ILQRConfig(iterations=3)),     # length
        (a, _cartpole_inputs(batch=4), cfg),                        # shape
        (a, _cartpole_inputs(dtype=torch.float64), cfg),            # dtype
    ]
    counts = []
    for system, inputs, config in calls:
        ilqr.solve_batched_jit(system, *inputs, config)
        counts.append(len(iterations.cached()))
    assert counts == [1, 1, 2, 3, 4, 5, 6]
    with eager_reference():
        want = ilqr.solve_batched(a, *_cartpole_inputs(dtype=torch.float64), cfg)
    got = ilqr.solve_batched_jit(a, *_cartpole_inputs(dtype=torch.float64), cfg)
    assert got.xs.dtype == torch.float64 and _bits_equal(got, want)
    assert len(iterations.cached()) == 6


def test_capture_error_raises_and_is_not_cached(standin, monkeypatch):
    monkeypatch.setattr(StandInGraph, "fail_at_capture_end", True)
    run = _solve(tm.make_cartpole())
    with pytest.raises(RuntimeError, match="stand-in capture failed"):
        run()
    assert not ilqr._BATCHED_INIT.cached() and not graphs._capturing and not graphs.building()
    monkeypatch.setattr(StandInGraph, "fail_at_capture_end", False)
    with eager_reference():
        want = run()
    assert _bits_equal(run(), want)


def test_body_error_during_capture_raises(standin):
    calls = []

    def body(static, carry, x_t, consts):
        calls.append(graphs.capturing())
        if graphs.capturing():
            raise ValueError("refused inside the capture")
        return (carry[0] + 1,), (carry[0],)

    scan = graphs.Scan(body)
    with pytest.raises(ValueError, match="refused inside"):
        scan((), (torch.zeros(2),), 3)
    assert calls == [False, True] and not scan.cached() and not graphs.capturing()


def test_no_cycle_collection_during_capture(standin):
    """The cycle collector runs before a capture and not during it: a
    graph it frees would be destroyed inside the capture, which global
    capture mode refuses."""
    import gc

    seen = []

    def body(static, carry, x_t, consts):
        seen.append((graphs.capturing(), gc.isenabled()))
        return (carry[0] + 1,), (carry[0],)

    assert gc.isenabled()
    graphs.Scan(body)((), (torch.zeros(2),), 2)
    assert seen == [(False, True), (True, False)] and gc.isenabled()


def test_host_read_during_capture_raises(standin):
    scan = graphs.Scan(lambda s, c, x, k: ((c[0] * float(c[0].sum()),), (c[0],)))
    with pytest.raises(RuntimeError, match="read on the host during capture"):
        scan((), (torch.ones(2),), 2)


def test_linalg_solve_check_during_capture_raises(standin):
    """``torch.linalg.solve`` reads its info on the host, which a capture
    refuses; ``solve_ex(check_errors=False)``, the consensus step's solve,
    is the same kernel without the read and replays with its bits."""
    A = torch.tensor([[4.0, 1.0], [1.0, 3.0]])
    b = torch.tensor([1.0, 2.0])
    with pytest.raises(RuntimeError, match="read on the host during capture"):
        graphs.Jit(lambda s, a, v: torch.linalg.solve(a, v))((), A, b)
    program = graphs.Jit(lambda s, a, v: torch.linalg.solve_ex(a, v, check_errors=False)[0])
    program((), A, b)
    got = program((), 2.0 * A, b)
    (entry,) = program.cached()
    assert entry.graph.graph.replays == 2 and torch.equal(got, torch.linalg.solve(2.0 * A, b))


def test_scan_steps_read_xs_rows_and_consts(standin):
    def body(static, carry, x_t, consts):
        (acc,), (x,), (w,) = carry, x_t, consts
        acc = acc * static + x * w
        return (acc,), (acc, x)

    xs = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    w = torch.tensor([1.0, -1.0, 0.5])
    scan = graphs.Scan(body)
    with eager_reference():
        want = scan(2.0, (torch.ones(3),), 4, xs=(xs,), consts=(w,))
    got = scan(2.0, (torch.ones(3),), 4, xs=(xs,), consts=(w,))
    assert len(scan.cached()) == 1 and _bits_equal(got, want)
    assert torch.equal(got[1][1], xs)
    with pytest.raises(ValueError, match="at least one step"):
        scan(2.0, (torch.ones(3),), 0)


def test_replan_build_keeps_the_warm_start(standin):
    """The warm-up and the capture each run the replan once, on the graph's
    copy of the warm start (an input, as in ``jax.jit(_replan)``); the
    controller's is as it was before them, so the first replay is the first
    replan.  Controllers of one system and config share the graph."""
    run = _replans(tm.make_quadrotor)
    with eager_reference():
        want = run()
    assert _bits_equal(run(), want)
    quad = tm.make_quadrotor()
    for _ in range(2):
        MPCController(quad, horizon=8).replan(_quad_x())
    assert len(sqp_mpc._REPLAN.entries[quad]) == 1
    ctrl = MPCController(tm.make_quadrotor(), horizon=8)
    ctrl.replan(_quad_x())
    warm = ctrl.us_warm
    assert bool(warm.abs().sum() > 0)
    ctrl.reset()
    assert ctrl.us_warm is warm and not bool(warm.abs().sum() > 0)
    with eager_reference():
        fresh = MPCController(tm.make_quadrotor(), horizon=8)
        want = fresh.replan(_quad_x())
    assert _bits_equal(ctrl.replan(_quad_x()), want)


def test_eager_context_and_the_cpu_capture_nothing(standin, monkeypatch):
    run = _solve(tm.make_cartpole())
    with graphs.eager():
        run()
    assert standin.captures == 0 and not ilqr._BATCHED_INIT.cached()
    monkeypatch.undo()
    assert graphs.captures(torch.device("cpu")) is False
    assert graphs.captures(torch.device("cuda")) is True
    with graphs.eager():
        assert graphs.captures(torch.device("cuda")) is False


def test_constant_miss_during_capture_raises(standin):
    fresh = iter(range(1000, 2000))

    def body(static, carry, x_t, consts):
        c = dynamics._constant((float(next(fresh)),), torch.float32, carry[0].device)
        return (carry[0] + c,), (carry[0],)

    with pytest.raises(graphs.CaptureError, match=r"constant \(1001\.0,\)"):
        graphs.Scan(body)((), (torch.zeros(1),), 2)
    # A constant the warm-up made is a hit during capture.
    scan = graphs.Scan(lambda s, c, x, k: ((c[0] + dynamics._constant((7.0,), torch.float32,
                                                                      c[0].device),), (c[0],)))
    assert torch.equal(scan((), (torch.zeros(1),), 2)[0][0], torch.tensor([14.0]))


def test_nvrtc_compile_during_capture_raises(monkeypatch):
    """A signature not loaded yet raises before NVRTC or the runtime is
    asked for anything (``lib`` is None here); a loaded one is a hit."""
    sig = codegen.Signature(insts=((0, 1, 0, -1, -1),), rounds=(False,), operands=(0,),
                            n_consts=0, result=1, carry=-1, iterated=False, rank=1,
                            out_dtype=0, narrow=True)
    monkeypatch.setattr(graphs, "_capturing", True)
    monkeypatch.setattr(codegen, "STATS", dict.fromkeys(codegen.STATS, 0))
    with pytest.raises(graphs.CaptureError, match="generated kernel"):
        codegen.kernel(None, sig)
    assert sig not in codegen._LOADED
    monkeypatch.setitem(codegen._LOADED, sig, (1, 2))
    assert codegen.kernel(None, sig) == 2


def _coupled_quadrotor():
    """The quadrotor with a cost that couples its roll rate and roll torque
    (``separable_cost=False``, tests/test_torch_psd.py): ``psd="auto"``
    takes ``"eigh"``."""
    base = tm.make_quadrotor()

    def stage_cost(x, u):
        return base.stage_cost(x, u) + 0.05 * x[9] * u[1] - 0.049 * x[9] ** 2

    return dataclasses.replace(base, stage_cost=stage_cost, separable_cost=False)


def _solve_eigh():
    x0, us = _cartpole_inputs()
    return lambda: ilqr.solve_batched_jit(tm.make_cartpole(), x0, us,
                                          ilqr.ILQRConfig(iterations=2, psd="eigh"))


_EIGH = {"solve_batched_jit": _solve_eigh, "replan": lambda: _replans(_coupled_quadrotor)}


@pytest.mark.parametrize("name", list(_EIGH))
def test_eigh_captured_gives_eager_bits(standin, name):
    """``psd="eigh"`` captures (its Jacobi projection reads nothing on the
    host) and the replays give the eager loop's bits."""
    run = _EIGH[name]()
    with eager_reference():
        want = run()
    got = run()
    assert standin.captures > 0
    assert _bits_equal(got, want) and _bits_equal(run(), want)


def _signature(result=1):
    return codegen.Signature(insts=((0, result, 0, -1, -1),), rounds=(False,), operands=(0,),
                             n_consts=0, result=result, carry=-1, iterated=False, rank=1,
                             out_dtype=0, narrow=True)


class _FakeRuntime:
    """``ops.codegen``'s kernel library, as far as eviction asks it."""

    def __init__(self):
        self.unloaded = []

    def sm_rtc_unload(self, library):
        self.unloaded.append(library)


def test_graph_holds_what_the_caches_evict(standin, monkeypatch):
    """A graph keeps the constants and the generated kernels' modules it
    read during its build: evicting both caches between capture and replay
    frees and unloads none of them, and the replay gives the eager bits.
    Once the graph goes, the next eviction unloads its module."""
    used, other = _signature(1), _signature(2)
    runtime = _FakeRuntime()
    monkeypatch.setattr(codegen, "_LOADED", {used: (11, 12), other: (21, 22)})
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    value = (4242.5, -1.25)

    def body(static, carry, x_t, consts):
        assert codegen.kernel(runtime, used) == 12
        c = dynamics._constant(value, torch.float32, carry[0].device)
        return (carry[0] * 0.5 + c,), (carry[0],)

    scan = graphs.Scan(body)
    with eager_reference():
        want = scan((), (torch.ones(2),), 3)
    got = scan((), (torch.ones(2),), 3)
    (entry,) = scan.cached()
    held = dynamics._constant(value, torch.float32, torch.device("cpu"))
    assert any(h is held for h in entry.graph.held) and used in codegen._PINS
    assert other not in codegen._PINS and _bits_equal(got, want)

    dynamics._cached_constant.cache_clear()
    codegen._evict(runtime)
    assert runtime.unloaded == [21] and set(codegen._LOADED) == {used}
    assert dynamics._constant(value, torch.float32, torch.device("cpu")) is not held
    assert _bits_equal(scan((), (torch.ones(2),), 3), want)
    assert standin.captures == 1

    del entry, scan
    import gc

    gc.collect()
    assert used not in codegen._PINS
    codegen._evict(runtime)
    assert runtime.unloaded == [21, 11] and not codegen._LOADED


def test_a_dropped_system_frees_its_graphs(standin):
    """Entries are held per system, weakly: dropping the system drops its
    graphs (and on the card their pools); another system's stay."""
    import gc
    import weakref

    kept, dropped = tm.make_cartpole(), tm.make_cartpole()
    cfg = ilqr.ILQRConfig(iterations=2)
    for system in (kept, dropped):
        ilqr.solve_batched_jit(system, *_cartpole_inputs(), cfg)
    programs = (ilqr._BATCHED_INIT, ilqr._BATCHED_ITERATIONS)
    assert [len(p.entries) for p in programs] == [2, 2]
    graph = weakref.ref(ilqr._BATCHED_ITERATIONS.entries[dropped][next(iter(
        ilqr._BATCHED_ITERATIONS.entries[dropped]))].graph)
    del system, dropped
    gc.collect()
    assert [len(p.entries) for p in programs] == [1, 1] and graph() is None
    assert [list(p.entries) for p in programs] == [[kept], [kept]]
    with eager_reference():
        want = ilqr.solve_batched(kept, *_cartpole_inputs(), cfg)
    assert _bits_equal(ilqr.solve_batched_jit(kept, *_cartpole_inputs(), cfg), want)
    assert standin.captures == 4


def test_entry_calls_share_one_system(standin):
    """``entry()`` builds its cartpole once, so a second ``entry()`` replays
    the first one's graphs and captures none."""
    (lambda step, args: step(*args))(*tentry.entry())
    captured = standin.captures
    (lambda step, args: step(*args))(*tentry.entry())
    assert standin.captures == captured == 2
