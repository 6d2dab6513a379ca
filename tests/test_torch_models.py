"""The port's solver layer (simplemath_tpu_torch.models) against the JAX
package: the four systems, rollouts, both backward passes, single and
batched iLQR, the ``sm``-expressed dynamics under ``torch.func``, the
associative scan, and the four places where torch does not behave like
jnp.  Twins of tests/test_models.py at small sizes; the same float32 numpy
inputs go through both packages on the CPU.

Tolerances: the JAX suite's own where one package is held to itself
(``rtol=1e-4, atol=1e-5`` on gains, ``rtol=1e-4`` on the sm-vs-native
cost).  JAX against the port: one-step values within ``rtol=1e-5,
atol=1e-6`` (the two libraries' ``sin``/``cos`` differ by an ulp); a solve's
cost within ``rtol=1e-4`` and its controls within ``rtol=1e-3, atol=1e-4``
(the sm-vs-native tolerance of test_models.py), the absolute part scaled
by the largest control of the sequence: the rounding of a Riccati pass
scales with the trajectory, and a control near zero inherits the absolute
error of the largest ones (a 20-iteration swing-up with controls up to 29
differs by 1.5e-4 on a control of 0.04).  Over several iterations the ulps
of the first step reach the line search, whose choice is then compared
through the cost.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simplemath_tpu_torch as sm
from simplemath_tpu import models as jm
from simplemath_tpu.models import ilqr as jilqr
from simplemath_tpu_torch import models as tm
from simplemath_tpu_torch.models import ilqr as tilqr
from simplemath_tpu_torch.models.scan import associative_scan
from simplemath_tpu_torch.ops import dispatch


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's default device is the card; these tests ask for the CPU."""
    old = sm.config.device
    sm.configure(device="cpu")
    yield
    sm.configure(device=old)


SYSTEMS = ["pendulum", "cartpole", "quadrotor", "bicycle"]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _both(x):
    """The same numpy values as a jax array and as a torch tensor."""
    x = np.ascontiguousarray(x)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _close(port, ref, rtol, atol=0.0):
    np.testing.assert_allclose(_np(port), _np(ref), rtol=rtol, atol=atol)


def _solve_both(name, x0, us, **cfg):
    """(jax result, port result) of one single-scenario solve."""
    jx, tx = _both(x0)
    ju, tu = _both(us)
    rj = _jax_solve(jm.SYSTEMS[name](), jx, ju, **cfg)
    rt = tilqr.solve(tm.SYSTEMS[name](), tx, tu, tilqr.ILQRConfig(**cfg))
    return rj, rt


def _jax_solve(system, x0, us, **cfg):
    """The JAX package's solve, jitted (its eager ops would each compile)."""
    return jax.jit(lambda x, u: jilqr.solve(system, x, u, jilqr.ILQRConfig(**cfg)))(x0, us)


def _hold(rt, rj):
    """A solve of the port against the JAX package's (see the module doc)."""
    _close(rt.cost, rj.cost, 1e-4)
    _close(rt.us, rj.us, 1e-3, 1e-4 * max(1.0, float(np.abs(_np(rj.us)).max())))


# --------------------------------------------------------------- systems
@pytest.mark.parametrize("name", SYSTEMS)
@pytest.mark.parametrize("batch", [(), (3, 5)], ids=["point", "trailing"])
def test_system_matches_jax(name, batch):
    """step, stage_cost and final_cost of each system at seeded states,
    unbatched and with trailing batch axes: the systems' constants are
    their weights, and this holds them equal."""
    js, ts = jm.SYSTEMS[name](), tm.SYSTEMS[name]()
    assert (ts.nx, ts.nu, ts.dt, ts.separable_cost, ts.batch_polymorphic) == (
        js.nx, js.nu, js.dt, js.separable_cost, js.batch_polymorphic)
    rng = np.random.default_rng(11)
    jx, tx = _both((0.4 * rng.standard_normal((js.nx,) + batch)).astype(np.float32))
    ju, tu = _both((0.4 * rng.standard_normal((js.nu,) + batch)).astype(np.float32))
    for got, want in ((ts.step(tx, tu), js.step(jx, ju)),
                      (ts.stage_cost(tx, tu), js.stage_cost(jx, ju)),
                      (ts.final_cost(tx), js.final_cost(jx))):
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        _close(got, want, 1e-5, 1e-6)


def test_rollout_shapes():
    system = tm.make_pendulum()
    jx, tx = _both(np.array([0.1, 0.0], np.float32))
    ju, tu = _both(np.zeros((50, 1), np.float32))
    xs = tilqr.rollout(system.step, tx, tu)
    assert xs.shape == (51, 2)
    assert np.allclose(_np(xs[0]), [0.1, 0.0])
    _close(xs, jilqr.rollout(jm.make_pendulum().step, jx, ju), 1e-5, 1e-6)


def test_pendulum_swingup_converges():
    x0, us = np.zeros(2, np.float32), np.zeros((30, 1), np.float32)
    rj, rt = _solve_both("pendulum", x0, us, iterations=20)
    system = tm.make_pendulum()
    tx, tu = torch.from_numpy(x0), torch.from_numpy(us)
    init = tilqr.trajectory_cost(system, tilqr.rollout(system.step, tx, tu), tu)
    assert float(rt.cost) < float(init)
    assert abs(float(rt.xs[-1, 0]) - np.pi) < 0.2
    assert abs(float(rt.xs[-1, 1])) < 0.5
    _hold(rt, rj)


def test_cost_trace_monotone():
    rj, rt = _solve_both("pendulum", np.array([0.3, 0.0], np.float32),
                         np.zeros((30, 1), np.float32), iterations=10)
    trace = _np(rt.cost_trace)
    assert trace.shape == (10,)
    assert np.all(np.diff(trace) <= 1e-5)
    _close(trace, rj.cost_trace, 1e-4)


def _random_lqr(seed, nx, nu):
    """A random linear system with quadratic costs, as a (jax, port) pair
    built from the same numpy matrices."""
    rng = np.random.default_rng(seed)
    A = (np.eye(nx) + 0.1 * rng.standard_normal((nx, nx))).astype(np.float32)
    B = (0.1 * rng.standard_normal((nx, nu))).astype(np.float32)
    Qh = rng.standard_normal((nx, nx)).astype(np.float32)
    Q = (Qh @ Qh.T * 0.1 + np.eye(nx)).astype(np.float32)
    R = (np.eye(nu) * 0.5).astype(np.float32)

    def make(lib, mats, system_cls):
        A, B, Q, R = mats
        return system_cls(
            "lqr", nx, nu, 1.0,
            lambda x, u: A @ x + B @ u,
            lambda x, u: 0.5 * (x @ Q @ x + u @ R @ u),
            lambda x: 0.5 * (x @ Q @ x) * 10.0,
        )

    mats = (A, B, Q, R)
    return (make(jnp, [jnp.asarray(m) for m in mats], jm.System),
            make(torch, [torch.from_numpy(m) for m in mats], tm.System))


def test_ilqr_solves_lqr_exactly_one_iteration():
    js, ts = _random_lqr(0, 4, 2)
    jx, tx = _both(np.random.default_rng(1).standard_normal(4).astype(np.float32))
    ju, tu = _both(np.zeros((20, 2), np.float32))
    out = {}
    for it in (1, 3):
        kw = dict(iterations=it, alphas=(1.0,), reg_init=1e-9)
        out[it] = (tilqr.solve(ts, tx, tu, tilqr.ILQRConfig(**kw)),
                   _jax_solve(js, jx, ju, **kw))
    r1, r2 = out[1][0], out[3][0]
    assert float(r2.cost) <= float(r1.cost) + 1e-4
    assert abs(float(r2.cost) - float(r1.cost)) / max(1.0, float(r1.cost)) < 1e-4
    for rt, rj in out.values():
        _hold(rt, rj)


def _lq_linearization(seed, nx, nu, H):
    """Linearization of a random LQ problem, as numpy arrays."""
    js, _ = _random_lqr(seed, nx, nu)
    rng = np.random.default_rng(seed + 1)
    x0 = jnp.asarray(rng.standard_normal(nx).astype(np.float32))
    us = jnp.asarray((0.1 * rng.standard_normal((H, nu))).astype(np.float32))
    return [np.asarray(a) for a in jax.jit(
        lambda x0, us: jilqr.linearize(js, jilqr.rollout(js.step, x0, us), us))(x0, us)]


def test_linearize_matches_jax():
    js, ts = _random_lqr(5, 4, 2)
    rng = np.random.default_rng(6)
    jxs, txs = _both(rng.standard_normal((9, 4)).astype(np.float32))
    jus, tus = _both(rng.standard_normal((8, 2)).astype(np.float32))
    lin = jax.jit(jilqr.linearize, static_argnums=0)
    for got, want in zip(tilqr.linearize(ts, txs, tus), lin(js, jxs, jus)):
        assert got.dtype == torch.float32
        _close(got, want, 1e-5, 1e-5)
    for name in SYSTEMS:
        jsys, tsys = jm.SYSTEMS[name](), tm.SYSTEMS[name]()
        jxs, txs = _both((0.3 * rng.standard_normal((7, jsys.nx))).astype(np.float32))
        jus, tus = _both((0.3 * rng.standard_normal((6, jsys.nu))).astype(np.float32))
        for got, want in zip(tilqr.linearize(tsys, txs, tus), lin(jsys, jxs, jus)):
            assert got.dtype == torch.float32
            _close(got, want, 1e-4, 2e-5)


@pytest.mark.parametrize("mode", ["none", "clamp_diag", "eigh", "gershgorin"])
def test_psd_cost_hessians_match_jax(mode):
    """Every PSD mode on indefinite joint Hessians: the exact projection
    (eigh) is unique whatever the eigenvectors' signs."""
    rng = np.random.default_rng(12)

    def sym(shape):
        a = rng.standard_normal(shape).astype(np.float32)
        return (a + np.swapaxes(a, -1, -2)) / 2

    args = (sym((5, 3, 3)), sym((5, 2, 2)), rng.standard_normal((5, 2, 3)).astype(np.float32),
            sym((3, 3)))
    got = tilqr.psd_cost_hessians(*map(torch.from_numpy, args), mode, 1e-6)
    want = jax.jit(jilqr.psd_cost_hessians, static_argnums=(4, 5))(*map(jnp.asarray, args), mode, 1e-6)
    for g, w in zip(got, want):
        _close(g, w, 1e-4, 1e-5)


def test_backward_passes_agree():
    lin = _lq_linearization(42, 5, 2, 16)
    jin = [jnp.asarray(a) for a in lin]
    tin = [torch.from_numpy(a) for a in lin]
    ks1, Ks1 = tilqr.backward_sequential(*tin, torch.tensor(1e-6))
    ks2, Ks2 = tilqr.backward_associative(*tin, torch.tensor(1e-6))
    _close(ks1, ks2, 1e-4, 1e-5)
    _close(Ks1, Ks2, 1e-4, 1e-5)
    reg = jnp.asarray(1e-6, jnp.float32)
    jks, jKs = jax.jit(jilqr.backward_sequential)(*jin, reg)
    jka, jKa = jax.jit(jilqr.backward_associative)(*jin, reg)
    for got, want in ((ks1, jks), (Ks1, jKs), (ks2, jka), (Ks2, jKa)):
        _close(got, want, 1e-4, 1e-5)


def test_associative_backward_solves_pendulum():
    x0, us = np.zeros(2, np.float32), np.zeros((30, 1), np.float32)
    rj_seq, rt_seq = _solve_both("pendulum", x0, us, iterations=12)
    rj, rt = _solve_both("pendulum", x0, us, iterations=12, backward="associative")
    assert abs(float(rt.cost) - float(rt_seq.cost)) / float(rt_seq.cost) < 0.05
    _hold(rt, rj)
    _hold(rt_seq, rj_seq)


def _lq_batch(seed, nx, nu, Bb, H):
    """A batch of random LQ linearizations (numpy, batch-leading)."""
    js, _ = _random_lqr(seed, nx, nu)
    rng = np.random.default_rng(seed + 1)
    x0s = jnp.asarray(rng.standard_normal((Bb, nx)).astype(np.float32))
    uss = jnp.asarray((0.1 * rng.standard_normal((Bb, H, nu))).astype(np.float32))
    return [np.asarray(a) for a in jax.jit(jax.vmap(
        lambda x0, us: jilqr.linearize(js, jilqr.rollout(js.step, x0, us), us)))(x0s, uss)]


def test_backward_associative_soa_parity():
    """SoA O(log H) backward == SoA sequential backward == mapped
    sequential backward, gain for gain (test_models.py's 4-state problem);
    and == the JAX package's on a 2-state one (XLA compiles the unrolled
    4-state scan several times slower)."""
    Bb = 5
    tin = [torch.from_numpy(a) for a in _lq_batch(7, 4, 2, Bb, 12)]
    reg = torch.full((Bb,), 1e-6)
    ks_a, Ks_a = tilqr.backward_associative_soa(*tin, reg)
    ks_s, Ks_s = tilqr.backward_sequential_soa(*tin, reg)
    _close(ks_a, ks_s, 1e-4, 1e-5)
    _close(Ks_a, Ks_s, 1e-4, 1e-5)
    ks_v, Ks_v = torch.func.vmap(tilqr.backward_sequential)(*tin, reg)
    _close(ks_a, ks_v, 1e-4, 1e-5)
    _close(Ks_a, Ks_v, 1e-4, 1e-5)
    lins = _lq_batch(9, 2, 1, Bb, 12)
    got = tilqr.backward_associative_soa(*map(torch.from_numpy, lins), reg)
    want = jax.jit(jilqr.backward_associative_soa)(
        *map(jnp.asarray, lins), jnp.full((Bb,), 1e-6, jnp.float32))
    for g, w in zip(got, want):
        _close(g, w, 1e-4, 1e-5)


@pytest.mark.parametrize("nx,nu", [(4, 2), (12, 4)], ids=["4-state", "quadrotor-size"])
def test_backward_soa_passes_match_jax(nx, nu):
    """Both batch-minor backward passes held directly to the JAX package, at
    the 4-state problem and at the quadrotor's 12 x 4 size, at the JAX
    suite's gain tolerance.  At 4 states each is held to its JAX twin.  At
    12 both are held to the JAX sequential pass, to which test_models.py
    holds the JAX associative one at this tolerance: XLA takes over two
    minutes of CPU to compile the associative pass's two unrolled 12 x 12
    inverses per combine, and about 20 s for the sequential one."""
    Bb = 3
    lins = _lq_batch(11 + nx, nx, nu, Bb, 4)
    tin = [torch.from_numpy(a.copy()) for a in lins]
    reg = torch.full((Bb,), 1e-6)
    jin = [jnp.asarray(a) for a in lins] + [jnp.full((Bb,), 1e-6, jnp.float32)]
    want_seq = jax.jit(jilqr.backward_sequential_soa)(*jin)
    want = {"backward_sequential_soa": want_seq,
            "backward_associative_soa": (
                jax.jit(jilqr.backward_associative_soa)(*jin) if nx == 4 else want_seq)}
    for name, w in want.items():
        for g, wi in zip(getattr(tilqr, name)(*tin, reg), w):
            _close(g, wi, 1e-4, 1e-5)


def _batched_both(name, x0s, us, **cfg):
    jx, tx = _both(x0s)
    ju, tu = _both(us)
    system = jm.SYSTEMS[name]()
    rj = jax.jit(lambda x, u: jilqr.solve_batched(system, x, u, jilqr.ILQRConfig(**cfg)))(jx, ju)
    rt = tilqr.solve_batched(tm.SYSTEMS[name](), tx, tu, tilqr.ILQRConfig(**cfg))
    return rj, rt


def test_batched_solve_associative_matches_sequential():
    rng = np.random.default_rng(4)
    x0s = (0.3 * rng.standard_normal((4, 2))).astype(np.float32)
    us = np.zeros((4, 20, 1), np.float32)
    r_seq = tilqr.solve_batched(tm.make_pendulum(), torch.from_numpy(x0s), torch.from_numpy(us),
                                tilqr.ILQRConfig(iterations=4))
    rj, r_asc = _batched_both("pendulum", x0s, us, iterations=4, backward="associative")
    _close(r_asc.cost, r_seq.cost, 5e-3)
    _hold(r_asc, rj)


def test_batched_solve():
    system = tm.make_pendulum()
    x0s = (0.3 * np.random.default_rng(0).standard_normal((8, 2))).astype(np.float32)
    us = np.zeros((8, 20, 1), np.float32)
    rj, result = _batched_both("pendulum", x0s, us, iterations=5)
    assert result.xs.shape == (8, 21, 2)
    assert result.cost.shape == (8,)
    assert result.cost_trace.shape == (8, 5)
    tx, tu = torch.from_numpy(x0s), torch.from_numpy(us)
    for i in range(8):
        init = tilqr.trajectory_cost(system, tilqr.rollout(system.step, tx[i], tu[i]), tu[i])
        assert float(result.cost[i]) <= float(init) + 1e-5
    _hold(result, rj)
    _close(result.cost_trace, rj.cost_trace, 1e-4)


def test_cartpole_improves():
    x0, us = np.zeros(4, np.float32), 0.01 * np.ones((30, 1), np.float32)
    rj, rt = _solve_both("cartpole", x0, us, iterations=6)
    system = tm.make_cartpole()
    tx, tu = torch.from_numpy(x0), torch.from_numpy(us)
    init = tilqr.trajectory_cost(system, tilqr.rollout(system.step, tx, tu), tu)
    assert float(rt.cost) < 0.5 * float(init)
    _hold(rt, rj)


def test_quadrotor_stabilizes():
    x0 = np.zeros(12, np.float32)
    x0[0:3] = [1.0, -1.0, 0.5]
    rj, rt = _solve_both("quadrotor", x0, np.zeros((50, 4), np.float32), iterations=6)
    assert float(torch.linalg.norm(rt.xs[-1, 0:3])) < 0.3
    _hold(rt, rj)


# -------------------------------------------------- sm ops under torch.func
def test_dynamics_via_sm_api():
    """iLQR through dynamics written entirely in sm ops matches the native
    pendulum solve, of the port and of the JAX package; the solver's
    derivatives run the sm ops under torch.func through
    ops/autodiff.py (transform:*), on the kernels' plain versions here, and
    none as plain torch (torch_path:*); the rest runs the engine's ordinary
    route."""
    sm_system = tm.make_sm_pendulum()
    native = tm.make_pendulum()
    jx, x0 = _both(np.array([0.4, 0.0], np.float32))
    ju, us = _both(np.zeros((20, 1), np.float32))
    u1 = torch.tensor([0.5])
    _close(sm_system.step(x0, u1), native.step(x0, u1), 1e-6)

    dispatch.reset()
    res_sm = tilqr.solve(sm_system, x0, us, tilqr.ILQRConfig(iterations=6))
    counts = dispatch.counts()
    res_native = tilqr.solve(native, x0, us, tilqr.ILQRConfig(iterations=6))
    assert counts.get("engine:add", 0) > 0
    assert counts.get("engine:multiply", 0) > 0
    assert counts.get("engine:divide", 0) > 0
    for op in ("sin", "add", "multiply", "divide", "subtract", "vjp"):
        assert counts.get(f"transform:{op}", 0) > 0, op
    # Under the transforms nothing runs as plain torch.  (Outside them the
    # 0-d ops of the single-trajectory rollout do, as the JAX package
    # sends a 0-d op to XLA.)
    dispatch.reset()
    tilqr.linearize(sm_system, res_sm.xs, res_sm.us)
    assert dispatch.count("transform", "vjp") > 0
    assert not any(k.startswith("torch_path") for k in dispatch.counts()), dispatch.counts()
    assert counts.get("elementwise:fused", 0) > 0  # the rollout, outside any transform
    _close(res_sm.cost, res_native.cost, 1e-4)
    _close(res_sm.us, res_native.us, 1e-3, 1e-4)
    _hold(res_sm, _jax_solve(jm.make_pendulum(), jx, ju, iterations=6))


def test_sm_ops_under_grad_and_vmap():
    """The autodiff route under each transform the solver uses, and
    outside them the ordinary route; reductions too."""
    x = torch.tensor([0.3, -1.2, 2.0])

    def f(t):
        a = sm.Array(t)
        return sm.sum(sm.sin(a) * a + a / 2.0 - 1.0).torch()

    dispatch.reset()
    g = torch.func.grad(f)(x)
    assert dispatch.count("transform", "sin") == 1
    assert dispatch.count("transform", "reduce_sum") == 1
    assert not any(k.startswith("torch_path") for k in dispatch.counts())
    _close(g, torch.cos(x) * x + torch.sin(x) + 0.5, 1e-6)
    v = torch.func.vmap(f)(torch.stack([x, 2 * x]))
    _close(v, torch.stack([f(x), f(2 * x)]), 1e-6)
    _, t = torch.func.jvp(f, (x,), (torch.ones(3),))
    _close(t, g.sum(), 1e-6)
    dispatch.reset()
    f(x)
    assert not any(k.startswith("torch_path") for k in dispatch.counts())


@pytest.mark.parametrize("deferred", [False, True], ids=["eager", "lazy"])
def test_sm_ops_under_a_transform_raise_off_the_cpu(deferred):
    """Off the CPU no plain fallback takes a transformed tensor: the op goes
    to ops/autodiff.py (recorded as transform:<op>), whose Function hands
    the unwrapped tensor to the kernel's wrapper, and a tensor the kernels
    do not run on raises there, whether the lazy queue is on or off, and so
    does a reduction.  A meta tensor stands in for a device without the
    kernels (on the card the same route launches them:
    tests/test_torch_kernel_cuda.py)."""
    x = torch.zeros(3, device="meta")

    def f(t):
        a = sm.Array(t)
        return (sm.sin(a) * a + 1.0).torch().sum()

    def red(t):
        return sm.Array(t).sum().torch()

    old = sm.config.deferred_eager
    sm.configure(deferred_eager=deferred)
    try:
        for run in (lambda: torch.func.grad(f)(x),
                    lambda: torch.func.vmap(f)(torch.zeros(2, 3, device="meta")),
                    lambda: torch.func.jvp(f, (x,), (torch.zeros(3, device="meta"),)),
                    lambda: torch.func.grad(red)(x)):
            dispatch.reset()
            with pytest.raises(ValueError, match="CUDA tensors, not meta"):
                run()
            assert any(k.startswith("transform:") for k in dispatch.counts())
            assert not any(k.startswith("torch_path") for k in dispatch.counts())
    finally:
        sm.configure(deferred_eager=old)


def test_stack_and_concatenate_match_jnp():
    a = np.arange(6, dtype=np.int32).reshape(2, 3)
    b = np.ones((2, 3), np.float32)
    for name in ("stack", "concatenate"):
        for axis in (0, 1):
            got = getattr(sm, name)([sm.Array(a), sm.Array(b)], axis=axis)
            want = getattr(jnp, name)([jnp.asarray(a), jnp.asarray(b)], axis=axis)
            assert got.shape == want.shape
            assert str(got.dtype).split(".")[-1] == str(want.dtype)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_solve_batched_jit_is_solve_batched():
    """The JAX package's jitted alias; the port has no compiled variant."""
    assert tilqr.solve_batched_jit is tilqr.solve_batched
    r = tilqr.solve(tm.make_pendulum(), torch.tensor([0.1, 0.0]), torch.zeros(10, 1),
                    tilqr.ILQRConfig(iterations=2))
    assert np.isfinite(float(r.cost))


class TestBicycle:
    def test_lane_change_converges(self):
        system = tm.make_bicycle()
        B, H = 4, 30
        x0s = np.zeros((B, system.nx), np.float32)
        us0 = np.zeros((B, H, system.nu), np.float32)
        rj, res = _batched_both("bicycle", x0s, us0, iterations=10)
        assert np.all(np.isfinite(_np(res.cost)))
        xs = tilqr.rollout(system.step, torch.from_numpy(x0s[0]), res.us[0])
        final = _np(xs[-1])
        assert abs(final[1] - 3.0) < 0.3, final
        assert abs(final[2]) < 0.3, final
        zero = tilqr.trajectory_cost(
            system, tilqr.rollout(system.step, torch.zeros(4), torch.zeros(H, 2)),
            torch.zeros(H, 2))
        assert float(res.cost[0]) < 0.5 * float(zero)
        _hold(res, rj)

    def test_batch_polymorphic_soa(self):
        system = tm.make_bicycle()
        assert system.batch_polymorphic and system.separable_cost
        x = torch.ones((system.nx, 7))
        u = torch.ones((system.nu, 7))
        assert system.step(x, u).shape == (system.nx, 7)
        assert system.stage_cost(x, u).shape == (7,)


# -------------------------------------------- where torch is not jnp
def _fold(fn, elems):
    """A sequential inclusive scan: the reference of associative_scan."""
    out, acc = [], None
    for k in range(elems[0].shape[0]):
        e = tuple(x[k:k + 1] for x in elems)
        acc = e if acc is None else fn(acc, e)
        out.append(acc)
    return tuple(torch.cat(parts) for parts in zip(*out))


@pytest.mark.parametrize("H", [1, 2, 3, 7, 20])
def test_associative_scan_matches_fold_and_jax_pairing(H):
    """The scan equals a sequential fold of an associative combine (affine
    maps, float32, within rounding), and pairs exactly as
    jax.lax.associative_scan does: with the non-associative combine
    2a + 3b (int64, no rounding) any other tree gives other numbers, so a
    sequential scan would fail here."""
    rng = np.random.default_rng(H)
    A = (0.5 * rng.standard_normal((H, 3, 3))).astype(np.float32)
    b = rng.standard_normal((H, 3)).astype(np.float32)

    def affine(e1, e2):
        A1, b1 = e1
        A2, b2 = e2
        return A2 @ A1, (A2 @ b1[..., None])[..., 0] + b2

    tA, tb = torch.from_numpy(A), torch.from_numpy(b)
    got = associative_scan(affine, (tA, tb))
    for g, w in zip(got, _fold(affine, (tA, tb))):
        _close(g, w, 1e-5, 1e-5)
    ja = jax.jit(lambda A, b: jax.lax.associative_scan(affine, (A, b)))(jnp.asarray(A), jnp.asarray(b))
    for g, w in zip(got, ja):
        _close(g, w, 1e-6, 1e-6)

    ints = rng.integers(-5, 6, H).astype(np.int64)
    tree = associative_scan(lambda x, y: (2 * x[0] + 3 * y[0],), (torch.from_numpy(ints),))[0]
    jtree = jax.jit(lambda e: jax.lax.associative_scan(lambda x, y: 2 * x + 3 * y, e))(
        jnp.asarray(ints))
    np.testing.assert_array_equal(_np(tree), np.asarray(jtree))
    if H >= 4:  # up to 3 the JAX tree is the sequential one
        seq = _fold(lambda x, y: (2 * x[0] + 3 * y[0],), (torch.from_numpy(ints),))[0]
        assert not torch.equal(tree, seq)


def _concave(system_cls):
    """Concave in u: Quu = -1 + B^T Vxx B + reg < 0 at the first iteration."""
    return system_cls("concave", 1, 1, 1.0,
                      lambda x, u: x + 0.01 * u,
                      lambda x, u: 0.5 * (x[0] ** 2 - u[0] ** 2),
                      lambda x: 0.5 * x[0] ** 2)


def test_cholesky_of_non_pd_is_nan_and_the_step_is_rejected():
    """A non-PD Quu: jnp.linalg.cholesky gives NaN, torch's would raise or
    (cholesky_ex) give finite garbage.  The port's factor is NaN, so its
    gains are NaN as the JAX package's are, the step's cost is non-finite
    and the solve keeps the old trajectory and raises reg."""
    M = np.array([[[1.0, 2.0], [2.0, 1.0]], [[2.0, 0.0], [0.0, 3.0]]], np.float32)
    rhs = np.ones((2, 2), np.float32)
    got = tilqr._solve_psd(torch.from_numpy(M), torch.from_numpy(rhs))
    want = jilqr._solve_psd(jnp.asarray(M[0]), jnp.asarray(rhs[0]))
    assert np.isnan(np.asarray(want)).all() and torch.isnan(got[0]).all()
    _close(got[1], rhs[1] / np.array([2.0, 3.0], np.float32), 1e-6)

    cfg = dict(iterations=2, psd="none", alphas=(1.0, 0.5))
    jx, tx = _both(np.array([1.0], np.float32))
    ju, tu = _both(np.zeros((5, 1), np.float32))
    system = _concave(tm.System)
    rj = _jax_solve(_concave(jm.System), jx, ju, **cfg)
    rt = tilqr.solve(system, tx, tu, tilqr.ILQRConfig(**cfg))
    xs = tilqr.rollout(system.step, tx, tu)
    init = float(tilqr.trajectory_cost(system, xs, tu))
    for r in (rt, rj):
        np.testing.assert_array_equal(_np(r.cost_trace), [init, init])
        np.testing.assert_array_equal(_np(r.us), 0.0)
    ks, _ = tilqr.backward_sequential(*tilqr.linearize(system, xs, tu), torch.tensor(1e-6))
    assert torch.isnan(ks).all()


def test_nan_gradient_norm_reads_float_max():
    """jnp.nan_to_num(x, nan=inf) maps NaN to +inf and +inf to finfo.max;
    torch.nan_to_num(nan=inf) would leave +inf.  The port's grad_norm reads
    finfo.max for a NaN gain, as the JAX package's does."""
    big = np.finfo(np.float32).max
    x = np.array([np.nan, np.inf, -np.inf, 1.5], np.float32)
    want = np.asarray(jnp.nan_to_num(jnp.asarray(x), nan=jnp.inf))
    got = _np(tilqr._finite_norm(torch.from_numpy(x)))
    np.testing.assert_array_equal(got, want)
    assert got[0] == big and got[1] == big
    assert torch.nan_to_num(torch.tensor(np.nan), nan=math.inf) == math.inf  # plain torch differs

    # End to end: the non-PD step of the concave system has NaN gains.
    cfg = dict(iterations=1, psd="none")
    jx, tx = _both(np.array([1.0], np.float32))
    ju, tu = _both(np.zeros((4, 1), np.float32))
    rj = _jax_solve(_concave(jm.System), jx, ju, **cfg)
    rt = tilqr.solve(_concave(tm.System), tx, tu, tilqr.ILQRConfig(**cfg))
    assert float(rj.grad_norm) == big and float(rt.grad_norm) == big


@pytest.mark.parametrize("costs", [
    [3.0, 1.0, 1.0, 2.0],
    [np.inf, 2.0, np.nan, 2.0],
    [np.nan, 1.0, np.nan],
    [np.inf, np.inf, 5.0],
    [np.inf, np.inf],
    [2.0, 2.0, 2.0],
], ids=["tie", "nan", "first-nan", "inf", "all-inf", "all-tie"])
def test_argmin_ties_and_nans_pick_the_same_index(costs):
    """The line search's choice among candidate costs: the first of equal
    values wins, and NaN wins over everything, in both packages."""
    c = np.array(costs, np.float32)
    assert int(torch.argmin(torch.from_numpy(c))) == int(jnp.argmin(jnp.asarray(c)))
    c2 = np.stack([c, c[::-1]], axis=1)  # the batched line search's axis 0
    np.testing.assert_array_equal(_np(torch.argmin(torch.from_numpy(c2), dim=0)),
                                  np.asarray(jnp.argmin(jnp.asarray(c2), axis=0)))


def test_line_search_picks_nan_and_tied_alphas_as_jax():
    """Through both line searches: a NaN step size makes its rollout NaN,
    and argmin picks it in both packages (the solve then rejects the
    step); duplicated step sizes tie, and the first wins."""
    system, jsystem = tm.make_pendulum(), jm.make_pendulum()
    rng = np.random.default_rng(3)
    H = 6
    xs = (0.1 * rng.standard_normal((H + 1, 2))).astype(np.float32)
    us = (0.1 * rng.standard_normal((H, 1))).astype(np.float32)
    ks = (0.1 * rng.standard_normal((H, 1))).astype(np.float32)
    Ks = (0.1 * rng.standard_normal((H, 1, 2))).astype(np.float32)
    for alphas in ((1.0, float("nan"), 0.5), (0.5, 0.5, 1.0)):
        got = tilqr.forward_linesearch(system, *map(torch.from_numpy, (xs, us, ks, Ks)), alphas)
        want = jax.jit(lambda *a: jilqr.forward_linesearch(jsystem, *a, alphas))(
            *map(jnp.asarray, (xs, us, ks, Ks)))
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5, atol=1e-6)
        got_b = tilqr.forward_linesearch_soa(
            system, *(torch.from_numpy(np.stack([a, a])) for a in (xs, us, ks, Ks)), alphas)
        for g, w in zip(got_b, want):
            np.testing.assert_allclose(_np(g[1]), np.asarray(w), rtol=1e-5, atol=1e-6)
