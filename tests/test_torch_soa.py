"""Batch-minor (SoA) small-matrix algebra and the SoA iLQR stages of the
port (ops/soa.py, models/ilqr.py) against numpy and the JAX package.
Twins of tests/test_soa.py at its sizes or smaller; the same float32 numpy
inputs go through both packages on the CPU, at test_soa.py's tolerances
(``rtol=2e-4, atol=2e-5`` for the backward pass, ``rtol=1e-4, atol=2e-5``
for the linearization, ``rtol=1e-4, atol=1e-5`` for the line search)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simplemath_tpu_torch as sm
from simplemath_tpu import models as jm
from simplemath_tpu.models import ilqr as J
from simplemath_tpu.ops import soa as jsoa
from simplemath_tpu_torch import models as tm
from simplemath_tpu_torch.models import ilqr as I
from simplemath_tpu_torch.ops import soa

SYSTEMS = ["pendulum", "cartpole", "quadrotor"]


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's default device is the card; these tests ask for the CPU."""
    old = sm.config.device
    sm.configure(device="cpu")
    yield
    sm.configure(device=old)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rand(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# ------------------------------------------------------------- primitives
def test_soa_matmul_matvec_against_numpy_and_jax(rng):
    B = 37
    for n, m, k in [(1, 1, 1), (2, 3, 4), (4, 4, 4), (5, 2, 3)]:
        A = _rand(rng, (n, k, B))
        C = _rand(rng, (k, m, B))
        v = _rand(rng, (k, B))
        got = soa.matmul(torch.from_numpy(A), torch.from_numpy(C))
        np.testing.assert_allclose(_np(got), np.einsum("ikb,kjb->ijb", A, C), rtol=1e-5, atol=1e-5)
        # k ascending, as in the JAX package: the same sums.
        np.testing.assert_allclose(_np(got), np.asarray(jsoa.matmul(A, C)), rtol=1e-6, atol=1e-6)
        gotv = soa.matvec(torch.from_numpy(A), torch.from_numpy(v))
        np.testing.assert_allclose(_np(gotv), np.einsum("ikb,kb->ib", A, v), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(gotv), np.asarray(jsoa.matvec(A, v)), rtol=1e-6, atol=1e-6)
    u, w = _rand(rng, (3, B)), _rand(rng, (2, B))
    np.testing.assert_array_equal(_np(soa.outer(torch.from_numpy(u), torch.from_numpy(w))),
                                  np.asarray(jsoa.outer(u, w)))


def _entry_by_entry_matmul(A, C):
    """The product one entry at a time, k ascending: the reference the
    vectorized ``soa.matmul`` must give the bits of."""
    n, k, m = A.shape[-3], A.shape[-2], C.shape[-2]
    rows = []
    for i in range(n):
        cols = []
        for j in range(m):
            acc = A[..., i, 0, :] * C[..., 0, j, :]
            for kk in range(1, k):
                acc = acc + A[..., i, kk, :] * C[..., kk, j, :]
            cols.append(acc)
        rows.append(torch.stack(cols, dim=-2))
    return torch.stack(rows, dim=-3)


@pytest.mark.parametrize("shapes", [((4, 4, 37), (4, 4, 37)), ((3, 1, 4, 37), (3, 4, 1, 37)),
                                    ((2, 5, 3, 9), (2, 3, 6, 9)), ((1, 4, 5), (4, 1, 1))])
def test_soa_products_have_the_entry_by_entry_bits(rng, shapes):
    """``matmul``/``matvec`` over all (i, j) entries at once, k ascending:
    the same multiplies and adds in the same order as one entry at a time,
    so the same bits (a leading time axis and a broadcast batch included)."""
    A, C = (torch.from_numpy(_rand(rng, s)) for s in shapes)
    assert torch.equal(soa.matmul(A, C), _entry_by_entry_matmul(A, C))
    v = C[..., 0, :]
    want = _entry_by_entry_matmul(A, v[..., :, None, :])[..., 0, :]
    assert torch.equal(soa.matvec(A, v), want)


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_soa_inv_matches_numpy(rng, n):
    B = 17
    M = rng.standard_normal((B, n, n))
    A = M @ np.swapaxes(M, -1, -2) + n * np.eye(n)  # well-conditioned PD
    A_soa = np.moveaxis(A, 0, -1).astype(np.float32)
    got = np.moveaxis(_np(soa.inv(torch.from_numpy(A_soa))), -1, 0)
    np.testing.assert_allclose(got, np.linalg.inv(A), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(_np(soa.inv(torch.from_numpy(A_soa))),
                               np.asarray(jsoa.inv(jnp.asarray(A_soa))), rtol=1e-5, atol=1e-6)
    b = _rand(rng, (n, B))
    np.testing.assert_allclose(_np(soa.solve(torch.from_numpy(A_soa), torch.from_numpy(b))),
                               np.asarray(jsoa.solve(jnp.asarray(A_soa), jnp.asarray(b))),
                               rtol=1e-5, atol=1e-6)


def test_soa_roundtrip_transpose_and_eye(rng):
    x = torch.from_numpy(_rand(rng, (6, 4, 5)))
    np.testing.assert_array_equal(_np(soa.from_soa(soa.to_soa(x, 2))), _np(x))
    np.testing.assert_array_equal(_np(soa.transpose(x)), np.swapaxes(_np(x), 0, 1))
    e = soa.eye_like(3, x)
    assert e.shape == (3, 3, 1) and e.dtype == x.dtype and e.device == x.device


# ----------------------------------------------------------- solver stages
@pytest.mark.parametrize("name", SYSTEMS)
def test_backward_soa_matches_vmapped(name):
    system = tm.SYSTEMS[name]()
    Bb, H, nx, nu = 6, 9, system.nx, system.nu
    rng = np.random.default_rng(0)
    lin = [
        _rand(rng, (Bb, H, nx, nx), 0.05) + np.eye(nx, dtype=np.float32),
        _rand(rng, (Bb, H, nx, nu), 0.1),
        _rand(rng, (Bb, H, nx)),
        _rand(rng, (Bb, H, nu)),
        np.broadcast_to(np.eye(nx, dtype=np.float32), (Bb, H, nx, nx)).copy(),
        np.broadcast_to(np.eye(nu, dtype=np.float32), (Bb, H, nu, nu)).copy(),
        np.zeros((Bb, H, nu, nx), np.float32),
        _rand(rng, (Bb, nx)),
        np.broadcast_to(np.eye(nx, dtype=np.float32), (Bb, nx, nx)).copy(),
    ]
    t = [torch.from_numpy(a) for a in lin]
    ks0, Ks0 = torch.func.vmap(lambda *a: I.backward_sequential(*a, torch.tensor(1e-6)))(*t)
    ks1, Ks1 = I.backward_sequential_soa(*t, torch.full((Bb,), 1e-6))
    for a, b in ((ks0, ks1), (Ks0, Ks1)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=2e-4, atol=2e-5)
    if nx > 4:
        return  # one code for every n; XLA's compile of the 12 x 12 case is the slowest here
    jks, jKs = jax.jit(J.backward_sequential_soa)(
        *map(jnp.asarray, lin), jnp.full((Bb,), 1e-6, jnp.float32))
    np.testing.assert_allclose(_np(ks1), np.asarray(jks), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(_np(Ks1), np.asarray(jKs), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("name", SYSTEMS)
def test_linearize_soa_matches_vmapped(name):
    system, jsystem = tm.SYSTEMS[name](), jm.SYSTEMS[name]()
    Bb, H = 5, 7
    rng = np.random.default_rng(1)
    xs = _rand(rng, (Bb, H + 1, system.nx), 0.3)
    us = _rand(rng, (Bb, H, system.nu), 0.3)
    ref = torch.func.vmap(lambda xs, us: I.linearize(system, xs, us))(
        torch.from_numpy(xs), torch.from_numpy(us))
    got = I.linearize_soa(system, torch.from_numpy(xs), torch.from_numpy(us))
    want = jax.jit(lambda xs, us: J.linearize_soa(jsystem, xs, us))(xs, us)
    for name_, r, g, w in zip(("A", "B", "lx", "lu", "lxx", "luu", "lux", "VxT", "VxxT"),
                              ref, got, want):
        assert r.shape == g.shape == w.shape, name_
        assert g.dtype == torch.float32, name_
        np.testing.assert_allclose(_np(r), _np(g), rtol=1e-4, atol=2e-5, err_msg=name_)
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4, atol=2e-5, err_msg=name_)


@pytest.mark.parametrize("name", SYSTEMS)
def test_linesearch_soa_matches_vmapped(name):
    system, jsystem = tm.SYSTEMS[name](), jm.SYSTEMS[name]()
    Bb, H = 4, 8
    rng = np.random.default_rng(2)
    alphas = (1.0, 0.5, 0.1)
    args = [_rand(rng, (Bb, H + 1, system.nx), 0.1), _rand(rng, (Bb, H, system.nu), 0.1),
            _rand(rng, (Bb, H, system.nu), 0.1), _rand(rng, (Bb, H, system.nu, system.nx), 0.1)]
    t = [torch.from_numpy(a) for a in args]
    ref = torch.func.vmap(lambda *a: I.forward_linesearch(system, *a, alphas))(*t)
    got = I.forward_linesearch_soa(system, *t, alphas)
    want = jax.jit(lambda *a: J.forward_linesearch_soa(jsystem, *a, alphas))(*args)
    for name_, r, g, w in zip(("xs", "us", "cost"), ref, got, want):
        np.testing.assert_allclose(_np(r), _np(g), rtol=1e-4, atol=1e-5, err_msg=name_)
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4, atol=1e-5, err_msg=name_)


def test_solve_batched_converges_like_vmapped_solve():
    """The SoA-batched solver reaches the same solution quality as
    per-scenario solves (identical up to float32 summation order, which can
    flip line-search accepts between equal-quality local optima)."""
    system = tm.make_pendulum()
    cfg = I.ILQRConfig(iterations=8)
    Bb, H = 8, 20
    x0 = torch.from_numpy(_rand(np.random.default_rng(3), (Bb, system.nx), 0.2))
    us = torch.zeros((Bb, H, system.nu))
    c_soa = _np(I.solve_batched(system, x0, us, cfg).cost)
    c_vm = np.array([float(I.solve(system, x0[i], us[i], cfg).cost) for i in range(Bb)])
    assert abs(c_soa.mean() - c_vm.mean()) / abs(c_vm.mean()) < 1e-2
    assert np.all(c_soa < c_vm * 1.05 + 1e-3)


def test_solve_batched_result_shapes():
    system = tm.make_cartpole()
    cfg = I.ILQRConfig(iterations=3)
    Bb, H = 3, 5
    x0 = torch.from_numpy(_rand(np.random.default_rng(4), (Bb, system.nx), 0.1))
    r = I.solve_batched(system, x0, torch.zeros((Bb, H, system.nu)), cfg)
    assert r.xs.shape == (Bb, H + 1, system.nx)
    assert r.us.shape == (Bb, H, system.nu)
    assert r.cost.shape == (Bb,)
    assert r.cost_trace.shape == (Bb, cfg.iterations)
    assert r.grad_norm.shape == (Bb,)
    assert np.all(np.isfinite(_np(r.cost)))


def test_batch_polymorphic_dynamics_trailing_axes():
    """step/stage_cost/final_cost accept (n, *batch) stacks and match the
    per-point results elementwise."""
    for name in SYSTEMS:
        system = tm.SYSTEMS[name]()
        rng = np.random.default_rng(5)
        x = torch.from_numpy(_rand(rng, (system.nx, 3, 11), 0.3))
        u = torch.from_numpy(_rand(rng, (system.nu, 3, 11), 0.3))
        xn, c, cf = system.step(x, u), system.stage_cost(x, u), system.final_cost(x)
        assert xn.shape == x.shape
        assert c.shape == (3, 11) and cf.shape == (3, 11)
        x1, u1 = x[:, 1, 4], u[:, 1, 4]
        np.testing.assert_allclose(_np(system.step(x1, u1)), _np(xn[:, 1, 4]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(system.stage_cost(x1, u1)), float(c[1, 4]), rtol=1e-5)
