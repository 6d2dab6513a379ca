"""The NumPy-style free functions of the port against NumPy and the JAX
package: twins of tests/test_api_functions.py (the same functions and
bounds, with ``log1p``/``log10`` at the suite's CPU bound), plus the
result types of the ``jnp`` façades (``eye``, ``linspace``, ``transpose``,
``reshape``, ``repeat``, ``sort``, ``floor``, ``ceil``, ``round``,
``log10``, ``log1p``, ``expm1``, ``sinh``, ``cosh``, ``arcsin``,
``arccos``, ``arctan``, ``isnan``, ``isinf``, ``isfinite``, ``arctan2``,
``expand_dims``, ``squeeze``) held against the JAX package's under x64.
"""

import numpy as np
import pytest

import simplemath_tpu as jsm
import simplemath_tpu_torch as sm


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's default device is the card; these tests ask for the CPU."""
    old = sm.config.device
    sm.configure(device="cpu")
    yield
    sm.configure(device=old)


def test_unary_functions(rng):
    x = rng.normal(size=(4, 5)).astype(np.float32)
    a = sm.Array(x)
    # sin/cos/tanh lower to the platform's native f32 approximations; the
    # TPU VPU versions are good to ~4e-5 relative (a few bf16-grade ulps),
    # tighter on CPU.  These assert API surface, not our kernels (exp/log/
    # pow accuracy is pinned down in test_transcendental.py).
    np.testing.assert_allclose(sm.sin(a).numpy(), np.sin(x), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(sm.cos(a).numpy(), np.cos(x), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(sm.tanh(a).numpy(), np.tanh(x), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(sm.abs(a).numpy(), np.abs(x), rtol=1e-6)
    np.testing.assert_allclose(sm.square(a).numpy(), x * x, rtol=1e-6)
    np.testing.assert_allclose(
        sm.sqrt(sm.abs(a)).numpy(), np.sqrt(np.abs(x)), rtol=1e-6
    )


def test_reductions(rng):
    x = rng.normal(size=(3, 7)).astype(np.float32)
    a = sm.Array(x)
    np.testing.assert_allclose(float(sm.sum(a)), x.sum(), rtol=1e-5)
    np.testing.assert_allclose(
        sm.sum(a, axis=0).numpy(), x.sum(axis=0), rtol=1e-5
    )
    np.testing.assert_allclose(float(sm.mean(a)), x.mean(), rtol=1e-5)
    assert float(sm.max(a)) == x.max()
    assert float(sm.min(a)) == x.min()
    assert int(sm.argmax(a)) == x.argmax()


def test_shape_functions(rng):
    x = rng.normal(size=(2, 6)).astype(np.float32)
    a = sm.Array(x)
    assert sm.transpose(a).shape == (6, 2)
    assert sm.reshape(a, (3, 4)).shape == (3, 4)
    np.testing.assert_array_equal(
        sm.repeat(sm.Array([1, 2]), 2).numpy(), np.array([1, 1, 2, 2])
    )
    c = sm.concatenate([a, a], axis=0)
    assert c.shape == (4, 6)
    s = sm.stack([a, a])
    assert s.shape == (2, 2, 6)


def test_binary_functions(rng):
    x = rng.normal(size=(5,)).astype(np.float32)
    y = rng.normal(size=(5,)).astype(np.float32)
    a, b = sm.Array(x), sm.Array(y)
    np.testing.assert_allclose(sm.maximum(a, b).numpy(), np.maximum(x, y))
    np.testing.assert_allclose(sm.minimum(a, b).numpy(), np.minimum(x, y))
    np.testing.assert_allclose(
        sm.where(a > b, a, b).numpy(), np.where(x > y, x, y)
    )


def test_matmul_function(rng):
    x = rng.normal(size=(3, 4)).astype(np.float32)
    y = rng.normal(size=(4, 2)).astype(np.float32)
    np.testing.assert_allclose(
        sm.matmul(sm.Array(x), sm.Array(y)).numpy(), x @ y, rtol=1e-5
    )


def test_allclose_helper():
    assert sm.allclose(sm.Array([1.0, 2.0]), sm.Array([1.0, 2.0]))
    assert not sm.allclose(sm.Array([1.0]), sm.Array([2.0]))


def test_views_through_free_functions(rng):
    x = rng.normal(size=(4, 4)).astype(np.float32)
    a = sm.Array(x)
    v = a.T[1:3]
    np.testing.assert_allclose(sm.sum(v, axis=1).numpy(), x.T[1:3].sum(axis=1), rtol=1e-5)


def test_factory_extensions():
    """eye/linspace/*_like — NumPy-surface completeness beyond the
    reference's empty/ones/zeros (UserFunctions.h:8-40)."""
    A = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_allclose(np.asarray(sm.eye(3)), np.eye(3))
    np.testing.assert_allclose(np.asarray(sm.eye(2, 5)), np.eye(2, 5))
    np.testing.assert_allclose(
        np.asarray(sm.linspace(0.0, 1.0, 5)), np.linspace(0, 1, 5)
    )
    np.testing.assert_allclose(
        np.asarray(sm.zeros_like(sm.array(A))), np.zeros_like(A)
    )
    np.testing.assert_allclose(
        np.asarray(sm.ones_like(sm.array(A))), np.ones_like(A)
    )
    np.testing.assert_allclose(
        np.asarray(sm.full_like(sm.array(A), 7)), np.full_like(A, 7)
    )


def test_statistical_reductions():
    A = np.arange(12, dtype=np.float32).reshape(3, 4) + 1
    np.testing.assert_allclose(
        float(np.asarray(sm.prod(sm.array(A[:2, :2])))), np.prod(A[:2, :2])
    )
    np.testing.assert_allclose(
        np.asarray(sm.var(sm.array(A), axis=0)), A.var(axis=0), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(sm.std(sm.array(A), axis=1)), A.std(axis=1), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(sm.var(sm.array(A), ddof=1)), A.var(ddof=1), rtol=1e-5
    )


def test_unary_surface_extensions():
    A = np.asarray([[0.3, -1.7], [2.5, -0.5]], np.float32)
    a = sm.array(A)
    # Plain torch here, as they are XLA lowerings in the JAX package: the
    # JAX suite's CPU bound (its 5e-4 is XLA:TPU's log1p/log10 accuracy).
    rtol = 1e-5
    for name in ("floor", "ceil", "round", "log1p", "expm1", "sinh", "cosh",
                 "arctan", "isnan", "isinf", "isfinite"):
        got = np.asarray(getattr(sm, name)(sm.abs(a) if name.startswith("log") else a))
        want = getattr(np, name)(np.abs(A) if name.startswith("log") else A)
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(sm.log10(sm.abs(a))), np.log10(np.abs(A)), rtol=rtol
    )
    np.testing.assert_allclose(
        np.asarray(sm.arcsin(sm.clip(a, -1.0, 1.0))),
        np.arcsin(np.clip(A, -1, 1)), rtol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(sm.arctan2(a, sm.ones_like(a))), np.arctan2(A, 1.0),
        rtol=1e-5,
    )


_FACADES = {
    "eye": lambda m, a: m.eye(3, 4),
    "linspace": lambda m, a: m.linspace(-1.0, 2.0, 7),
    "transpose": lambda m, a: m.transpose(a),
    "transpose_axes": lambda m, a: m.transpose(m.reshape(a, (2, 3, 2)), (2, 0, 1)),
    "reshape": lambda m, a: m.reshape(a, (4, 3)),
    "repeat_axis": lambda m, a: m.repeat(a, 2, axis=1),
    "sort": lambda m, a: m.sort(a),
    "sort_axis0": lambda m, a: m.sort(a, axis=0),
    "sort_flat": lambda m, a: m.sort(a, axis=None),
    "floor": lambda m, a: m.floor(a * 3.0),
    "ceil": lambda m, a: m.ceil(a * 3.0),
    "round_half_even": lambda m, a: m.round(m.Array(np.array([0.5, 1.5, 2.5, -0.5, -1.5], np.float32))),
    "round_int": lambda m, a: m.round(m.Array(np.array([3, -4], np.int32))),
    "log10": lambda m, a: m.log10(m.abs(a) + 0.5),
    "log1p": lambda m, a: m.log1p(m.abs(a)),
    "expm1": lambda m, a: m.expm1(a),
    "sinh": lambda m, a: m.sinh(a),
    "cosh": lambda m, a: m.cosh(a),
    "arcsin": lambda m, a: m.arcsin(m.clip(a, -1.0, 1.0)),
    "arccos": lambda m, a: m.arccos(m.clip(a, -1.0, 1.0)),
    "arctan": lambda m, a: m.arctan(a),
    "arctan_int": lambda m, a: m.arctan(m.Array(np.array([1, -2], np.int32))),
    "isnan": lambda m, a: m.isnan(a / 0.0),
    "isinf": lambda m, a: m.isinf(a / 0.0),
    "isfinite": lambda m, a: m.isfinite(a / 0.0),
    "arctan2": lambda m, a: m.arctan2(a, m.ones_like(a) * -0.5),
    "arctan2_int": lambda m, a: m.arctan2(m.Array(np.array([1, 0], np.int32)),
                                          m.Array(np.array([-1, 2], np.int32))),
    "expand_dims": lambda m, a: m.expand_dims(a, 1),
    "expand_dims_tuple": lambda m, a: m.expand_dims(a, (0, 3)),
    "squeeze": lambda m, a: m.squeeze(m.reshape(a, (1, 12, 1))),
    "squeeze_axis": lambda m, a: m.squeeze(m.reshape(a, (1, 12, 1)), axis=2),
}


@pytest.mark.parametrize("name", sorted(_FACADES))
def test_facade_matches_jax(name):
    """Values within 1e-6 relative (plain torch against XLA on the CPU; the
    element choices are exact) and jnp's result dtype under x64."""
    x = np.random.default_rng(5).normal(size=(3, 4)).astype(np.float32)
    x[1, 2] = 0.0
    got = _FACADES[name](sm, sm.Array(x))
    want = _FACADES[name](jsm, jsm.Array(x))
    assert got.shape == want.shape and np.asarray(got).dtype == np.asarray(want).dtype
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_squeeze_of_a_wide_axis_raises():
    with pytest.raises(ValueError, match="size not equal to one"):
        sm.squeeze(sm.ones(2, 3), axis=0)
