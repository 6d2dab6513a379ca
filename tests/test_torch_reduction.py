"""The port's reductions and 1-D dot against the JAX package's: Array and
free-function ``sum/mean/max/min``, ``sm.dot``, reductions as ``sm.fuse``
roots and of pending deferred-eager chains, the torch façades, and the
whole slice (``bench.py``'s reduction workloads at small size).

The JAX side runs with ``kernel_backend = "pallas"``, so its reduction
kernels run in interpret mode (the dispatch counts prove it); the port's
CPU tensors take the map-reduce kernel's plain version, and its dispatch
names must match.  Tolerances are tests/test_reduce_axis.py's (rtol 2e-5,
atol 2e-5 to 2e-4) and tests/test_dot.py's (rtol 1e-6 to 1e-4); integer
results, the int32 dot and max/min are exact.  Expected dtypes come from
the JAX package.
"""

import numpy as np
import pytest
import torch

import simplemath_tpu as jsm
import simplemath_tpu_torch as sm
from simplemath_tpu.config import config as jconfig
from simplemath_tpu.ops import dispatch as jdispatch
from simplemath_tpu_torch import dtypes
from simplemath_tpu_torch.config import config
from simplemath_tpu_torch.ops import dispatch, elementwise, program, reduction


@pytest.fixture(autouse=True)
def _reference_setup():
    old = (jconfig.kernel_backend, jconfig.transcendental_impl,
           jconfig.deferred_eager, config.deferred_eager, config.device)
    jconfig.kernel_backend = "pallas"
    config.device = "cpu"  # the port's default device is the card
    jconfig.transcendental_impl = "crafted"
    dispatch.reset()
    jdispatch.reset()
    yield
    (jconfig.kernel_backend, jconfig.transcendental_impl,
     jconfig.deferred_eager, config.deferred_eager, config.device) = old


_KERNEL_KINDS = ("reduce", "reduce_fused", "reduce_axis", "dot1d", "elementwise")


def _kernel_counts(counts):
    return {k: v for k, v in counts.items() if k.split(":")[0] in _KERNEL_KINDS}


def _same_dtype(got, want):
    assert dtypes.name(got.dtype) == np.dtype(want.dtype).name, (got.dtype, want.dtype)


def _data(rng, dtype, shape):
    x = rng.standard_normal(shape)
    if dtype == "bool":
        return x > 0
    if dtype == "int32":
        return np.round(x * 50).astype(np.int32)
    if dtype == "uint32":
        return np.round(np.abs(x) * 50).astype(np.uint32)
    return x.astype(np.float64 if dtype == "float64" else np.float32)


def _arrays(x, dtype):
    if dtype == "bfloat16":
        return jsm.Array(x, dtype="bfloat16"), sm.Array(x, dtype="bfloat16")
    return jsm.Array(x), sm.Array(x)


def _close(got, want, kind="sum"):
    """Exact for max/min and integer and bool results; bf16 within its
    rounding (both sides accumulate in f32 and round once); f32 as
    test_reduce_axis.py."""
    g = np.asarray(got.numpy(), np.float64)
    w = np.asarray(want.numpy(), np.float64)
    assert g.shape == w.shape
    if kind in ("max", "min") or not got.dtype.is_floating_point:
        np.testing.assert_array_equal(g, w)
    elif got.dtype == torch.bfloat16:
        np.testing.assert_allclose(g, w, rtol=1e-2, atol=1e-2)
    elif got.dtype == torch.float64:
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)
    else:
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5)


# ------------------------------------------------------ Array reductions
_AXES = [None, 0, 1, -1, -2, (0, 1)]


@pytest.mark.parametrize("kind", ["sum", "mean", "max", "min"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64", "int32", "uint32", "bool"])
def test_reductions_match_jax(rng, dtype, kind):
    x = _data(rng, dtype, (33, 47))
    ja, pa = _arrays(x, dtype)
    for axis in _AXES:
        for keepdims in (False, True):
            jdispatch.reset()
            dispatch.reset()
            want = getattr(ja, kind)(axis=axis, keepdims=keepdims)
            got = getattr(pa, kind)(axis=axis, keepdims=keepdims)
            _same_dtype(got, want)
            _close(got, want, kind)
            if dtype == "float32" and not isinstance(axis, tuple):
                # The JAX package's Pallas reductions and the port's kernel
                # take the same calls, under the same names.
                assert _kernel_counts(dispatch.counts()) == _kernel_counts(jdispatch.counts())
    free = getattr(sm, kind)(pa, axis=1)
    _close(free, getattr(jsm, kind)(ja, axis=1), kind)


@pytest.mark.parametrize("dtype", ["uint8", "uint16", "uint32", "int8", "int16", "int32",
                                   "int64", "bool", "float16", "float32", "float64"])
def test_reduction_dtypes_match_jax(dtype):
    """Every reduction and façade gives jnp's result dtype under x64 (narrow
    integer sums and products widen to int64, unsigned ones to uint64)."""
    x = (np.arange(12).reshape(3, 4) % 5).astype(dtype)
    for f in (lambda m, a: a.sum(), lambda m, a: a.mean(axis=0), lambda m, a: a.max(),
              lambda m, a: a.min(axis=1), lambda m, a: m.prod(a), lambda m, a: m.cumsum(a),
              lambda m, a: m.var(a), lambda m, a: m.argmax(a, axis=1)):
        got, want = f(sm, sm.Array(x)), f(jsm, jsm.Array(x))
        _same_dtype(got, want)
        np.testing.assert_allclose(np.asarray(got.numpy(), np.float64),
                                   np.asarray(want.numpy(), np.float64), rtol=1e-3)


def test_float32_reductions_take_the_kernel_path(rng):
    a = sm.Array(rng.standard_normal((16, 24)).astype(np.float32))
    a.sum(), a.max(axis=0), a.mean(axis=-1), a.min()
    assert dispatch.counts() == {"reduce:sum": 1, "reduce_axis:max0": 1,
                                 "reduce_axis:sum1": 1, "reduce:min": 1}
    dispatch.reset()
    a.sum(keepdims=True), a.sum(axis=(0, 1))
    sm.Array(rng.standard_normal((2, 3, 4)).astype(np.float32)).sum(axis=1)
    assert dispatch.counts() == {"torch_path:sum": 3}


_VIEWS = {
    "T": lambda a: a.T,
    "negative-step": lambda a: a[::-1, ::-2],
    "row": lambda a: a[3],
    "offset": lambda a: a[1:, 2:],
}


@pytest.mark.parametrize("view", sorted(_VIEWS))
def test_reductions_of_views_read_in_place(rng, view):
    x = rng.standard_normal((40, 56)).astype(np.float32)
    jv, pv = _VIEWS[view](jsm.Array(x)), _VIEWS[view](sm.Array(x))
    axes = [None, 0, 1] if len(pv.shape) == 2 else [None]
    for kind in ("sum", "mean", "max", "min"):
        for axis in axes:
            jdispatch.reset()
            dispatch.reset()
            _close(getattr(pv, kind)(axis=axis), getattr(jv, kind)(axis=axis), kind)
            counts = dispatch.counts()
            assert counts == _kernel_counts(jdispatch.counts())
            assert not any(k.startswith(("elementwise", "torch_path")) for k in counts)


@pytest.mark.parametrize("n", [1, 5, 4096 * 3 + 777, 40_000])
def test_ragged_1d_reductions_match_jax_and_float64(rng, n):
    x = rng.standard_normal(n).astype(np.float32)
    ja, pa = jsm.Array(x), sm.Array(x)
    ref = {"sum": x.astype(np.float64).sum(), "mean": x.astype(np.float64).mean(),
           "max": x.max(), "min": x.min()}
    for kind, r in ref.items():
        got, want = getattr(pa, kind)(), getattr(ja, kind)()
        np.testing.assert_allclose(float(got), float(want.numpy()), rtol=2e-5, atol=2e-4)
        np.testing.assert_allclose(float(got), r, rtol=2e-5, atol=2e-4)
        assert got.shape == () and got.dtype == torch.float32


@pytest.mark.parametrize("kind", ["sum", "mean", "max", "min"])
def test_nan_propagates_like_jax(kind):
    x = np.linspace(-2, 2, 300, dtype=np.float32).reshape(20, 15)
    x[7, 4] = np.nan
    for axis in (None, 0, 1):
        got = getattr(sm.Array(x), kind)(axis=axis).numpy()
        want = np.asarray(getattr(jsm.Array(x), kind)(axis=axis).numpy())
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert np.isnan(got).any()


def test_empty_and_zero_d_reductions_match_jax():
    e = np.zeros((0,), np.float32)
    assert float(sm.Array(e).sum()) == float(jsm.Array(e).sum().numpy()) == 0.0
    assert np.isnan(float(sm.Array(e).mean())) and np.isnan(float(jsm.Array(e).mean().numpy()))
    for mod in (sm, jsm):
        with pytest.raises(ValueError, match="zero-size array"):
            mod.Array(e).max()
    s = np.float32(3.5)
    got, want = sm.Array(s).sum(), jsm.Array(s).sum()
    assert got.shape == () and float(got) == float(want.numpy()) == 3.5
    with pytest.raises(ValueError, match="out of bounds"):
        sm.Array(np.ones(4, np.float32)).sum(axis=1)


# ------------------------------------------------------------- the dot
def _dot_operands(rng, da, db, n):
    def one(d):
        if d == "bool":
            return rng.integers(0, 2, n).astype(bool)
        if d == "uint32":
            return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        if d == "int32":
            return rng.integers(-100, 100, n).astype(np.int32)
        return rng.standard_normal(n).astype(d)
    return one(da), one(db)


_DOTS = [
    ("float32", "float32", "dot1d"), ("int32", "int32", "dot1d"),
    ("float32", "int32", "dot1d"), ("int32", "bool", "dot1d"),
    ("uint32", "uint32", "torch_path:dot"), ("float64", "float64", "torch_path:dot"),
    ("bool", "bool", "torch_path:dot"),
]


@pytest.mark.parametrize("n", [8, 4096 * 3 + 777])
@pytest.mark.parametrize("da,db,path", _DOTS, ids=str)
def test_dot_1d_matches_jax(rng, da, db, path, n):
    a, b = _dot_operands(rng, da, db, n)
    want = jsm.dot(jsm.Array(a), jsm.Array(b))
    got = sm.dot(sm.Array(a), sm.Array(b))
    _same_dtype(got, want)
    assert dispatch.count(path) == 1
    if got.dtype.is_floating_point:
        np.testing.assert_allclose(float(got), float(want.numpy()), rtol=1e-5, atol=1e-4)
        ref = np.dot(a.astype(np.float64), b.astype(np.float64))
        np.testing.assert_allclose(float(got), ref, rtol=1e-5, atol=1e-4)
    else:
        assert got.item() == want.numpy().item()


def test_int32_dot_is_exact_and_wraps():
    """tests/test_int_compute.py's wraparound case: i32 accumulation wraps
    mod 2**32, as the reference's int32 SIMD accumulator does."""
    a = np.full(70_000, 40_000, np.int32)
    want = (np.int64(40_000) * 40_000 * 70_000) % (1 << 32)
    want = int(want - (1 << 32) if want >= 1 << 31 else want)
    got = sm.dot(sm.Array(a), sm.Array(a))
    assert got.dtype == torch.int32 and int(got) == want == int(jsm.dot(jsm.Array(a), jsm.Array(a)).numpy())
    u = np.array([4294967295, 3], np.uint32)
    assert int(sm.dot(sm.Array(u), sm.Array(u))) == int(jsm.dot(jsm.Array(u), jsm.Array(u)).numpy()) == 10


def test_int32_dot_float32_matches_jnp_dot(rng):
    """i32 . f32 gives f32 = jnp.dot's value.  (The JAX package's Pallas
    route fails on this order, so its XLA route is the reference here.)"""
    a = rng.integers(-50, 50, 1000).astype(np.int32)
    b = rng.standard_normal(1000).astype(np.float32)
    jconfig.kernel_backend = "auto"
    want = jsm.dot(jsm.Array(a), jsm.Array(b))
    got = sm.dot(sm.Array(a), sm.Array(b))
    _same_dtype(got, want)
    np.testing.assert_allclose(float(got), float(want.numpy()), rtol=1e-5, atol=1e-4)
    assert dispatch.count("dot1d") == 1


def test_dot_operator_forms_and_views(rng):
    x = rng.standard_normal((6, 64)).astype(np.float32)
    ja, pa = jsm.Array(x), sm.Array(x)
    cases = [
        lambda a: a[1] @ a[2], lambda a: a[1].dot(a[4]),
        lambda a: a[0, ::2] @ a[5, 1::2], lambda a: a[3, ::-1] @ a[2],
        lambda a: a.T[7] @ a.T[9], lambda a: a[2].__rmatmul__(a[0]),
    ]
    for f in cases:
        np.testing.assert_allclose(float(f(pa)), float(f(ja).numpy()), rtol=1e-6, atol=1e-5)
    assert dispatch.count("dot1d") == len(cases)
    assert not any(k.startswith("elementwise") for k in dispatch.counts())


def test_dot_errors_and_scalars_match_jax():
    for mod in (sm, jsm):
        with pytest.raises(TypeError, match="same shape"):
            mod.dot(mod.Array(np.ones(3, np.float32)), mod.Array(np.ones(4, np.float32)))
    # Rank >= 2 is ported (tests/test_torch_matmul.py holds its values); a
    # 1-D dot inside sm.fuse is refused by both packages.
    np.testing.assert_array_equal(sm.dot(sm.ones(2, 2), sm.ones(2, 2)).numpy(),
                                  jsm.dot(jsm.ones(2, 2), jsm.ones(2, 2)).numpy())
    for mod in (sm, jsm):
        with pytest.raises(TypeError, match="fused matmul requires 2-D"):
            mod.fuse(lambda x: mod.dot(x, x))(mod.ones(4))
    s, v = np.float32(2.0), np.arange(3, dtype=np.float32)
    np.testing.assert_array_equal(sm.dot(sm.Array(s), sm.Array(v)).numpy(),
                                  jsm.dot(jsm.Array(s), jsm.Array(v)).numpy())


# -------------------------------------------------- fused reductions
_FUSED = {
    "full": (lambda m: lambda x, y: m.sum(m.square(x - y)), "B"),
    "full_mean": (lambda m: lambda x, y: m.mean(m.exp(x) * y), "B"),
    "full_row": (lambda m: lambda x, w: m.sum(x * w), "row"),
    "full_scalar_max": (lambda m: lambda x, w: m.max(x * w), "one"),
    "axis1": (lambda m: lambda x, y: m.sum(m.square(x - y), axis=1), "B"),
    "axis0_mean": (lambda m: lambda x, y: m.mean(m.abs(x), axis=0), "B"),
    "row_max0": (lambda m: lambda x, w: m.max(x * w, axis=0), "row"),
    "col_sum1": (lambda m: lambda x, w: m.sum(x * w, axis=1), "col"),
    "col_min0": (lambda m: lambda x, w: m.min(x - w, axis=0), "col"),
    "keepdims": (lambda m: lambda x, y: m.sum(m.square(x), axis=1, keepdims=True), "B"),
    "negative_axis": (lambda m: lambda x, y: m.sum(x + y, axis=-1), "B"),
    "int_sum": (lambda m: lambda x, y: m.sum(x > y), "B"),
}


@pytest.mark.parametrize("case", sorted(_FUSED))
def test_fused_reductions_match_jax(rng, case):
    build, second = _FUSED[case]
    A = rng.standard_normal((48, 40)).astype(np.float32)
    y = {"B": rng.standard_normal((48, 40)), "row": rng.standard_normal((1, 40)),
         "col": rng.standard_normal((48, 1)), "one": np.full((1, 1), 1.5)}[second]
    y = y.astype(np.float32)
    want = jsm.fuse(build(jsm))(A, y)
    got = sm.fuse(build(sm))(A, y)
    _same_dtype(got, want)
    assert got.shape == tuple(np.shape(want.numpy()))
    np.testing.assert_allclose(np.asarray(got.numpy(), np.float64),
                               np.asarray(want.numpy(), np.float64), rtol=2e-5, atol=2e-4)
    counts = dispatch.counts()
    assert not any(k.startswith("elementwise") for k in counts)
    if case != "int_sum":
        assert sum(v for k, v in counts.items() if k.startswith("reduce")) == 1
        jk = _kernel_counts(jdispatch.counts())
        if jk:  # where the JAX package uses its kernel, the names agree
            assert _kernel_counts(counts) == jk


def test_fused_rank1_axis0_and_view_operands(rng):
    x = rng.standard_normal(512).astype(np.float32)
    f = lambda m: m.fuse(lambda a: m.sum(m.square(a), axis=0))  # noqa: E731
    np.testing.assert_allclose(float(f(sm)(x)), float(f(jsm)(x).numpy()), rtol=2e-5)
    base = rng.standard_normal((32, 48)).astype(np.float32)
    g = lambda m: m.fuse(lambda a, b: m.sum(a * b, axis=0))  # noqa: E731
    pv, jv = sm.Array(base), jsm.Array(base)
    got = g(sm)(pv.T, pv[:, ::-1].T)
    want = g(jsm)(jv.T, jv[:, ::-1].T)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()), rtol=2e-5, atol=2e-4)


_FUSE_ERRORS = [
    (lambda m: lambda x: m.sum(x, axis=(0, 1)), TypeError, "single int axis"),
    (lambda m: lambda x: m.sum(x, axis=0) + 1.0, TypeError, "cannot be composed"),
    (lambda m: lambda x: m.exp(m.sum(x)), TypeError, "cannot be composed"),
    (lambda m: lambda x: m.add(1.0, m.max(x)), TypeError, "cannot be composed"),
    (lambda m: lambda x: m.sum(m.sum(x, axis=0)), TypeError, "reduced again"),
    (lambda m: lambda x: m.sum(x, keepdims=True), TypeError, "without an axis"),
    (lambda m: lambda x: m.sum(x, axis=2), ValueError, "out of bounds"),
]


@pytest.mark.parametrize("k", range(len(_FUSE_ERRORS)))
def test_fused_reduction_errors_match_jax(k):
    build, exc, msg = _FUSE_ERRORS[k]
    for mod in (sm, jsm):
        with pytest.raises(exc, match=msg):
            mod.fuse(build(mod))(np.ones((4, 4), np.float32))
    for mod in (sm, jsm):
        with pytest.raises(ValueError, match="does not compose with a reduction root"):
            mod.fuse(lambda x: mod.sum(x), iterations=2)(np.ones((4, 4), np.float32))


# --------------------------------------------------- lazy reductions
@pytest.mark.parametrize("kind", ["sum", "mean", "max", "min"])
def test_lazy_chain_reduction_is_one_map_reduce(rng, kind):
    """tests/test_lazy.py's single-pass case: a reduction of a pending chain
    composes into ONE map-reduce and never flushes the chain."""
    a = rng.standard_normal((64, 96)).astype(np.float32)
    b = rng.standard_normal((64, 96)).astype(np.float32)
    got = getattr(sm, kind)(sm.square(sm.subtract(sm.Array(a), sm.Array(b))))
    want = getattr(jsm, kind)(jsm.square(jsm.subtract(jsm.Array(a), jsm.Array(b))))
    np.testing.assert_allclose(float(got), float(want.numpy()), rtol=2e-5, atol=2e-4)
    counts = dispatch.counts()
    assert counts.get(f"reduce_fused:{'sum' if kind == 'mean' else kind}") == 1, counts
    assert not any(k.startswith("elementwise") for k in counts), counts
    assert counts == jdispatch.counts()


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_lazy_chain_axis_reduction(rng, axis):
    a = rng.standard_normal((48, 40)).astype(np.float32)
    b = rng.standard_normal((48, 40)).astype(np.float32)
    x, y = sm.Array(a), sm.Array(b)
    chain = (x - y) * 2.0
    got = chain.mean(axis=axis, keepdims=True)
    want = ((jsm.Array(a) - jsm.Array(b)) * 2.0).mean(axis=axis, keepdims=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()), rtol=2e-5, atol=2e-4)
    assert dispatch.count("reduce_axis", f"sum{axis % 2}") == 1
    assert not any(k.startswith("elementwise") for k in dispatch.counts())
    # The chain itself stayed pending and still gives its values.
    np.testing.assert_array_equal(chain.numpy(), (a - b) * np.float32(2.0))
    assert dispatch.count("elementwise", "fused") == 1


def test_lazy_reductions_that_flush_first(rng):
    a = rng.standard_normal((4, 5, 6)).astype(np.float32)
    x = sm.Array(a) + 1.0
    np.testing.assert_allclose(x.sum(axis=1).numpy(), (a + 1).sum(axis=1), rtol=2e-5, atol=2e-5)
    assert dispatch.count("elementwise", "add") == 1 and dispatch.count("torch_path", "sum") == 1
    config.deferred_eager = False
    y = sm.Array(a[0]) * 2.0
    assert float(y.max()) == float((a[0] * 2).max())
    assert dispatch.count("reduce", "max") == 1


# ---------------------------------------------------------- façades
_FACADE_DTYPES = ["float32", "int32", "uint32", "bool"]


@pytest.mark.parametrize("dtype", _FACADE_DTYPES)
@pytest.mark.parametrize("name", ["prod", "var", "std", "argmax", "argmin", "cumsum"])
def test_facades_match_jax(rng, name, dtype):
    x = _data(rng, dtype, (6, 7))
    if name == "prod" and dtype != "bool":
        x = (x[:3, :4] % 7).astype(x.dtype) if dtype != "float32" else x[:3, :4]
    for axis in (None, 1):
        want = getattr(jsm, name)(jsm.Array(x), axis=axis)
        got = getattr(sm, name)(sm.Array(x), axis=axis)
        _same_dtype(got, want)
        np.testing.assert_allclose(np.asarray(got.numpy(), np.float64),
                                   np.asarray(want.numpy(), np.float64), rtol=1e-5, atol=1e-5)
    with pytest.raises(TypeError, match=f"sm.{name} is not supported inside sm.fuse"):
        sm.fuse(lambda a: getattr(sm, name)(a))(sm.Array(x))


def test_facade_options_match_jax(rng):
    x = rng.standard_normal((5, 8)).astype(np.float32)
    x[2, 3] = np.nan
    for f in (lambda m, a: m.argmax(a), lambda m, a: m.argmin(a, axis=1),
              lambda m, a: m.argmax(a, axis=0, keepdims=True),
              lambda m, a: m.var(a[:, :3], axis=0, ddof=1), lambda m, a: m.std(a[:2], ddof=1),
              lambda m, a: m.cumsum(a[:, :3], axis=0), lambda m, a: m.prod(a[:2], axis=1, keepdims=True)):
        got, want = f(sm, sm.Array(x)), f(jsm, jsm.Array(x))
        _same_dtype(got, want)
        np.testing.assert_allclose(np.asarray(got.numpy(), np.float64),
                                   np.asarray(want.numpy(), np.float64), rtol=1e-5, atol=1e-6)


# --------------------------------------------------------- the slice
def test_slice_bench_reduction_workloads(rng):
    """bench.py's reduction workloads at small size through the public API:
    ``Array.sum()`` (bench_reduce_sum), ``sm.dot`` (bench_dot1d), the fused
    squared distance with a 0-d ``eps`` operand (bench_fused_map_reduce) and
    the fused thresholded axis sums with a (1, 1) operand
    (bench_reduce_axis): the same values as the JAX package and float64,
    one reduction call each, no elementwise pass."""
    n = 40_000
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    eps = np.asarray(np.float32(1e-3))
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    m = rng.standard_normal((64, 96)).astype(np.float32)
    s = np.full((1, 1), 0.25, np.float32)
    dist = lambda mod: mod.fuse(lambda x, y, e: mod.sum(mod.square(x + e - y)))  # noqa: E731
    thr = lambda mod, ax: mod.fuse(lambda x, t: mod.sum(mod.where(x > t, x, 0.0), axis=ax))  # noqa: E731
    runs = [
        (lambda mod: mod.Array(a).sum(), a64.sum(), "reduce:sum"),
        (lambda mod: mod.dot(mod.Array(a), mod.Array(b)), a64 @ b64, "dot1d"),
        (lambda mod: dist(mod)(a, b, eps), ((a64 + 1e-3 - b64) ** 2).sum(), "reduce_fused:sum"),
        (lambda mod: thr(mod, 0)(m, s), np.where(m > 0.25, m, 0.0).astype(np.float64).sum(0),
         "reduce_axis:sum0"),
        (lambda mod: thr(mod, 1)(m, s), np.where(m > 0.25, m, 0.0).astype(np.float64).sum(1),
         "reduce_axis:sum1"),
    ]
    for run, ref, name in runs:
        dispatch.reset()
        jdispatch.reset()
        got, want = run(sm), run(jsm)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()), rtol=2e-5, atol=2e-4)
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-4)
        assert _kernel_counts(dispatch.counts()) == {name: 1} == _kernel_counts(jdispatch.counts())


def test_kernel_wrappers_need_cuda_or_raise():
    """On CPU tensors the wrappers run the plain version and launch
    nothing; on any other device they launch the kernel or raise."""
    reduction.reset_launches()
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    assert float(reduction.reduce(x, "sum")) == 66.0
    assert torch.equal(reduction.reduce_axis(x, "max", 0), x[2])
    assert int(reduction.dot1d(x[0].int(), x[1].int())) == int((x[0] * x[1]).sum())
    assert reduction.LAUNCHES == {"rd_full": 0, "rd_axis": 0}
    meta = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        reduction.reduce(meta, "sum")
    with pytest.raises(ValueError, match="unknown reduction"):
        reduction.reduce(x, "prod")
    with pytest.raises(ValueError, match="2-D expression"):
        reduction.reduce_axis(x.reshape(-1), "sum", 0)
    with pytest.raises(ValueError, match="non-empty"):
        reduction.reduce(torch.zeros(0), "sum")


# ------------------------------------------- the kernel's paths and grids
def _aligned(*shape, dtype=torch.float32):
    """A contiguous tensor of ``shape`` whose first element lies at a
    16-byte boundary."""
    n = int(np.prod(shape))
    base = torch.arange(n + 4, dtype=torch.float32).to(dtype)
    skip = (-base.data_ptr() // base.element_size()) % (16 // base.element_size())
    t = base[skip:skip + n].reshape(shape)
    assert t.data_ptr() % 16 == 0
    return t


def _lowered(fn, *operands):
    leaves = [program.leaf(tuple(o.shape), o.dtype) for o in operands]
    return program.lower(fn(*leaves), leaves)


def _path_cases():
    n, R, C = 1000, 24, 40
    a, b = _aligned(n), _aligned(n)
    ia, ib = _aligned(n, dtype=torch.int32), _aligned(n, dtype=torch.int32)
    eps = torch.tensor(1e-3)
    m = _aligned(R, C)
    wide = _aligned(R, C + 4)
    row, col, one = _aligned(1, C), _aligned(R, 1), _aligned(1, 1)
    mask = a > 3.0
    ident = reduction.identity(torch.float32)
    mul = lambda p, q: p * q  # noqa: E731
    thr = lambda p, s: sm.where(p > s, p, 0.0)  # noqa: E731
    shifted = elementwise.View(_aligned(n + 1), 1, (n,), (1,))
    bf16 = torch.bfloat16
    a16, b16 = _aligned(n, dtype=bf16), _aligned(n, dtype=bf16)
    m16, row16, col16 = _aligned(R, C, dtype=bf16), _aligned(1, C, dtype=bf16), _aligned(R, 1, dtype=bf16)
    shifted16 = elementwise.View(_aligned(n + 1, dtype=bf16), 1, (n,), (1,))
    ident16, ident_h = reduction.identity(bf16), reduction.identity(torch.float16)
    return {
        # rd_full
        "identity": (ident, "sum", (n,), [a], None, "direct"),
        "identity max": (ident, "max", (n,), [a], None, "direct"),
        "identity 2-D": (ident, "sum", (R, C), [m], None, "direct"),
        "dot f32": (_lowered(mul, a, b), "sum", (n,), [a, b], None, "single"),
        "dot int32": (_lowered(mul, ia, ib), "sum", (n,), [ia, ib], None, "single"),
        "a*b max": (_lowered(mul, a, b), "max", (n,), [a, b], None, "generated"),
        "a*scalar": (_lowered(mul, a, eps), "sum", (n,), [a, eps], None, "single"),
        "a*2.5": (_lowered(lambda p: p * 2.5, a), "sum", (n,), [a], None, "single"),
        "a>b": (_lowered(lambda p, q: p > q, a, b), "sum", (n,), [a, b], None, "single"),
        "exp": (_lowered(lambda p: sm.exp(p), a), "sum", (n,), [a], None, "generated"),
        "dot int32.f32": (_lowered(mul, ia, b), "sum", (n,), [ia, b], None, "generated"),
        "distance": (_lowered(lambda p, q, e: sm.square(p + e - q), a, b, eps), "sum", (n,),
                     [a, b, eps], None, "generated"),
        "thresholded": (_lowered(thr, a, eps), "sum", (n,), [a, eps], None, "generated"),
        "one element off": (ident, "sum", (n,), [shifted], None, "generated, gathered"),
        "dot, b one element off": (_lowered(mul, a, b), "sum", (n,), [a, shifted], None, "generated, gathered"),
        "transposed": (ident, "sum", (C, R), [elementwise.View(m, 0, (C, R), (1, C))], None,
                       "generated, gathered"),
        "negative step": (ident, "sum", (n,), [elementwise.View(a, n - 1, (n,), (-1,))], None,
                          "generated, gathered"),
        "bool operand": (_lowered(lambda k, p: sm.where(k, p, 0.0), mask, a), "sum", (n,),
                         [mask, a], None, "generated, gathered"),
        # rd_full over the rows of a 2-D expression with broadcast operands
        "full map row col": (_lowered(lambda p, r, c: sm.square(p * r - c), m, row, col), "sum",
                             (R, C), [m, row, col], None, "generated"),
        "full a*row": (_lowered(mul, m, row), "sum", (R, C), [m, row], None, "generated"),
        "full a*row, ragged rows": (_lowered(mul, _aligned(R, C - 1), _aligned(1, C - 1)), "sum",
                                    (R, C - 1), [_aligned(R, C - 1), _aligned(1, C - 1)], None,
                                    "generated, gathered"),
        # rd_axis
        "axis 0 identity": (ident, "sum", (R, C), [m], 0, "direct"),
        "axis 1 identity min": (ident, "min", (R, C), [m], 1, "direct"),
        "axis 0 a*row": (_lowered(mul, m, row), "sum", (R, C), [m, row], 0, "single"),
        "axis 1 col-a": (_lowered(lambda c, p: c - p, col, m), "sum", (R, C), [col, m], 1,
                         "single"),
        "axis 0 a*(1,1)": (_lowered(mul, m, one), "sum", (R, C), [m, one], 0, "single"),
        "axis 1 thresholded (1,1)": (_lowered(thr, m, one), "sum", (R, C), [m, one], 1, "generated"),
        "axis 0 map row col": (_lowered(lambda p, r, c: sm.square(p * r - c), m, row, col), "max",
                               (R, C), [m, row, col], 0, "generated"),
        "axis 0 rows of a wider base": (ident, "sum", (R, C), [wide[:, :C]], 0, "direct"),
        "axis 1 ragged columns": (ident, "sum", (R, C - 1), [_aligned(R, C - 1)], 1, "generated, gathered"),
        "axis 1 ragged columns, aligned rows": (ident, "sum", (R, C - 1), [m[:, :C - 1]], 1,
                                                "direct"),
        "axis 0 one column off": (ident, "sum", (R, C), [wide[:, 1:C + 1]], 0, "generated, gathered"),
        "axis 0 transposed": (ident, "sum", (C, R), [elementwise.View(m, 0, (C, R), (1, C))], 0,
                              "generated, gathered"),
        "axis 1 negative step": (ident, "sum", (R // 2, C // 2),
                                 [elementwise.View(m, R * C - 1, (R // 2, C // 2), (-2 * C, -2))],
                                 1, "generated, gathered"),
        # 2-byte operands: a quad is one 8-byte load where the operand is
        # 8-byte aligned and, along rows, its rows are whole quads.
        "bf16 identity": (ident16, "sum", (n,), [a16], None, "direct"),
        "bf16 identity, ragged": (ident16, "sum", (n - 3,), [_aligned(n - 3, dtype=bf16)], None,
                                  "direct"),
        "bf16 identity 8 bytes off": (ident16, "sum", (n - 4,), [a16[4:]], None, "direct"),
        "bf16 a*b": (_lowered(mul, a16, b16), "sum", (n,), [a16, b16], None, "single"),
        "bf16 a*2.5": (_lowered(lambda p: p * 2.5, a16), "sum", (n,), [a16], None, "single"),
        "bf16 a*b max": (_lowered(mul, a16, b16), "max", (n,), [a16, b16], None, "generated"),
        "bf16 exp": (_lowered(lambda p: sm.exp(p), a16), "sum", (n,), [a16], None, "generated"),
        "bf16 axis 0 (1, C) row": (ident16, "sum", (1, C), [row16], 0, "direct"),
        "bf16 axis 0 a*row": (_lowered(mul, m16, row16), "sum", (R, C), [m16, row16], 0,
                              "single"),
        "bf16 axis 1 identity": (ident16, "sum", (R, C), [m16], 1, "direct"),
        "bf16 axis 0 identity max": (ident16, "max", (R, C), [m16], 0, "direct"),
        "bf16 full map row col": (_lowered(lambda p, r, c: sm.square(p * r - c), m16, row16, col16),
                                  "sum", (R, C), [m16, row16, col16], None, "generated"),
        "bf16 one element off": (ident16, "sum", (n,), [shifted16], None, "generated, gathered"),
        "bf16 a*b, b one element off": (_lowered(mul, a16, b16), "sum", (n,), [a16, shifted16],
                                        None, "generated, gathered"),
        "bf16 axis 1 ragged columns": (ident16, "sum", (R, C - 1), [_aligned(R, C - 1, dtype=bf16)],
                                       1, "generated, gathered"),
        "bf16 axis 0 ragged columns": (ident16, "sum", (R, C - 2), [_aligned(R, C - 2, dtype=bf16)],
                                       0, "generated, gathered"),
        "bf16 axis 1 ragged columns, aligned rows": (ident16, "sum", (R, C - 1), [m16[:, :C - 1]],
                                                     1, "direct"),
        "f32 * bf16": (_lowered(mul, a, b16), "sum", (n,), [a, b16], None, "generated"),
        "f32 * bf16 axis 1": (_lowered(mul, m, m16), "sum", (R, C), [m, m16], 1, "generated"),
        "f32 * bf16, bf16 one element off": (_lowered(mul, a, b16), "sum", (n,), [a, shifted16],
                                             None, "generated, gathered"),
        "f16 identity": (ident_h, "sum", (n,), [_aligned(n, dtype=torch.float16)], None, "direct"),
        "f16 identity min": (ident_h, "min", (n,), [_aligned(n, dtype=torch.float16)], None,
                             "direct"),
        "f16 axis 1": (ident_h, "sum", (R, C), [_aligned(R, C, dtype=torch.float16)], 1, "direct"),
        "f16 one element off": (ident_h, "sum", (n,),
                                [elementwise.View(_aligned(n + 1, dtype=torch.float16), 1, (n,),
                                                  (1,))], None, "generated, gathered"),
    }


@pytest.mark.parametrize("case", sorted(_path_cases()))
def test_path_table(case):
    """``reduction.path`` decides from the program, the reduction, the shape
    and the operands' layouts alone how the kernel evaluates a launch, and
    ``reduction.walk`` whether a generated evaluator gathers its operands;
    and on these CPU tensors the wrappers give the plain version's values
    and count nothing."""
    prog, kind, shape, operands, axis, want = _path_cases()[case]
    where = reduction.layout(operands)
    assert reduction.path(prog, kind, shape, where, axis) == want.split(",")[0]
    assert reduction.walk(shape, where, axis)[1] is want.endswith("gathered")
    reduction.reset_launches()
    if axis is None:
        got = reduction.map_reduce(prog, kind, shape, *operands) if prog.dtype != torch.int32 \
            else reduction.dot1d(*operands)
    else:
        got = reduction.map_reduce_axis(prog, kind, axis, shape, *operands)
    vals = reduction.values(prog, shape, operands, torch.device("cpu"))
    ref = {"sum": np.sum, "max": np.max, "min": np.min}[kind](
        vals.double().numpy(), axis=axis)
    np.testing.assert_allclose(got.double().numpy(), ref, rtol=2e-5, atol=2e-4)
    assert not any(reduction.LAUNCHES.values()) and not any(reduction.PATHS.values())


def test_reach_of_the_operands():
    """flat data, the rows of a 2-D expression, or a gather: what ``path``
    builds on."""
    m, row, col = _aligned(24, 40), _aligned(1, 40), _aligned(24, 1)
    where = reduction.layout
    assert reduction.reach((24, 40), where([m])) == "flat"
    assert reduction.reach((24, 40), where([m]), axis=0) == "rows"
    assert reduction.reach((24, 40), where([m, row, col])) == "rows"
    assert reduction.reach((24, 40), where([m, torch.tensor(2.0)])) == "flat"
    assert reduction.reach((40, 24), where([elementwise.View(m, 0, (40, 24), (1, 40))])) == "gather"
    assert reduction.reach((2, 12, 40), where([_aligned(2, 12, 40), _aligned(1, 1, 40)])) == "gather"


def test_hoisted_opcodes_are_the_cheap_ones():
    """The hoisted loop takes every opcode but the transcendental and
    trigonometric functions, the integer power, and the unsigned, bit-copy
    and integer-division opcodes."""
    left = {program.OPCODES[i] for i in range(len(program.OPCODES)) if i not in reduction.HOISTED}
    assert left == {"EXP_F", "LOG_F", "EXP2_F", "LOG2_F", "TANH_F", "SIN_F", "COS_F", "TAN_F",
                    "POW_F", "IPOW_I", "LT_U", "LE_U", "GT_U", "GE_U", "MAX_U", "MIN_U",
                    "SIGN_U", "U2F", "F2U", "BITS", "FDIV_I", "MOD_I", "FDIV_U", "MOD_U"}


_GRID_SHAPES = [(1, 1), (7, 5), (1, 64), (64, 1), (2048, 8), (300, 257), (33, 128), (65, 132),
                (40, 1025), (1, 100_000), (100_000, 3), (5000, 4096), (8192, 8192)]


@pytest.mark.parametrize("shape", _GRID_SHAPES, ids=str)
def test_axis_grids_cover_every_row_and_column_once(shape):
    """The walks of csrc/reduction.cuh, modelled on the grids ``axis_grid``
    gives: every row and every column is taken exactly once, and the grid
    depends on the shape alone."""
    rows, cols = shape
    quads = -(-cols // 4)
    # Axis 0: block (x, y) is 32 quads of columns by 8 row lanes (warps)
    # over rows [y * seg_rows, (y + 1) * seg_rows).
    segs, seg_rows = reduction.axis_grid(rows, cols, 0)
    assert (segs, seg_rows) == reduction.axis_grid(rows, cols, 0)
    assert 1 <= segs <= 65535 and seg_rows % 32 == 0
    taken = np.zeros(rows, np.int64)
    for y in range(segs):
        lo, hi = y * seg_rows, min((y + 1) * seg_rows, rows)
        assert lo < hi
        for warp in range(8):
            taken[lo + warp:hi:8] += 1
    assert (taken == 1).all()
    col_blocks = -(-quads // 32)
    columns = np.arange(col_blocks * 32 * 4).reshape(col_blocks, 32, 4)
    assert np.array_equal(columns[columns < cols], np.arange(cols))
    # Axis 1: a block takes 1 row at a time, or 8 (a warp each) where a row
    # has at most 32 quads; blocks stride over the rows.
    blocks, per_block = reduction.axis_grid(rows, cols, 1)
    assert per_block == (8 if quads <= 32 else 1) and 1 <= blocks <= 8 * reduction._MAX_BLOCKS
    stride = blocks * per_block
    first = (np.arange(blocks)[:, None] * per_block + np.arange(per_block)[None, :]).ravel()
    took = first[:, None] + stride * np.arange(-(-rows // stride))[None, :]
    taken = np.bincount(took[took < rows], minlength=rows)
    assert (taken == 1).all() and (blocks - 1) * per_block < rows


@pytest.mark.parametrize("n", [1, 3, 4, 5, 1023, 1024, 4096 * 3 + 777, 1_000_000, 64 * 1024 * 1024])
def test_full_grid_covers_every_quad_once(n):
    """rd_full: thread t of ``full_blocks(n)`` blocks of 256 owns quads
    t, t + T, ...: every element once, no block idle, the grid a function of
    ``n`` alone."""
    blocks = reduction.full_blocks(n)
    quads = -(-n // 4)
    assert blocks == reduction.full_blocks(n) and 1 <= blocks <= reduction._MAX_BLOCKS
    assert (blocks - 1) * 256 < quads  # the last block has a quad
    threads = blocks * 256
    owned = -(-(quads - np.arange(min(threads, quads))) // threads)  # quads per thread
    assert owned.sum() == quads and owned.min() >= 1


def test_ops_package_exposes_what_the_reference_does():
    import simplemath_tpu.ops as jops
    import simplemath_tpu_torch.ops as pops

    for name in ("elementwise", "engine", "matmul", "reduction", "registry", "transcendental"):
        assert hasattr(jops, name) and hasattr(pops, name), name


# ------------------------------------------- bfloat16 and float16 inputs
def _half_ulps(got, want, dtype):
    """Distance in units of the type's spacing at ``want`` (the values are
    sums accumulated in float32 and rounded once)."""
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    eps = 2.0 ** (-7 if dtype == "bfloat16" else -10)
    return float((np.abs(g - w) / np.maximum(np.abs(w) * eps, 1e-30)).max(initial=0.0))


@pytest.mark.parametrize("kind", ["sum", "mean", "max", "min"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_half_precision_reductions_take_the_kernel(rng, dtype, kind):
    """bfloat16 and float16 full and axis reductions run the map-reduce
    kernel (float32 accumulation, the result cast to the input's type), as
    the JAX package sends them to its Pallas reductions: the same dispatch
    names, no plain torch, and the JAX package's values within one unit of
    the type's spacing (the two float32 sums round alike but for order);
    max and min exactly."""
    x = rng.standard_normal((33, 47)).astype(np.float32)
    ja, pa = jsm.Array(x, dtype=dtype), sm.Array(x, dtype=dtype)
    for axis in (None, 0, 1, -1):
        jdispatch.reset()
        dispatch.reset()
        want = getattr(ja, kind)(axis=axis)
        got = getattr(pa, kind)(axis=axis)
        _same_dtype(got, want)
        assert _kernel_counts(dispatch.counts()) == _kernel_counts(jdispatch.counts())
        assert not any(k.startswith("torch_path") for k in dispatch.counts())
        g, w = got.numpy().astype(np.float64), np.asarray(want.numpy(), np.float64)
        if kind in ("max", "min"):
            np.testing.assert_array_equal(g, w)
        else:
            assert _half_ulps(g, w, dtype) <= 1.0


def test_bfloat16_dot_runs_the_kernel(rng):
    """The 1-D dot of bfloat16 vectors: float32 products summed in float32
    (``_build_dot1d``), the result bfloat16, through dot1d."""
    a, b = (rng.standard_normal(4096 * 3 + 777).astype(np.float32) for _ in range(2))
    want = jsm.dot(jsm.Array(a, dtype="bfloat16"), jsm.Array(b, dtype="bfloat16"))
    got = sm.dot(sm.Array(a, dtype="bfloat16"), sm.Array(b, dtype="bfloat16"))
    _same_dtype(got, want)
    assert dispatch.count("dot1d") == 1 and not any(
        k.startswith("torch_path") for k in dispatch.counts())
    assert _half_ulps(float(got), float(np.asarray(want.numpy(), np.float64)), "bfloat16") <= 1.0
