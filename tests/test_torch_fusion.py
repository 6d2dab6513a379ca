"""``sm.fuse`` and the deferred-eager queue of the port against the JAX
package's, and the whole slice: BASELINE.json configs[1]'s fused
broadcast+pow+exp recurrence (bench.py::bench_fused_pipeline) at 64x64.

The JAX side runs its Pallas kernels in interpret mode
(``kernel_backend = "pallas"``, as tests/test_fusion.py does) with the
crafted transcendentals the port uses.  Tolerance: 8 ulp for a chain.
Each crafted op is within 2 ulp of the JAX function run op by op
(tests/test_torch_ops.py), but the JAX side compiles the chain, and XLA:CPU
contracts its multiply-adds into FMAs, which moves each op by up to ~2 ulp;
exp(pow(.)) then scales the relative error of its argument by |pow| <= 4.
Every chain is also held to float64.
"""

import numpy as np
import pytest
import torch

import simplemath_tpu as jsm
import simplemath_tpu_torch as sm
from simplemath_tpu.config import config as jconfig
from simplemath_tpu.ops import dispatch as jdispatch
from simplemath_tpu_torch.config import config
from simplemath_tpu_torch.ops import dispatch, elementwise


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


def max_ulp(got, want):
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    same = (g == w) | (np.isnan(g) & np.isnan(w))
    sp = np.spacing(np.abs(w).astype(np.float32)).astype(np.float64)
    with np.errstate(invalid="ignore"):
        d = np.where(same, 0.0, np.abs(g - w) / sp)
    return float(np.nan_to_num(d, nan=np.inf).max(initial=0.0))


_CHAIN_ULP = 8.0


def _ew(counts):
    return {k: v for k, v in counts.items() if k.split(":")[0] in ("engine", "elementwise")}


def _chain(mod):
    def chain(acc, a, e_row):
        return acc * np.float32(1e-3) + mod.exp(mod.pow(a + acc * np.float32(1e-6), e_row))

    return chain


@pytest.mark.parametrize("iterations", [1, 8])
def test_fused_pipeline_slice_matches_jax(rng, iterations):
    """The whole slice at 64x64: public API -> fuse -> one launch."""
    n = 64
    a = rng.uniform(0.5, 2.0, (n, n)).astype(np.float32)
    e = rng.uniform(-2.0, 2.0, (1, n)).astype(np.float32)
    acc = rng.uniform(0.0, 1.0, (n, n)).astype(np.float32)
    p_acc = sm.Array(acc)
    got = sm.fuse(_chain(sm), donate=0, iterations=iterations)(p_acc, sm.Array(a), sm.Array(e))
    j_acc = jsm.Array(acc)
    want = jsm.fuse(_chain(jsm), donate=0, iterations=iterations)(j_acc, jsm.Array(a), jsm.Array(e))
    assert got.shape == (n, n) and got.dtype == torch.float32
    assert max_ulp(got.numpy(), want.numpy()) <= _CHAIN_ULP
    assert _ew(dispatch.counts()) == _ew(jdispatch.counts()) == {"elementwise:fused": 1}
    ref = acc.astype(np.float64)
    for _ in range(iterations):
        ref = ref * 1e-3 + np.exp(np.power(a + ref * 1e-6, e.astype(np.float64)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5)
    # donate=0 leaves the caller's array unchanged, in both packages.
    np.testing.assert_array_equal(p_acc.numpy(), acc)
    np.testing.assert_array_equal(j_acc.numpy(), acc)


@pytest.mark.parametrize("view", ["transposed", "negative-step", "row"])
def test_fused_view_operands_match_jax(rng, view):
    base = rng.uniform(0.5, 2.0, (32, 48)).astype(np.float32)
    e = rng.uniform(-1.0, 1.0, (1, 48)).astype(np.float32)
    take = {"transposed": lambda x: x[:, :32].T,
            "negative-step": lambda x: x[::-1, ::-1],
            "row": lambda x: x[3:4, :]}[view]
    pv, jv = take(sm.Array(base)), take(jsm.Array(base))
    ev = e[:, : pv.shape[1]]
    f = lambda x, y: sm.exp(sm.pow(x, y)) * x  # noqa: E731
    jf = lambda x, y: jsm.exp(jsm.pow(x, y)) * x  # noqa: E731
    got = sm.fuse(f)(pv, sm.Array(ev))
    want = jsm.fuse(jf)(jv, jsm.Array(ev))
    assert max_ulp(got.numpy(), want.numpy()) <= _CHAIN_ULP
    x = pv.numpy().astype(np.float64)
    np.testing.assert_allclose(got.numpy(), np.exp(np.power(x, ev)) * x, rtol=2e-5)


def test_fuse_caches_per_signature(rng):
    f = sm.fuse(lambda x, y: x * y + 1.0)
    a = rng.standard_normal((4, 8)).astype(np.float32)
    for shape in [(4, 8), (4, 8), (1, 8)]:
        b = rng.standard_normal(shape).astype(np.float32)
        np.testing.assert_array_equal(f(a, b).numpy(), a * b + np.float32(1.0))
    assert dispatch.count("elementwise", "fused") == 3


def test_fuse_errors_match_jax():
    a = sm.ones(4, 4)
    row = sm.ones(1, 4)
    with pytest.raises(ValueError, match="iterations must be >= 1"):
        sm.fuse(lambda x: x, iterations=0)
    with pytest.raises(TypeError, match="must return a fused expression"):
        sm.fuse(lambda x: 3.0)(a)
    with pytest.raises(ValueError, match="must match carry"):
        sm.fuse(lambda x, y: x + y, iterations=2, carry=1)(a, row)
    with pytest.raises(TypeError, match="only accept Python scalars"):
        sm.fuse(lambda x: x + np.ones(4, np.float32))(a)
    with pytest.raises(ValueError, match="donated operand 1 must match"):
        sm.fuse(lambda x, y: x + y, donate=1)(a, row)
    with pytest.raises(ValueError, match="could not be broadcast"):
        sm.fuse(lambda x, y: x + y)(a, sm.ones(3))
    with pytest.raises(TypeError, match="no truth value"):
        sm.fuse(lambda x: x if x > 0 else -x)(a)


def test_fused_reduction_and_matmul_wait():
    """Neither root waits any more.  The matmul root takes two direct
    arguments and refuses an operand that is also used elementwise, as in
    the JAX package (tests/test_torch_matmul.py holds its values); the
    reduction root takes only fused expressions
    (tests/test_torch_reduction.py holds its values)."""
    from simplemath_tpu.ops import fusion as jfusion
    from simplemath_tpu_torch.ops import fusion

    a = sm.ones(4, 4)
    assert float(sm.fuse(lambda x, w: x @ w)(a, a).sum()) == 64.0
    assert dispatch.count("matmul", "mm_epilogue") == 1
    for mod, arr in ((sm, a), (jsm, jsm.ones(4, 4))):
        with pytest.raises(TypeError, match="used elementwise"):
            mod.fuse(lambda x, w: (x @ w) + x)(arr, arr)
    for mod, arr in ((fusion, a), (jfusion, jsm.ones(4, 4))):
        with pytest.raises(TypeError, match="requires a fused expression"):
            mod.reduce_node("sum", arr)
    assert float(sm.fuse(lambda x: sm.sum(x * 2.0))(a)) == 32.0
    assert dispatch.count("reduce_fused", "sum") == 1


def test_fused_static_and_integer_pow(rng):
    x = rng.uniform(0.5, 2.0, (8, 16)).astype(np.float32)
    i = rng.integers(-3, 4, (8, 16)).astype(np.int32)
    k = rng.integers(-2, 6, (1, 16)).astype(np.int32)
    got = sm.fuse(lambda a, b, c: sm.pow(a, -3) + sm.pow(a, 2) + sm.pow(b, c))(x, i, k)
    want = jsm.fuse(lambda a, b, c: jsm.pow(a, -3) + jsm.pow(a, 2) + jsm.pow(b, c))(x, i, k)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-7)


# ------------------------------------------------------------ lazy queue
def _lazy_program(mod, a, b):
    c = (a + b) * a - b
    d = mod.exp(c)
    return mod.maximum(d, a) / b


@pytest.mark.parametrize("deferred", [True, False])
def test_lazy_chain_values_and_counts_match_jax(rng, deferred):
    a = rng.uniform(0.5, 1.5, (16, 32)).astype(np.float32)
    b = rng.uniform(0.5, 1.5, (16, 32)).astype(np.float32)
    config.deferred_eager = deferred
    jconfig.deferred_eager = deferred
    got = _lazy_program(sm, sm.Array(a), sm.Array(b)).numpy()
    want = _lazy_program(jsm, jsm.Array(a), jsm.Array(b)).numpy()
    assert max_ulp(got, want) <= _CHAIN_ULP
    ref = _lazy_program(np, a.astype(np.float64), b.astype(np.float64))
    np.testing.assert_allclose(got, ref, rtol=2e-6)
    assert _ew(dispatch.counts()) == _ew(jdispatch.counts())
    assert dispatch.count("elementwise", "fused") == (1 if deferred else 0)


def test_lazy_single_op_keeps_its_name_and_weak_scalars(rng):
    a = rng.integers(0, 9, 10).astype(np.int32)
    pa, ja = sm.Array(a), jsm.Array(a)
    got, want = pa + 1.5, ja + 1.5
    assert str(got.dtype) == "torch.float64" and want.dtype == np.float64
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert dispatch.count("torch_path", "add") == 1  # float64: not a kernel dtype
    f = sm.Array(a.astype(np.float32))
    np.testing.assert_array_equal((f * 2).numpy(), a.astype(np.float32) * 2)
    assert dispatch.count("elementwise", "multiply") == 1


def test_lazy_chain_flushes_past_its_bounds(rng):
    a = rng.standard_normal(64).astype(np.float32)
    x = sm.Array(a)
    want = a.copy()
    for k in range(80):
        x = x + np.float32(k)
        want = want + np.float32(k)
    np.testing.assert_array_equal(x.numpy(), want)
    assert dispatch.count("elementwise", "fused") >= 2


def test_kernel_path_needs_cuda_or_raises():
    """On a CPU tensor the wrapper runs the plain version; on any other
    device it launches the kernel or raises, never falls back."""
    from simplemath_tpu_torch.ops import program

    la = program.leaf((4,), torch.float32)
    prog = program.lower(la + 1.0, [la])
    before = dict(elementwise.LAUNCHES)
    out = elementwise.elementwise(prog, (4,), torch.float32, torch.zeros(4))
    np.testing.assert_array_equal(out.numpy(), np.ones(4, np.float32))
    assert elementwise.LAUNCHES == before  # the plain version launches nothing
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        elementwise.elementwise(prog, (4,), torch.float32, torch.zeros(4, device="meta"))
    lf = program.leaf((4,), torch.float64)
    prog64 = program.lower(lf + 1.0, [lf])
    with pytest.raises(ValueError, match="program writes"):
        elementwise.elementwise(prog64, (4,), torch.float32, torch.zeros(4, dtype=torch.float64))
    with pytest.raises(ValueError, match="program reads"):
        elementwise.elementwise(prog, (4,), torch.float32, torch.zeros(4, dtype=torch.int32))
