"""The quad paths of the elementwise and map-reduce kernels for 2-byte
operands, on the CPU.

``ew_flat`` reads whole quads of four elements where every full-size
operand and the result allow it (``elementwise.flat_path``: ``"wide"``),
each operand at its own width: one 16-byte load of a 4-byte type, one
8-byte load of a bfloat16 widened in registers; else every element on its
own (``"element"``).  ``reduction.path`` decides the same for ``rd_*``
(tests/test_torch_reduction.py holds its table).  Held here: ``flat_path``
on every kind of layout, and the bfloat16 adds and the bfloat16 and
float16 sums at ragged lengths against the JAX package (the port's plain
versions, which these CPU tensors take; the JAX package's Pallas kernels in
interpret mode, as its own tests run them).  The kernels themselves run,
against their element paths bit for bit, on the card
(tests/test_torch_kernel_cuda.py).

Tolerances: the add exact (one float32 add rounded once on both sides);
sums within one unit of the type's spacing of the JAX package's (both
accumulate in float32 and round once, in other orders), as
tests/test_torch_reduction.py holds them.
"""

import numpy as np
import pytest
import torch

import simplemath_tpu as jsm
import simplemath_tpu_torch as sm
from simplemath_tpu.config import config as jconfig
from simplemath_tpu_torch.config import config
from simplemath_tpu_torch.ops import elementwise, program, reduction


@pytest.fixture(autouse=True)
def _reference_setup():
    old = (jconfig.kernel_backend, config.device)
    jconfig.kernel_backend = "pallas"
    config.device = "cpu"  # the port's default device is the card
    yield
    jconfig.kernel_backend, config.device = old


def _aligned(*shape, dtype=torch.bfloat16):
    """A contiguous tensor of ``shape`` whose first element lies at a
    16-byte boundary."""
    n = int(np.prod(shape))
    base = torch.arange(n + 8, dtype=torch.float32).to(dtype)
    skip = (-base.data_ptr() // base.element_size()) % (16 // base.element_size())
    t = base[skip:skip + n].reshape(shape)
    assert t.data_ptr() % 16 == 0
    return t


def _lowered(fn, *operands):
    leaves = [program.leaf(tuple(o.shape), o.dtype) for o in operands]
    return program.lower(fn(*leaves), leaves)


def _flat_cases():
    n, R, C = 1000, 24, 40
    bf16 = torch.bfloat16
    a, b = _aligned(n), _aligned(n)
    f, i, u = (_aligned(n, dtype=dt) for dt in (torch.float32, torch.int32, torch.uint32))
    base = _aligned(n + 8)
    add = lambda p, q: p + q  # noqa: E731
    return {
        "bf16 add": (_lowered(add, a, b), (n,), [a, b], "wide"),
        "bf16 add, ragged": (_lowered(add, a[:n - 3], b[:n - 3]), (n - 3,), [a[:n - 3], b[:n - 3]],
                             "wide"),
        "bf16 add, 8 bytes off": (_lowered(add, base[4:n + 4], b), (n,), [base[4:n + 4], b], "wide"),
        "bf16 add, 2 bytes off": (_lowered(add, base[1:n + 1], b), (n,), [base[1:n + 1], b],
                                  "element"),
        "bf16 add, a View 2 bytes off": (_lowered(add, a, b), (n,),
                                         [elementwise.View(base, 1, (n,), (1,)), b], "element"),
        "bf16 * 2.5": (_lowered(lambda p: p * 2.5, a), (n,), [a], "wide"),
        "bf16 scalar - bf16": (_lowered(lambda s, p: s - p, a[:1].reshape(()), b), (n,),
                               [a[:1].reshape(()), b], "wide"),
        "bf16 chain": (_lowered(lambda p, q: (p + q) * p - q, a, b), (n,), [a, b], "wide"),
        "bf16 + f32": (_lowered(add, a, f), (n,), [a, f], "wide"),
        "f32 + bf16 2 bytes off": (_lowered(add, f, base[1:n + 1]), (n,), [f, base[1:n + 1]],
                                   "element"),
        "bf16 > bf16 (bool result)": (_lowered(lambda p, q: p > q, a, b), (n,), [a, b], "element"),
        "where(bool, bf16, bf16)": (_lowered(lambda k, p, q: sm.where(k, p, q), a > b, a, b), (n,),
                                    [a > b, a, b], "element"),
        "f32 add": (_lowered(add, f, f), (n,), [f, f], "wide"),
        "f32 add, 4 bytes off": (_lowered(add, f[1:], f[:n - 1]), (n - 1,), [f[1:], f[:n - 1]],
                                 "element"),
        "int32 add": (_lowered(add, i, i), (n,), [i, i], "wide"),
        "uint32 add": (_lowered(add, u, u), (n,), [u, u], "wide"),
        "bf16 2-D": (_lowered(add, _aligned(R, C), _aligned(R, C)), (R, C),
                     [_aligned(R, C), _aligned(R, C)], "wide"),
        "bf16 + (1, C) row": (_lowered(add, _aligned(R, C), _aligned(1, C)), (R, C),
                              [_aligned(R, C), _aligned(1, C)], None),
        "bf16 transposed": (_lowered(add, _aligned(C, R).T, _aligned(R, C)), (R, C),
                            [_aligned(C, R).T, _aligned(R, C)], None),
    }


@pytest.mark.parametrize("case", sorted(_flat_cases()))
def test_flat_path_table(case):
    """``elementwise.flat_path`` decides from the program, the shape and the
    operands' layouts alone whether ``ew_flat`` reads whole quads; on these
    CPU tensors the wrapper gives the plain version's values and counts no
    launch."""
    prog, shape, operands, want = _flat_cases()[case]
    assert elementwise.flat_path(prog, shape, elementwise.layout(operands)) == want
    elementwise.reset_launches()
    got = elementwise.elementwise(prog, shape, prog.dtype, *operands)
    ref = program.run_plain(prog, [elementwise.read(o) for o in operands], shape)
    assert got.dtype == ref.dtype and torch.equal(got, ref)
    assert not any(elementwise.LAUNCHES.values()) and not any(elementwise.FLAT_PATHS.values())


def _half_ulps(got, want, dtype):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    eps = 2.0 ** (-7 if dtype == "bfloat16" else -10)
    return float((np.abs(g - w) / np.maximum(np.abs(w) * eps, 1e-30)).max(initial=0.0))


@pytest.mark.parametrize("r", range(8))
def test_bfloat16_add_at_ragged_lengths_matches_jax(rng, r):
    """The bfloat16 add of n = 1000 + r elements (n % 8 = r): the JAX
    package's bits, the float32 sum rounded once; the card's wide path takes
    it (the last n % 4 elements one by one)."""
    n = 1000 + r
    x, y = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    x[:3] = [np.inf, np.nan, -0.0]
    pa, pb = sm.Array(x, dtype="bfloat16"), sm.Array(y, dtype="bfloat16")
    got = pa + pb
    want = jsm.Array(x, dtype="bfloat16") + jsm.Array(y, dtype="bfloat16")
    np.testing.assert_array_equal(got.numpy().astype(np.float64),
                                  np.asarray(want.numpy(), np.float64))
    prog = _lowered(lambda p, q: p + q, pa.torch(), pb.torch())
    where = elementwise.layout([pa.torch(), pb.torch()])
    assert elementwise.flat_path(prog, (n,), where) == (
        "wide" if all(elementwise.quad_aligned(torch.bfloat16, w[3]) for w in where) else "element")


@pytest.mark.parametrize("r", range(8))
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_half_sums_at_ragged_lengths_match_jax(rng, dtype, r):
    """``Array.sum()`` of n = 4096 + r elements and the axis sums of a
    (13, 4 * 11 + r) matrix in bfloat16 and float16: within one unit of
    the type's spacing of the JAX package's; the full sum of a contiguous
    quad-aligned operand takes the card's ``direct`` loop, the axis sums
    ``direct`` where the rows are whole quads and ``element`` elsewhere."""
    n = 4096 + r
    x = rng.standard_normal(n).astype(np.float32)
    pa, ja = sm.Array(x, dtype=dtype), jsm.Array(x, dtype=dtype)
    assert _half_ulps(float(pa.sum()), float(np.asarray(ja.sum().numpy(), np.float64)), dtype) <= 1.0
    t = pa.torch()
    ident = reduction.identity(t.dtype)
    aligned = elementwise.quad_aligned(t.dtype, t.data_ptr())
    assert reduction.path(ident, "sum", (n,), reduction.layout([t])) == (
        "direct" if aligned else "element")
    m = rng.standard_normal((13, 44 + r)).astype(np.float32)
    pm, jm = sm.Array(m, dtype=dtype), jsm.Array(m, dtype=dtype)
    for axis in (0, 1):
        got = pm.sum(axis=axis).numpy()
        want = np.asarray(jm.sum(axis=axis).numpy(), np.float64)
        assert _half_ulps(got, want, dtype) <= 1.0
        tm = pm.torch()
        rows_whole = r % 4 == 0 and elementwise.quad_aligned(tm.dtype, tm.data_ptr())
        assert reduction.path(ident, "sum", tm.shape, reduction.layout([tm]), axis) == (
            "direct" if rows_whole else "element")
