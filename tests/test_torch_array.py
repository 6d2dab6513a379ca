"""The port's ``Array`` against the JAX package's: construction dtypes,
views (negative steps included), write-through, and the metadata the
kernel reads views by (strides, offset)."""

import numpy as np
import pytest

import simplemath_tpu as jsm
import simplemath_tpu_torch as sm
from simplemath_tpu_torch import dtypes


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's default device is the card; these tests ask for the CPU."""
    old = sm.config.device
    sm.configure(device="cpu")
    yield
    sm.configure(device=old)


def _same(port_arr, jax_arr):
    want = jax_arr.numpy()
    got = port_arr.numpy()
    assert got.shape == want.shape
    assert dtypes.name(port_arr.dtype) == np.dtype(jax_arr.dtype).name
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("data", [
    [1.0, 2.0], [[1, 2], [3, 4]], [True, False], 3.5, 7,
    np.arange(6, dtype=np.float64).reshape(2, 3), np.arange(4, dtype=np.int64),
    np.ones(3, np.uint32), np.ones((2, 2), np.int16),
])
def test_construction_dtypes_match(data):
    _same(sm.Array(data), jsm.Array(data))


@pytest.mark.parametrize("dtype", ["float32", "int32", float, int, "float64"])
def test_explicit_dtype(dtype):
    _same(sm.Array([[1.5, -2.0]], dtype=dtype), jsm.Array([[1.5, -2.0]], dtype=dtype))


def test_ragged_list_raises():
    with pytest.raises(ValueError):
        sm.Array([[1, 2], [3]])


_KEYS = [
    1, -1, (1, 2), (slice(None), 1), (slice(1, 3), slice(None, None, 2)),
    (slice(None, None, -1),), (slice(None, None, -2), slice(3, 0, -1)),
    (Ellipsis, 2), (0, slice(None, None, -1)), (slice(4, None, -3), 0),
    (None, slice(1, 3)), (slice(None), None, 1),
]


@pytest.mark.parametrize("key", _KEYS, ids=repr)
def test_views_read_like_reference(rng, key):
    base = rng.standard_normal((5, 6)).astype(np.float32)
    a, ja = sm.Array(base), jsm.Array(base)
    v, jv = a[key], ja[key]
    _same(v, jv)
    if key is not None and None not in (key if isinstance(key, tuple) else (key,)):
        assert v.strides == jv.strides
        assert v._spec.offset() == jv._spec.offset()


@pytest.mark.parametrize("key", _KEYS[:10], ids=repr)
def test_view_write_through_like_reference(rng, key):
    base = rng.standard_normal((5, 6)).astype(np.float32)
    a, ja = sm.Array(base), jsm.Array(base)
    v, jv = a[key], ja[key]
    val = np.arange(np.prod(v.shape), dtype=np.float32).reshape(v.shape) + 100
    v[...] = val
    jv[...] = val
    _same(a, ja)
    _same(v, jv)


def test_sibling_views_and_scalar_writes(rng):
    base = rng.standard_normal((4, 4)).astype(np.float32)
    a, ja = sm.Array(base), jsm.Array(base)
    for arr in (a, ja):
        t = arr.T
        r = arr[::-1]
        t[0, 1] = 7.0
        r[0] = -1.0
        arr.set((2, 2), 5.0)
    _same(a, ja)
    assert a(1, 0) == ja(1, 0)


@pytest.mark.parametrize("axes", [(), (1, 0, 2), (2, 0, 1), (0, 2, 1)])
def test_transpose_views(rng, axes):
    base = rng.standard_normal((2, 3, 4)).astype(np.float32)
    a, ja = sm.Array(base)[:, ::-1], jsm.Array(base)[:, ::-1]
    t, jt = a.transpose(*axes), ja.transpose(*axes)
    _same(t, jt)
    assert t.strides == jt.strides and t.is_view == jt.is_view


def test_reshape_flatten_repeat_copy_astype_do_not_alias(rng):
    base = rng.standard_normal((3, 4)).astype(np.float32)
    a, ja = sm.Array(base), jsm.Array(base)
    outs = [
        (a.reshape(4, 3), ja.reshape(4, 3)), (a.flatten(), ja.flatten()),
        (a.repeat(2), ja.repeat(2)), (a.repeat(2, axis=1), ja.repeat(2, axis=1)),
        (a.copy(), ja.copy()), (a.astype("int32"), ja.astype("int32")),
        (a.T.reshape(12), ja.T.reshape(12)),
    ]
    a[0, 0] = 99.0
    ja[0, 0] = 99.0
    for p, j in outs:
        _same(p, j)


def test_fill_len_iter_scalars(rng):
    a, ja = sm.zeros(3, 2), jsm.zeros(3, 2)
    a[1].fill(4.0)
    ja[1].fill(4.0)
    _same(a, ja)
    assert len(a) == 3 and [r.shape for r in a] == [(2,)] * 3
    assert float(a[1, 0]) == 4.0 and int(sm.Array([3])[0]) == 3
    assert a.size == a.total_size == a.totalSize == 6 and a.ndim == 2


def test_from_reference_keeps_view_structure(rng):
    base = rng.standard_normal((6, 8)).astype(np.float32)
    ja = jsm.Array(base)[1::2, ::-3].T
    a = sm.from_reference(np.asarray(ja._storage.buf), ja._spec)
    _same(a, ja)
    assert a.strides == ja.strides and a.is_view


def test_index_errors():
    a = sm.zeros(2, 3)
    with pytest.raises(IndexError):
        a[2]
    with pytest.raises(IndexError):
        a[0, 0, 0]


def test_recorded_op_keeps_its_operand_values():
    """A deferred op snapshots its operands: a later in-place write to an
    operand does not change it (copy-on-write of the frozen buffer)."""
    a = sm.Array([1.0, 2.0, 3.0])
    v = a[1:]
    c = a + 1.0
    d = v * 2.0
    a[0] = 100.0
    v[0] = -5.0
    np.testing.assert_array_equal(c.numpy(), [2.0, 3.0, 4.0])
    np.testing.assert_array_equal(d.numpy(), [4.0, 6.0])
    np.testing.assert_array_equal(a.numpy(), [100.0, -5.0, 3.0])
