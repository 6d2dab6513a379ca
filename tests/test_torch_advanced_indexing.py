"""NumPy advanced indexing (integer arrays, boolean masks) on the port's
``Array``: twins of tests/test_advanced_indexing.py, each read and write
held against the JAX package's ``Array`` (and NumPy) on the same seeded
float32 inputs.  Reads return copies; writes go through the view
machinery, so they stay visible to the parent and to sibling views.
Exact equality: indexing moves values and computes none.
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


class _Both:
    """An sm.Array of the port and of the JAX package over the same values:
    reads and writes go to both and must agree, and ``np.asarray`` of it is
    the port's values after checking the JAX package's equal them."""

    def __init__(self, values, port=None, ref=None):
        self.port = sm.array(values) if port is None else port
        self.ref = jsm.array(values) if ref is None else ref

    @staticmethod
    def _key(key, side):
        if isinstance(key, tuple):
            return tuple(_Both._key(k, side) for k in key)
        return getattr(key, side) if isinstance(key, _Both) else key

    def __getitem__(self, key):
        return _Both(None, self.port[self._key(key, "port")], self.ref[self._key(key, "ref")])

    def __setitem__(self, key, value):
        self.port[self._key(key, "port")] = value
        self.ref[self._key(key, "ref")] = value

    @property
    def T(self):
        return _Both(None, self.port.T, self.ref.T)

    @property
    def is_view(self):
        assert self.port.is_view == self.ref.is_view
        return self.port.is_view

    def __array__(self, dtype=None, copy=None):
        got, want = np.asarray(self.port), np.asarray(self.ref)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
        return got if dtype is None else got.astype(dtype)


class _Module:
    """``sm.array`` building both packages' arrays."""

    @staticmethod
    def array(values):
        return _Both(np.asarray(values))


sm_both = _Module()


def _mk(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


class TestFancyRead:
    def test_int_array_1d(self):
        A = _mk(20)
        idx = np.array([3, 1, 17, 3, 0])
        got = np.asarray(sm_both.array(A)[idx])
        np.testing.assert_array_equal(got, A[idx])

    def test_int_list(self):
        A = _mk((6, 5))
        got = np.asarray(sm_both.array(A)[[4, 0, 2]])
        np.testing.assert_array_equal(got, A[[4, 0, 2]])

    def test_negative_indices(self):
        A = _mk(10)
        got = np.asarray(sm_both.array(A)[np.array([-1, -10, 5])])
        np.testing.assert_array_equal(got, A[np.array([-1, -10, 5])])

    def test_multi_dim_int_arrays(self):
        A = _mk((7, 9))
        r = np.array([0, 3, 6])
        c = np.array([8, 2, 4])
        got = np.asarray(sm_both.array(A)[r, c])
        np.testing.assert_array_equal(got, A[r, c])

    def test_mixed_slice_and_array(self):
        A = _mk((5, 8))
        got = np.asarray(sm_both.array(A)[1:4, np.array([7, 0])])
        np.testing.assert_array_equal(got, A[1:4, np.array([7, 0])])

    def test_bool_mask(self):
        A = _mk(30)
        mask = A > 0
        got = np.asarray(sm_both.array(A)[mask])
        np.testing.assert_array_equal(got, A[mask])

    def test_bool_mask_2d(self):
        A = _mk((6, 7))
        mask = A > 0.5
        got = np.asarray(sm_both.array(A)[mask])
        np.testing.assert_array_equal(got, A[mask])

    def test_sm_array_as_index(self):
        A = _mk(12)
        idx = sm_both.array(np.array([0, 5, 11], np.int32))
        got = np.asarray(sm_both.array(A)[idx])
        np.testing.assert_array_equal(got, A[[0, 5, 11]])

    def test_returns_copy_not_view(self):
        A = _mk(10)
        a = sm_both.array(A)
        b = a[np.array([0, 1])]
        assert not b.is_view

    def test_fancy_read_through_view(self):
        A = _mk((6, 8))
        v = sm_both.array(A).T  # view
        got = np.asarray(v[np.array([2, 7])])
        np.testing.assert_array_equal(got, A.T[[2, 7]])


class TestFancyWrite:
    def test_int_array_write(self):
        A = _mk(20)
        a = sm_both.array(A)
        a[np.array([1, 5, 7])] = 0.0
        want = A.copy()
        want[[1, 5, 7]] = 0.0
        np.testing.assert_array_equal(np.asarray(a), want)

    def test_bool_mask_write(self):
        A = _mk((5, 6))
        a = sm_both.array(A)
        a[A > 0] = -1.0
        want = A.copy()
        want[A > 0] = -1.0
        np.testing.assert_array_equal(np.asarray(a), want)

    def test_write_array_values(self):
        A = _mk(10)
        a = sm_both.array(A)
        a[np.array([2, 4])] = np.array([100.0, 200.0], np.float32)
        want = A.copy()
        want[[2, 4]] = [100.0, 200.0]
        np.testing.assert_array_equal(np.asarray(a), want)

    def test_write_through_view_visible_in_parent(self):
        A = _mk((4, 6))
        p = sm_both.array(A)
        v = p[1]  # row view
        v[np.array([0, 5])] = 9.0
        want = A.copy()
        want[1, [0, 5]] = 9.0
        np.testing.assert_array_equal(np.asarray(p), want)

    def test_write_through_transpose_view(self):
        A = _mk((3, 5))
        p = sm_both.array(A)
        v = p.T
        v[np.array([4, 0]), np.array([2, 1])] = 7.0
        want = A.copy()
        want.T[[4, 0], [2, 1]] = 7.0
        np.testing.assert_array_equal(np.asarray(p), want)

    def test_mask_write_preserves_dtype(self):
        A = np.arange(10, dtype=np.int32)
        a = sm_both.array(A)
        a[A % 2 == 0] = -1
        want = A.copy()
        want[A % 2 == 0] = -1
        np.testing.assert_array_equal(np.asarray(a), want)
        assert np.asarray(a).dtype == np.int32


class TestFuzzOracle:
    @pytest.mark.parametrize("seed", range(10))
    def test_fancy_roundtrip(self, seed):
        rng = np.random.default_rng(seed)
        shape = tuple(int(rng.integers(2, 12)) for _ in range(rng.integers(1, 3)))
        A = rng.standard_normal(shape).astype(np.float32)
        a = sm_both.array(A)
        want = A.copy()
        n_idx = int(rng.integers(1, 6))
        idx = rng.integers(-shape[0], shape[0], n_idx)
        got_read = np.asarray(a[idx])
        np.testing.assert_array_equal(got_read, want[idx])
        val = rng.standard_normal(got_read.shape).astype(np.float32)
        a[idx] = val
        want[idx] = val
        np.testing.assert_array_equal(np.asarray(a), want)
