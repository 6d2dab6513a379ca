"""The port's debug helpers (simplemath_tpu_torch/utils/debug.py) on the CPU:
twins of the debug tests of tests/test_complex_and_debug.py
(``assert_tree_finite``, ``tree_norm``, ``nan_guard``, the
``interpret_kernels`` context), the same inputs through both packages
where they return values (``tree_norm`` within float32's ``rtol=1e-6``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simplemath_tpu_torch as sm
from simplemath_tpu.utils import debug as jdebug
from simplemath_tpu_torch.ops import dispatch, elementwise, matmul, reduction
from simplemath_tpu_torch.utils import debug


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's default device is the card; these tests ask for the CPU."""
    old = sm.config.device
    sm.configure(device="cpu")
    yield
    sm.configure(device=old)


def test_assert_tree_finite():
    debug.assert_tree_finite({"x": torch.ones(3)})
    with pytest.raises(FloatingPointError, match="non-finite"):
        debug.assert_tree_finite({"x": torch.tensor([1.0, np.nan])})


def test_assert_tree_finite_names_the_leaf():
    tree = {"a": torch.ones(2), "b": [torch.zeros(1), torch.tensor([np.inf])]}
    with pytest.raises(FloatingPointError, match=r"state\['b'\]\[1\]"):
        debug.assert_tree_finite(tree, "state")
    debug.assert_tree_finite({"n": torch.arange(3), "k": 2})


def test_tree_norm():
    n = debug.tree_norm({"a": torch.ones(4), "b": torch.ones(4) * 2})
    np.testing.assert_allclose(n, np.sqrt(4 + 16), rtol=1e-6)


def test_tree_norm_matches_the_jax_package(rng):
    a = rng.standard_normal((5, 3)).astype(np.float32)
    b = rng.integers(-4, 4, 7).astype(np.int32)
    mine = debug.tree_norm({"a": torch.from_numpy(a), "b": [torch.from_numpy(b)]})
    theirs = jdebug.tree_norm({"a": jnp.asarray(a), "b": [jnp.asarray(b)]})
    np.testing.assert_allclose(mine, theirs, rtol=1e-6)


def test_nan_guard():
    safe = debug.nan_guard(lambda x: x * 2)
    np.testing.assert_allclose(safe(torch.ones(3)).numpy(), 2 * np.ones(3))
    bad = debug.nan_guard(lambda x: x / 0.0)
    with pytest.raises(FloatingPointError):
        bad(torch.zeros(3))


def test_nan_guard_sweeps_every_floating_leaf():
    fn = debug.nan_guard(lambda x: {"ok": x, "n": torch.arange(2), "bad": [x, x.log()]})
    with pytest.raises(FloatingPointError, match="non-finite output"):
        fn(torch.tensor([1.0, -1.0]))
    out = fn(torch.tensor([1.0, 2.0]))
    assert torch.equal(out["n"], torch.arange(2))


def test_nan_guard_on_sm_arrays():
    guarded = debug.nan_guard(lambda a: sm.sqrt(a))
    assert guarded(sm.Array(np.array([4.0], np.float32))).numpy()[0] == 2.0
    with pytest.raises(FloatingPointError):
        guarded(sm.Array(np.array([-1.0], np.float32)))


def test_interpret_kernels_context():
    with debug.interpret_kernels():
        assert dispatch.INTERPRET.get()
    assert dispatch.INTERPRET.get() is False


def test_interpret_kernels_is_not_a_setting():
    """Only the context turns the plain route on: ``configure`` knows no
    such field."""
    with pytest.raises(AttributeError, match="interpret_kernels"):
        sm.configure(interpret_kernels=True)
    assert dispatch.INTERPRET.get() is False


def test_interpret_kernels_restores_on_exception():
    with pytest.raises(KeyError):
        with debug.interpret_kernels():
            raise KeyError("inside")
    assert dispatch.INTERPRET.get() is False


def test_interpret_kernels_gives_the_plain_values_and_launches_nothing():
    """On the CPU every wrapper runs its plain version anyway: the values
    are the same inside and outside the context, no launch is counted, and
    no ``interpret:`` route (that count is the card's)."""
    a = sm.Array(np.linspace(-2, 2, 64, dtype=np.float32).reshape(8, 8))
    chain = sm.fuse(lambda acc, x: acc * 0.5 + sm.exp(x), donate=0, iterations=8)
    outside = chain(sm.zeros(8, 8), a).numpy(), a.sum().numpy()
    for counts in (elementwise, reduction, matmul):
        counts.reset_launches()
    dispatch.reset()
    with debug.interpret_kernels():
        inside = chain(sm.zeros(8, 8), a).numpy(), a.sum().numpy()
    for x, y in zip(inside, outside):
        np.testing.assert_array_equal(x, y)
    assert sum(elementwise.LAUNCHES.values()) == sum(reduction.LAUNCHES.values()) == 0
    assert not any(k.startswith("interpret") for k in dispatch.counts())
