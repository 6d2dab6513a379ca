"""The arithmetic of the port's 64-bit integer product against the JAX
package's int64 ``dot``/``matmul`` (x64 on).

On the card every product whose result is int64 or uint64 runs
``csrc/matmul_wgmma_i64.cu`` (``matmul.VARIANTS["wgmma_i64"]``): each
operand split into 8 unsigned byte planes, the 36 plane products whose limbs
add up to at most 7 on the int8 tensor cores, each diagonal summed in a
wrapping int32 accumulator and folded into the 64-bit result every 16,384
of K.  ``matmul.int64_limbs_plain`` repeats that arithmetic on the CPU; here
it is held, bit for bit, to the JAX package's product and to torch's CPU
int64 product, on every pair of ``tests/test_torch_matmul.py::_WIDE_PAIRS``,
on rank 3 and on views, and on all-ones operands at a K whose diagonals
pass 2**32 without the folds.  The kernel itself is held to the CPU's
product on the card (tests/test_torch_kernel_cuda.py, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import simplemath_tpu as jsm
import simplemath_tpu_torch as sm
from simplemath_tpu.config import config as jconfig
from simplemath_tpu_torch.ops import matmul

from test_torch_matmul import _WIDE_PAIRS, _pair, _same_meta, _wide_pair


@pytest.fixture(autouse=True)
def _setup():
    """The JAX side on its own kernels, the port on the CPU (its default
    device is the card)."""
    old = (jconfig.kernel_backend, sm.config.device)
    jconfig.kernel_backend = "pallas"
    sm.configure(device="cpu")
    yield
    jconfig.kernel_backend = old[0]
    sm.configure(device=old[1])


def _bits(want) -> np.ndarray:
    """The JAX package's 64-bit result as int64 bits."""
    w = np.asarray(want)
    return w.view(np.int64) if w.dtype == np.uint64 else w.astype(np.int64)


def _operands(rng, pair, shape_a, shape_b):
    if pair[0] == "bool":
        ja, pa = _pair(rng.standard_normal(shape_a) > 0)
    else:
        ja, pa = _wide_pair(rng, pair[0], shape_a)
    jb, pb = _wide_pair(rng, pair[1], shape_b)
    return ja, pa, jb, pb


def _check(got, want, torch_product):
    assert got.dtype == torch.int64 and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.numpy(), _bits(want))
    assert torch.equal(got, torch_product)


@pytest.mark.parametrize("pair", _WIDE_PAIRS, ids=str)
def test_limbs_match_the_jax_product_on_rank_3(pair):
    """A batched product of full-range values: the limbs' arithmetic gives
    the JAX package's ``matmul`` and the CPU's int64 product."""
    rng = np.random.default_rng(80)
    ja, pa, jb, pb = _operands(rng, pair, (3, 9, 70), (3, 70, 11))
    want = jsm.matmul(ja, jb)
    _same_meta(sm.matmul(pa, pb), want)
    a, b = pa._operand(), pb._operand()
    _check(matmul.int64_limbs_plain(a, b), want,
           torch.matmul(matmul._int64(a), matmul._int64(b)))
    if "int64" in pair or "uint64" in pair:  # the product passes 2**63 somewhere
        assert np.abs(np.asarray(want).astype(np.float64)).max() > 2.0**62


@pytest.mark.parametrize("pair", _WIDE_PAIRS, ids=str)
def test_limbs_match_the_jax_product_on_views(pair):
    """A transposed operand and a negative-step one, read in place: the
    JAX package's ``dot`` of the same views."""
    rng = np.random.default_rng(81)
    ja, pa, jb, pb = _operands(rng, pair, (40, 12), (80, 9))
    want = jsm.dot(ja.T, jb[::-2])
    a, b = pa.T._operand(), pb[::-2]._operand()
    _check(matmul.int64_limbs_plain(a, b), want,
           torch.matmul(matmul._int64(a), matmul._int64(b)))


@pytest.mark.parametrize("k", [20000, 40000])
@pytest.mark.parametrize("dtype", ["int64", "uint64"])
def test_limbs_fold_all_ones_at_long_k(dtype, k):
    """Every limb 0xFF (int64 -1, uint64 2**64 - 1): each diagonal takes its
    largest sum, which passes 2**32 past K = 16,512 unless it is folded into
    the 64-bit result every 16,384 of K."""
    x = np.full((3, k), -1, np.int64)
    y = np.full((k, 4), -1, np.int64)
    if dtype == "uint64":
        x, y = x.view(np.uint64), y.view(np.uint64)
    (ja, pa), (jb, pb) = _pair(x), _pair(y)
    want = jsm.matmul(ja, jb)
    a, b = pa._operand(), pb._operand()
    got = matmul.int64_limbs_plain(a, b)
    _check(got, want, torch.matmul(matmul._int64(a), matmul._int64(b)))
    assert int(got[0, 0]) == k  # (-1) * (-1) summed k times


def test_limbs_without_folds_differ_at_40000():
    """The folds are needed: a diagonal that sums all of K = 40,000 before it
    wraps gives other bits; the first K at which it does is 16,513."""
    a = torch.full((3, 40000), -1, dtype=torch.int64)
    b = torch.full((40000, 4), -1, dtype=torch.int64)
    assert torch.equal(matmul.int64_limbs_plain(a, b), a @ b)
    assert not torch.equal(matmul.int64_limbs_plain(a, b, fold=None), a @ b)
    for k, exact in ((16512, True), (16513, False)):
        assert torch.equal(matmul.int64_limbs_plain(a[:, :k], b[:k], fold=None),
                           a[:, :k] @ b[:k]) == exact


@pytest.mark.parametrize("fold", [1, 7, 32, 16384])
def test_limbs_any_fold_gives_the_product(fold):
    """The product does not depend on where the folds fall (the kernel's
    parts of K may be shorter than 16,384): K = 300 cut every ``fold``."""
    rng = np.random.default_rng(82)
    a = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, (2, 5, 300), dtype=np.int64))
    b = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, (2, 300, 6), dtype=np.int64))
    assert torch.equal(matmul.int64_limbs_plain(a, b, fold=fold), a @ b)
