"""The port's matmul path against the JAX package's: the fused matmul root
of ``sm.fuse``, ``int8_matmul`` with ``quantize``/``dequantize``, and
``dot``/``matmul``/``@`` of every rank.

The same numpy arrays, made from a seed, go to both packages.  The JAX side
runs as tests/test_matmul_epilogue.py runs it: ``kernel_backend = "pallas"``,
which on the CPU is its Pallas matmul kernels in interpret mode (exact
float32), and once more under ``"auto"`` (XLA's dot).  The port runs on the
CPU, where the matmul wrapper takes its plain version (``matmul_plain``);
the CUDA kernel is held against that plain version on the card
(tests/test_torch_kernel_cuda.py).

Tolerances are those of tests/test_matmul_epilogue.py: float32
``rtol=1e-5, atol=1e-4`` (a tanh epilogue ``rtol=1e-4``: two float32 sums in
different orders, then the epilogue), bfloat16 2e-2 of the largest value,
float64 ``rtol=1e-12``; integers exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simplemath_tpu as jsm
import simplemath_tpu_torch as sm
from simplemath_tpu.config import config as jconfig
from simplemath_tpu.ops import dispatch as jdispatch
from simplemath_tpu_torch import dtypes
from simplemath_tpu_torch.ops import dispatch, engine, matmul, program


@pytest.fixture(autouse=True)
def _setup():
    """The JAX side on its Pallas kernels (interpret mode), the port on the
    CPU: its default device is the card."""
    old = (jconfig.kernel_backend, sm.config.device)
    jconfig.kernel_backend = "pallas"
    sm.configure(device="cpu")
    dispatch.reset()
    jdispatch.reset()
    matmul.reset_launches()
    yield
    jconfig.kernel_backend = old[0]
    sm.configure(device=old[1])


def _mk(shape, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _pair(x, dtype=None):
    """One numpy array as (JAX-package Array, port Array) of ``dtype``; the
    port's copy is carried over by ``from_reference`` with the dtype kept."""
    j = jnp.asarray(x) if dtype is None else jnp.asarray(x).astype(dtype)
    ja = jsm.Array(j)
    pa = sm.from_reference(np.asarray(ja._storage.buf))
    assert dtypes.name(pa.dtype) == jnp.dtype(ja.dtype).name
    return ja, pa


def _same_meta(got, want):
    assert tuple(got.shape) == tuple(want.shape)
    assert dtypes.name(got.dtype) == jnp.dtype(want.dtype).name, (got.dtype, want.dtype)


# ------------------------------------------------------- the fused roots
def _relu_bias(mod):
    return lambda x, w, b: mod.maximum(x @ w + b, 0.0)


_ROOTS = {
    # name: (shapes, function of the module, rtol, atol, dispatch name)
    "relu_bias": ([(300, 270), (270, 515), (1, 515)], _relu_bias, 1e-5, 1e-4, "mm_epilogue"),
    "bench_epilogue": ([(64, 96), (96, 80), (1, 80)],
                       lambda mod: lambda x, w, b: mod.maximum(x @ w + b, 0.0) * (1 / 96) - 0.5,
                       1e-5, 1e-4, "mm_epilogue"),
    "column_scalar_tanh": ([(256, 384), (384, 512), (256, 1)],
                           lambda mod: lambda x, w, c: mod.tanh((x @ w) * c + 0.5),
                           1e-4, 2e-5, "mm_epilogue"),
    "full_extra": ([(256, 256), (256, 384), (256, 384)],
                   lambda mod: lambda x, w, y: mod.square(x @ w - y), 1e-4, 1e-3, "mm_epilogue"),
    "matmul_only": ([(256, 300), (300, 256)], lambda mod: lambda x, w: x @ w,
                    1e-5, 1e-4, "mm_epilogue"),
    "free_function": ([(256, 256), (256, 256)],
                      lambda mod: lambda x, w: mod.maximum(mod.matmul(x, w), 0.0),
                      1e-5, 1e-4, "mm_epilogue"),
    "dot_function": ([(48, 32), (32, 16)], lambda mod: lambda x, w: mod.abs(mod.dot(x, w)),
                     1e-5, 1e-4, "mm_epilogue"),
    "rank1_bias": ([(256, 256), (256, 384), (384,)], lambda mod: lambda x, w, b: x @ w + b,
                   1e-5, 1e-4, "mm_epilogue"),
    "small": ([(32, 16), (16, 48)], lambda mod: lambda x, w: mod.square(x @ w),
              1e-5, 1e-4, "mm_epilogue"),
    "batched_relu_bias": ([(3, 256, 300), (3, 300, 260), (1, 1, 260)], _relu_bias,
                          1e-5, 1e-4, "bmm_epilogue"),
    "per_batch_scale": ([(2, 256, 256), (2, 256, 256), (2, 1, 1)],
                        lambda mod: lambda x, w, s: (x @ w) * s, 1e-5, 1e-4, "bmm_epilogue"),
    "batched_column": ([(4, 48, 16), (4, 16, 40), (48, 1)],
                       lambda mod: lambda x, w, c: mod.minimum(x @ w, c), 1e-5, 1e-4,
                       "bmm_epilogue"),
}


@pytest.mark.parametrize("name", sorted(_ROOTS))
def test_fused_root_matches_jax(name):
    shapes, make, rtol, atol, record = _ROOTS[name]
    arrays = [_pair(_mk(s, i)) for i, s in enumerate(shapes)]
    want = jsm.fuse(make(jsm))(*(a for a, _ in arrays))
    got = sm.fuse(make(sm))(*(a for _, a in arrays))
    _same_meta(got, want)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)
    counts = dispatch.counts()
    assert counts.get(f"matmul:{record}") == 1, counts
    # the epilogue is part of the matmul call: no elementwise dispatch
    assert not any(k.startswith(("elementwise", "torch_path")) for k in counts), counts
    assert matmul.LAUNCHES == {"mm": 0, "bmm": 0}  # a CPU tensor launches nothing


@pytest.mark.parametrize("name", ["relu_bias", "small", "batched_relu_bias"])
def test_fused_root_matches_jax_under_auto(name):
    """The JAX package under "auto" on the CPU: XLA's dot plus the epilogue."""
    jconfig.kernel_backend = "auto"
    shapes, make, rtol, atol, _ = _ROOTS[name]
    arrays = [_pair(_mk(s, i)) for i, s in enumerate(shapes)]
    want = jsm.fuse(make(jsm))(*(a for a, _ in arrays))
    got = sm.fuse(make(sm))(*(a for _, a in arrays))
    _same_meta(got, want)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("bias", [False, True])
def test_fused_root_bf16(bias):
    shapes = [(256, 256), (256, 256)] + ([(1, 256)] if bias else [])
    arrays = [_pair(_mk(s, i), jnp.bfloat16) for i, s in enumerate(shapes)]

    def make(mod):
        if bias:
            return lambda x, w, b: mod.maximum(x @ w + b, 0.0) * 0.5 - 0.25
        return lambda x, w: mod.abs(x @ w)

    want = jsm.fuse(make(jsm))(*(a for a, _ in arrays))
    got = sm.fuse(make(sm))(*(a for _, a in arrays))
    _same_meta(got, want)
    assert got.dtype == torch.bfloat16
    w32 = np.asarray(want.jax().astype(jnp.float32))
    assert np.abs(got.numpy() - w32).max() / np.abs(w32).max() < 2e-2
    # The epilogue saw the float32 accumulator: one rounding to bfloat16.
    x, w = (np.asarray(a.jax().astype(jnp.float32), np.float64) for a, _ in arrays[:2])
    ref = x @ w
    if bias:
        ref = np.maximum(ref + np.asarray(arrays[2][0].jax().astype(jnp.float32), np.float64), 0) * 0.5 - 0.25
    else:
        ref = np.abs(ref)
    assert np.all(np.abs(got.numpy() - ref) <= 2.0 ** -8 * np.abs(ref) + 1e-4)
    assert dispatch.count("matmul", "mm_epilogue") == 1
    assert dispatch.count("torch_path", "matmul_epilogue") == 0


@pytest.mark.parametrize("case", ["float64", "float16", "int8", "f64_extra", "rank4_extra"])
def test_fused_root_signatures_the_kernel_does_not_take(case):
    """Routing by signature: these run ``torch.matmul`` plus the epilogue as
    plain torch, are recorded as ``torch_path:matmul_epilogue``, and agree
    with the JAX package."""
    if case == "int8":
        rng = np.random.default_rng(0)
        x = rng.integers(-127, 128, (32, 40)).astype(np.int8)
        w = rng.integers(-127, 128, (40, 24)).astype(np.int8)
        arrays = [_pair(x), _pair(w)]
        make = lambda mod: lambda a, b: mod.abs(a @ b)  # noqa: E731
    else:
        dt = {"float64": np.float64, "float16": np.float16}.get(case, np.float32)
        arrays = [_pair(_mk((48, 40)).astype(dt)), _pair(_mk((40, 24), 1).astype(dt))]
        make = lambda mod: lambda a, b: mod.abs(a @ b)  # noqa: E731
        if case == "f64_extra":
            arrays.append(_pair(_mk((1, 24), 2, np.float64)))
            make = lambda mod: lambda a, b, c: (a @ b) * c  # noqa: E731
        if case == "rank4_extra":
            arrays.append(_pair(_mk((2, 1, 48, 24), 2)))
            make = lambda mod: lambda a, b, c: (a @ b) + c  # noqa: E731
    want = jsm.fuse(make(jsm))(*(a for a, _ in arrays))
    got = sm.fuse(make(sm))(*(a for _, a in arrays))
    _same_meta(got, want)
    if case == "int8":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        rtol = {"float64": 1e-12, "float16": 2e-3}.get(case, 1e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=1e-4)
    assert dispatch.count("torch_path", "matmul_epilogue") == 1
    assert dispatch.count("matmul", "mm_epilogue") == 0


def test_fused_root_reads_views_in_place():
    """Transposed and sliced arguments go to the wrapper as strided
    operands; the values are those of the JAX package."""
    jx, px = _pair(_mk((96, 64)))
    jw, pw = _pair(_mk((80, 128), 1))
    jb, pb = _pair(_mk((80, 1), 2))
    want = jsm.fuse(_relu_bias(jsm))(jx.T, jw[::-2, 16:112].T, jb[::2].T)
    got = sm.fuse(_relu_bias(sm))(px.T, pw[::-2, 16:112].T, pb[::2].T)
    _same_meta(got, want)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    a, b = px.T._operand(), pw[::-2, 16:112].T._operand()
    assert a.strides == (1, 64) and b.strides == (1, -256) and b.base is pw._storage.buf


_ERRORS = {
    "composed": (lambda mod: lambda x, w: (x + 1.0) @ w, [(16, 16), (16, 16)], "direct arguments"),
    "constant": (lambda mod: lambda x, w: [[1.0] * 16] * 16 @ w, [(16, 16), (16, 16)],
                 "direct arguments"),
    "two_matmuls": (lambda mod: lambda x, w, v: (x @ w) + (x @ v), [(16, 16)] * 3,
                    "at most one matmul"),
    "reuse": (lambda mod: lambda x, w: (x @ w) + x, [(16, 16), (16, 16)], "used elementwise"),
    "reduction": (lambda mod: lambda x, w: mod.sum(x @ w), [(16, 16), (16, 16)],
                  "reduction over a fused matmul"),
    "rank4": (lambda mod: lambda x, w: x @ w, [(2, 2, 8, 8), (2, 2, 8, 8)], "2-D"),
    "shape": (lambda mod: lambda x, w: x @ w, [(16, 8), (12, 16)], "2-D"),
    "batch": (lambda mod: lambda x, w: x @ w, [(2, 8, 8), (3, 8, 8)], "batched"),
}


@pytest.mark.parametrize("name", sorted(_ERRORS))
def test_fused_root_errors_match_jax(name):
    make, shapes, match = _ERRORS[name]
    arrays = [_pair(_mk(s, i)) for i, s in enumerate(shapes)]
    for mod, args in ((jsm, [a for a, _ in arrays]), (sm, [a for _, a in arrays])):
        if name == "constant" and mod is jsm:
            continue  # the JAX package's node has no reflected matmul
        with pytest.raises(TypeError, match=match):
            mod.fuse(make(mod))(*args)


def test_fused_root_iterations_refused():
    for mod, arr in ((jsm, jsm.ones(8, 8)), (sm, sm.ones(8, 8))):
        with pytest.raises(ValueError, match="does not compose with a matmul root"):
            mod.fuse(lambda x, w: x @ w, iterations=2)(arr, arr)


# ------------------------------------------------------------ int8_matmul
def _ints(shape, dtype, seed):
    info = np.iinfo(dtype)
    lo = -127 if dtype == "int8" else info.min
    return np.random.default_rng(seed).integers(lo, info.max + 1, shape).astype(dtype)


@pytest.mark.parametrize("scale", [None, "scalar", "channel"])
@pytest.mark.parametrize("shape", [((64, 48), (48, 80)), ((2, 32, 48), (2, 48, 24)),
                                   ((256, 256), (256, 256))], ids=str)
@pytest.mark.parametrize("dts", [("int8", "int8"), ("uint8", "uint8"), ("int8", "uint8"),
                                 ("uint8", "int8")], ids=str)
def test_int8_matmul_exact(dts, shape, scale):
    """Exact against int64 numpy and the JAX package ((256, 256) int8 runs
    its Pallas kernel in interpret mode; uint8 its XLA widening), with no
    scale, a scalar scale and per-channel (1, N) scales; every pair is
    routed to the int8 tensor-core kernel."""
    a, b = _ints(shape[0], dts[0], 0), _ints(shape[1], dts[1], 1)
    s = {None: None, "scalar": 0.5,
         "channel": np.abs(_mk((1,) * (len(shape[1]) - 1) + shape[1][-1:], 2)) + 0.5}[scale]
    want = jsm.int8_matmul(a, b, scale=s)
    got = sm.int8_matmul(a, b, scale=s)
    _same_meta(got, want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    acc = np.matmul(a.astype(np.int64), b.astype(np.int64))
    ref = acc.astype(np.int32) if s is None else acc.astype(np.float32) * np.float32(s)
    np.testing.assert_array_equal(got.numpy(), ref)
    counts = dispatch.counts()
    rank3 = len(shape[0]) == 3
    assert counts.get("matmul:int8") == 1 and counts.get("matmul:bmm" if rank3 else "matmul:mm") == 1
    assert counts.get("matmul:bmm_epilogue" if rank3 else "matmul:mm_epilogue") == (
        None if s is None else 1)
    assert counts.get("matmul:wgmma_s8") == 1 and "matmul:wgmma_bf16" not in counts


_INT8_VIEWS = {
    # name: (shape of a's base, shape of b's base, the views taken of both packages' arrays)
    "b_transposed": ((40, 77), (24, 77), lambda a, b: (a, b.T)),       # a K-major weight
    "a_transposed": ((77, 40), (77, 24), lambda a, b: (a.T, b)),
    "both_transposed": ((77, 40), (24, 77), lambda a, b: (a.T, b.T)),
    "sliced": ((40, 90), (180, 30), lambda a, b: (a[:, 5:82], b[3:157:2, ::-1])),
    "batched": ((3, 20, 64), (3, 64, 48), lambda a, b: (a, b)),
}


@pytest.mark.parametrize("scale", [None, "channel"])
@pytest.mark.parametrize("dts", [("int8", "int8"), ("uint8", "int8"), ("int8", "uint8"),
                                 ("uint8", "uint8")], ids=str)
@pytest.mark.parametrize("name", sorted(_INT8_VIEWS))
def test_int8_matmul_of_views_exact(name, dts, scale):
    """Transposed, sliced and negative-step views of int8/uint8 arrays, read
    in place by both packages: exact against the JAX package and against
    int64 numpy on the same views, with and without per-channel scales."""
    sa, sb, views = _INT8_VIEWS[name]
    a_np, b_np = _ints(sa, dts[0], 3), _ints(sb, dts[1], 4)
    (ja, pa), (jb, pb) = _pair(a_np), _pair(b_np)
    (ja, jb), (pa, pb) = views(ja, jb), views(pa, pb)
    va, vb = views(a_np, b_np)
    n = vb.shape[-1]
    s = None if scale is None else np.abs(_mk((1,) * (vb.ndim - 1) + (n,), 5)) + 0.5
    want = jsm.int8_matmul(ja, jb, scale=s)
    got = sm.int8_matmul(pa, pb, scale=s)
    _same_meta(got, want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    acc = np.matmul(va.astype(np.int64), vb.astype(np.int64))
    ref = acc.astype(np.int32) if s is None else acc.astype(np.float32) * s
    np.testing.assert_array_equal(got.numpy(), ref)
    assert dispatch.count("matmul", "wgmma_s8") == 1
    assert matmul.LAUNCHES == {"mm": 0, "bmm": 0}  # a CPU tensor launches nothing


@pytest.mark.parametrize("out_dtype", ["int32", "float32", "int8", "int64"])
@pytest.mark.parametrize("scaled", [False, True])
def test_int8_matmul_out_dtype_matches_jax(out_dtype, scaled):
    """``ops.matmul.int8_matmul(out_dtype=)``: the exact int32 product cast
    to ``out_dtype`` (int8 wraps), and float32 whatever it says once
    ``scale`` is given, in both packages."""
    from simplemath_tpu.ops import matmul as jmatmul

    rng = np.random.default_rng(5)
    a = rng.integers(-127, 128, (12, 40)).astype(np.int8)
    b = rng.integers(-127, 128, (40, 9)).astype(np.int8)
    scale = 0.125 if scaled else None
    want = np.asarray(jmatmul.int8_matmul(a, b, out_dtype=jnp.dtype(out_dtype), scale=scale))
    got = matmul.int8_matmul(torch.from_numpy(a), torch.from_numpy(b),
                             out_dtype=getattr(torch, out_dtype), scale=scale)
    assert dtypes.name(got.dtype) == want.dtype.name == ("float32" if scaled else out_dtype)
    np.testing.assert_array_equal(got.numpy(), want)
    acc = a.astype(np.int64) @ b.astype(np.int64)
    ref = acc.astype(np.float32) * np.float32(0.125) if scaled else acc.astype(out_dtype)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_int8_matmul_refuses_other_types():
    for mod in (jsm, sm):
        with pytest.raises(TypeError, match="int8_matmul requires int8/uint8"):
            mod.int8_matmul(np.ones((4, 4), np.int32), np.ones((4, 4), np.int8))
        with pytest.raises(TypeError, match="int8_matmul requires int8/uint8"):
            mod.int8_matmul(np.ones((4, 4), np.int8), np.ones((4, 4), np.float32))


@pytest.mark.parametrize("case", ["tensor", "axis0", "axis1", "axes", "zero", "given", "float64"])
def test_quantize_dequantize_match_jax(case):
    x = _mk((24, 40)) * 3.0
    kw = {"tensor": {}, "axis0": {"axis": 0}, "axis1": {"axis": 1}, "axes": {"axis": (0, 1)},
          "zero": {"axis": 0}, "given": {"scale": 0.05}, "float64": {}}[case]
    if case == "zero":
        x[:, 3] = 0.0  # a zero scale divides by 1
    if case == "float64":
        x = x.astype(np.float64)
    jq, js = jsm.quantize(x, **kw)
    pq, ps = sm.quantize(x, **kw)
    _same_meta(pq, jq)
    _same_meta(ps, js)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sm.dequantize(pq, ps).numpy(),
                                  np.asarray(jsm.dequantize(jq, js)))


def test_quantized_layer_end_to_end():
    """quantize -> int8_matmul(scale=) -> float32, both packages."""
    x, w = _mk((64, 96)), _mk((96, 48), 1)
    outs = []
    for mod in (jsm, sm):
        qx, sx = mod.quantize(x)
        qw, sw = mod.quantize(w, axis=0)
        outs.append(np.asarray(mod.int8_matmul(qx, qw, scale=sx * sw).numpy()
                               if mod is sm else mod.int8_matmul(qx, qw, scale=sx * sw)))
    np.testing.assert_array_equal(outs[1], outs[0])
    assert np.abs(outs[1] - x @ w).max() < 0.05 * np.abs(x @ w).max()


# ------------------------------------------------------ dot / matmul / @
_DOT_SHAPES = [
    ((5,), (5,)), ((4, 5), (5,)), ((5,), (5, 3)), ((4, 5), (5, 3)), ((2, 4, 5), (5, 3)),
    ((4, 5), (2, 5, 3)), ((2, 4, 5), (3, 5, 6)), ((2, 3, 4, 5), (6, 5, 3)), ((), (3, 2)),
    ((3, 4, 5), (5,)), ((5,), (2, 3, 5, 4)),
]
_MATMUL_SHAPES = [
    ((4, 5), (5, 3)), ((2, 4, 5), (2, 5, 3)), ((2, 4, 5), (5, 3)), ((4, 5), (2, 5, 3)),
    ((2, 3, 4, 5), (3, 5, 6)), ((2, 1, 4, 5), (3, 5, 6)), ((5,), (5, 3)), ((4, 5), (5,)),
    ((5,), (2, 5, 3)), ((2, 4, 5), (5,)), ((5,), (5,)),
]
_DTYPES = ["float32", "float64", "int32", "bfloat16", "complex64"]


def _operand(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return _pair(rng.integers(-50, 50, shape).astype(np.int32))
    if dtype == "complex64":
        return _pair((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64))
    if dtype == "bfloat16":
        return _pair(rng.standard_normal(shape).astype(np.float32), jnp.bfloat16)
    return _pair(rng.standard_normal(shape).astype(dtype))


def _check_product(got, want, dtype):
    _same_meta(got, want)
    w = np.asarray(want)
    if dtype == "int32":
        np.testing.assert_array_equal(got.numpy(), w)
    else:
        rtol = 1e-12 if dtype == "float64" else 1e-5
        np.testing.assert_allclose(got.numpy(), w, rtol=rtol, atol=1e-12 if dtype == "float64" else 1e-5)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("shapes", _DOT_SHAPES, ids=str)
def test_dot_every_rank_matches_jax(shapes, dtype):
    (ja, pa), (jb, pb) = _operand(shapes[0], dtype, 0), _operand(shapes[1], dtype, 1)
    _check_product(sm.dot(pa, pb), jsm.dot(ja, jb), dtype)
    if shapes[0]:
        _check_product(pa @ pb, ja @ jb, dtype)
        _check_product(pa.dot(pb), ja.dot(jb), dtype)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("shapes", _MATMUL_SHAPES, ids=str)
def test_matmul_every_rank_matches_jax(shapes, dtype):
    (ja, pa), (jb, pb) = _operand(shapes[0], dtype, 0), _operand(shapes[1], dtype, 1)
    _check_product(sm.matmul(pa, pb), jsm.matmul(ja, jb), dtype)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("fn", ["dot", "matmul"])
def test_products_of_views_match_jax(fn, dtype):
    (ja, pa), (jb, pb) = _operand((12, 10), dtype, 0), _operand((16, 20), dtype, 1)
    cases = [
        lambda a, b: (a.T, b[:12, ::2]),              # (10, 12) @ (12, 10)
        lambda a, b: (a[::-1, ::-2], b[3:8, ::-1]),   # (12, 5) @ (5, 20)
        lambda a, b: (a[1], b[:10, 2]),               # 1-D views
        lambda a, b: (a[::3].T, b.T[:, 4:8].T),       # (10, 4) @ (4, 20)
    ]
    for views in cases:
        jx, jy = views(ja, jb)
        px, py = views(pa, pb)
        _check_product(getattr(sm, fn)(px, py), getattr(jsm, fn)(jx, jy), dtype)


_PRODUCT_PAIRS = [("bfloat16", "bfloat16"), ("float16", "float16"), ("int8", "int8"),
                  ("uint8", "int8"), ("bool", "bool"), ("float32", "int32"), ("int32", "int64"),
                  ("bfloat16", "float32"), ("int16", "int16"), ("uint32", "uint32"),
                  ("complex64", "float32"), ("int32", "bool"), ("bfloat16", "int8"),
                  ("uint8", "uint8"), ("int64", "int64"), ("float64", "float32")]


@pytest.mark.parametrize("pair", _PRODUCT_PAIRS, ids=str)
def test_product_result_types_and_values_match_jax(pair):
    """Result types of mixed operands (bfloat16 and float16 products are
    float32, narrow integers wrap in their own type), values exact for
    integers."""
    rng = np.random.default_rng(3)

    def make(name, shape):
        if name == "bool":
            return _pair(rng.standard_normal(shape) > 0)
        if name in ("bfloat16", "float16"):
            return _pair(rng.standard_normal(shape).astype(np.float32), jnp.dtype(name))
        if np.issubdtype(np.dtype(name), np.integer):
            info = np.iinfo(name)
            return _pair(rng.integers(max(info.min, -200), min(info.max, 200) + 1, shape).astype(name))
        return _pair(rng.standard_normal(shape).astype(name))

    (ja, pa), (jb, pb) = make(pair[0], (6, 40)), make(pair[1], (40, 7))
    for fn in ("dot", "matmul"):
        want, got = getattr(jsm, fn)(ja, jb), getattr(sm, fn)(pa, pb)
        _same_meta(got, want)
        assert got.dtype == engine.product_dtype(pa.dtype, pb.dtype)
        w = np.asarray(want.jax().astype(jnp.float32)) if want.dtype == jnp.bfloat16 else np.asarray(want)
        if got.dtype.is_floating_point or got.dtype.is_complex:
            np.testing.assert_allclose(got.numpy(), w, rtol=2e-3 if "float16" in pair else 1e-5, atol=1e-4)
        else:
            np.testing.assert_array_equal(got.numpy(), w)


def test_int32_product_wraps_exactly():
    a = np.full((3, 600), 40_000, np.int32)
    b = np.full((600, 2), 40_000, np.int32)
    want = (40_000 * 40_000 * 600) % (1 << 32) - (1 << 32)
    for fn in (sm.dot, sm.matmul):
        got = fn(a, b)
        assert got.dtype == torch.int32 and np.all(got.numpy() == want)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jsm.dot(a, b)))


def _wide_pair(rng, name, shape):
    """Full-range values of ``name``: int64 beyond 2**62, uint64 beyond 2**63."""
    if name == "uint64":
        x = rng.integers(0, 2**63, shape, dtype=np.uint64) * np.uint64(2) + np.uint64(1)
    elif name == "int64":
        x = rng.integers(-2**63, 2**63 - 1, shape, dtype=np.int64)
    else:
        info = np.iinfo(name)
        x = rng.integers(info.min, info.max, shape, dtype=np.int64).astype(name)
    return _pair(x)


_WIDE_PAIRS = [("int64", "int64"), ("uint64", "uint64"), ("int64", "int32"), ("int8", "int64"),
               ("uint64", "uint8"), ("int16", "int64"), ("bool", "int64"), ("uint32", "uint64")]


@pytest.mark.parametrize("pair", _WIDE_PAIRS, ids=str)
@pytest.mark.parametrize("fn", ["dot", "matmul"])
def test_64_bit_products_wrap_as_the_jax_package(fn, pair):
    """int64 and uint64 products of full-range values wrap mod 2**64 as the
    JAX package's int64 ``jnp.dot`` does (x64 on), in both result types; on
    the card they run the 64-bit accumulator of the matmul kernel
    (``imad_i64``), here its plain version."""
    rng = np.random.default_rng(7)
    if pair[0] == "bool":
        (ja, pa) = _pair(rng.standard_normal((9, 33)) > 0)
    else:
        (ja, pa) = _wide_pair(rng, pair[0], (9, 33))
    (jb, pb) = _wide_pair(rng, pair[1], (33, 11))
    want, got = getattr(jsm, fn)(ja, jb), getattr(sm, fn)(pa, pb)
    _same_meta(got, want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if "int64" in pair or "uint64" in pair:  # the product passes 2**63 somewhere
        assert np.abs(np.asarray(want).astype(np.float64)).max() > 2.0**62


def test_64_bit_batched_and_view_products_match_jax():
    """Rank 3, a transposed and a negative-step view, int64 and uint64."""
    rng = np.random.default_rng(8)
    for name in ("int64", "uint64"):
        ja, pa = _wide_pair(rng, name, (3, 12, 20))
        jb, pb = _wide_pair(rng, name, (3, 20, 7))
        _check_wide(sm.matmul(pa, pb), jsm.matmul(ja, jb))
        _check_wide(sm.matmul(pa[0].T, pa[1][::-1, ::-2]), jsm.matmul(ja[0].T, ja[1][::-1, ::-2]))
        _check_wide(sm.dot(pa[2, ::2], pb[2]), jsm.dot(ja[2, ::2], jb[2]))


def _check_wide(got, want):
    _same_meta(got, want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_64_bit_product_on_the_cpu_runs_the_plain_version():
    """The wrapper's plain version: the CPU's int64 product; a uint64 operand
    read by its bits; no launch counted; an epilogue refused, as the
    kernel takes none."""
    a = torch.tensor([[2**62, 3], [-1, 2**40]], dtype=torch.int64)
    b = torch.tensor([[4, 1], [5, 2**30]], dtype=torch.int64)
    matmul.reset_launches()
    got = matmul.matmul(a, b, torch.int64)
    assert torch.equal(got, a @ b) and int(got[0, 0]) == 15  # 2**64 + 15 wraps to 15
    u = b.view(torch.uint64)
    assert torch.equal(matmul.matmul(a, u, torch.int64), a @ b)
    assert matmul.VARIANTS == {k: 0 for k in matmul.VARIANTS}
    leaf = program.leaf((2, 2), torch.int64)
    with pytest.raises(TypeError, match="takes no epilogue"):
        matmul.matmul(a, b, torch.int64, epilogue=program.lower_epilogue(leaf * 2, leaf, []))


def test_fused_64_bit_root_takes_the_product_then_the_epilogue():
    """A fused root over an int64 product: the JAX package computes the
    product and then the epilogue (its kernel takes float types alone); the
    port does the same, the product through ``engine.matmul`` (on the card
    the 64-bit accumulator), the epilogue as torch."""
    rng = np.random.default_rng(9)
    (ja, pa), (jb, pb) = _wide_pair(rng, "int64", (8, 16)), _wide_pair(rng, "int64", (16, 5))
    (jc, pc) = _pair(rng.integers(-9, 9, (1, 5)).astype(np.int64))

    def fn(mod):
        return mod.fuse(lambda x, w, c: mod.maximum(x @ w + c, 0) * 3)

    dispatch.reset()
    got = fn(sm)(pa, pb, pc)
    want = fn(jsm)(ja, jb, jc)
    _check_wide(got, want)
    assert dispatch.count("torch_path", "matmul_epilogue") == 1


def test_complex64_native_product_keeps_a_dominated_component():
    """The JAX package splits a complex product into real ones only because a
    TPU has no complex type, and picks the naive four-product split where
    accuracy matters (tests/test_complex_and_debug.py): a dominated
    imaginary part must keep its relative accuracy.  torch's native
    complex64 product does, so the port needs no split."""
    rng = np.random.default_rng(0)
    ar = rng.normal(size=(32, 64)).astype(np.float32)
    br = rng.normal(size=(64, 32)).astype(np.float32)
    bi = (1e-6 * rng.normal(size=(64, 32))).astype(np.float32)
    a, b = ar.astype(np.complex64), (br + 1j * bi).astype(np.complex64)
    want = a.astype(np.complex128) @ b.astype(np.complex128)
    for fn in (sm.dot, sm.matmul):
        out = fn(a, b)
        assert out.dtype == torch.complex64
        got = out.numpy()
        assert np.abs(got.imag - want.imag).max() / np.abs(want.imag).max() < 1e-3
        np.testing.assert_allclose(got.real, want.real, rtol=1e-4, atol=1e-4)
    from simplemath_tpu.ops import complexmm

    split = np.asarray(complexmm.complex_matmul(a, b))
    np.testing.assert_allclose(got, split, rtol=1e-4, atol=1e-5)


_SHAPE_ERRORS = [
    ("dot", (4, 5), (4, 3), TypeError, "contracting dimensions"),
    ("dot", (5,), (4,), TypeError, "contracting dimensions"),
    ("dot", (2, 4, 5), (3, 4, 3), TypeError, "contracting dimensions"),
    ("matmul", (4, 5), (4, 3), TypeError, "contracting dimensions"),
    ("matmul", (5,), (4,), TypeError, "contracting dimensions"),
    ("matmul", (2, 4, 5), (3, 5, 3), ValueError, "Incompatible shapes for matmul"),
    ("matmul", (), (3,), ValueError, "ndim at least 1"),
]


@pytest.mark.parametrize("fn,sa,sb,exc,match", _SHAPE_ERRORS, ids=str)
def test_product_shape_errors_match_jax(fn, sa, sb, exc, match):
    for mod in (jsm, sm):
        with pytest.raises(exc, match=match):
            getattr(mod, fn)(mod.Array(_mk(sa)), mod.Array(_mk(sb, 1)))


# --------------------------------------------------- the wrapper by itself
def test_dispatch_names_and_launch_bookkeeping_on_the_cpu():
    """The wrapper records the JAX package's names; on CPU tensors it runs
    the plain version and counts no launch; a float product through
    ``torch.matmul`` is recorded as ``torch_path``, not as a kernel call."""
    a, b = torch.from_numpy(_mk((8, 6))), torch.from_numpy(_mk((6, 4), 1))
    matmul.matmul(a, b)
    matmul.matmul(a[None], b[None])
    leaf = program.leaf((8, 4), torch.float32)
    matmul.matmul(a, b, epilogue=program.lower_epilogue(leaf * 2.0, leaf, []))
    assert dispatch.counts() == {"matmul:mm": 2, "matmul:bmm": 1, "matmul:mm_epilogue": 1}
    dispatch.reset()
    sm.dot(sm.Array(a), sm.Array(b))
    sm.matmul(sm.Array(a.int()), sm.Array(b.int()))
    assert dispatch.counts() == {"torch_path:dot": 1, "matmul:mm": 1}
    assert matmul.LAUNCHES == {"mm": 0, "bmm": 0}


def test_wrapper_refuses_what_the_kernel_does_not_take():
    a, b = torch.from_numpy(_mk((8, 6))), torch.from_numpy(_mk((6, 4), 1))
    with pytest.raises(ValueError, match=r"\(M, K\) @ \(K, N\)"):
        matmul.matmul(a, b.T)
    with pytest.raises(ValueError, match="non-empty"):
        matmul.matmul(a[:0], b)
    with pytest.raises(TypeError, match="float32/bfloat16 or int8/uint8/int32"):
        matmul.matmul(a.double(), b.double())
    with pytest.raises(TypeError, match="cannot be stored as"):
        matmul.matmul(a, b, torch.int32)
    leaf, e = program.leaf((8, 4), torch.float32), program.leaf((1, 4), torch.float32)
    epilogue = program.lower_epilogue(leaf + e, leaf, [e])
    with pytest.raises(ValueError, match="not broadcastable"):
        matmul.matmul(a, b, epilogue=epilogue, extras=[torch.zeros(3, 4)])
    with pytest.raises(ValueError, match="the epilogue reads"):
        matmul.matmul(a, b, epilogue=epilogue, extras=[torch.zeros(1, 4, dtype=torch.int32)])
    with pytest.raises(ValueError, match="CUDA tensors"):
        matmul.matmul(a.to("meta"), b.to("meta"))  # no fallback off the CPU


def test_precision_default_is_exact_float32():
    """``precision="default"`` and ``"highest"`` are both exact float32: far
    closer to float64 than a product of operands truncated to bfloat16,
    which is what the JAX package's "default" means on a TPU."""
    x, w = _mk((64, 256)), _mk((256, 48), 1)
    a, b = torch.from_numpy(x), torch.from_numpy(w)
    ref = x.astype(np.float64) @ w.astype(np.float64)
    default = matmul.matmul(a, b, precision="default")
    assert torch.equal(default, matmul.matmul(a, b, precision="highest"))
    assert np.abs(default.numpy() - ref).max() < 1e-4
    truncated = a.bfloat16().float() @ b.bfloat16().float()
    assert np.abs(truncated.numpy() - ref).max() > 1e-2
    with pytest.raises(ValueError, match="precision must be one of"):
        matmul.matmul(a, b, precision="tf32")


def test_float32_products_pin_tf32_off():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with matmul.exact_float32():
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.parametrize("case", ["row", "column", "full", "scalar", "bf16_row", "compare", "int"])
def test_epilogue_lowering_runs_like_the_traced_function(case):
    """An epilogue lowered to a program (register 0 = the product) and run
    through ``program.run_plain`` gives the traced function's values."""
    M, N = 12, 20
    acc_dtype = torch.int32 if case == "int" else torch.float32
    acc = program.leaf((M, N), acc_dtype)
    prod = (np.random.default_rng(0).integers(-99, 99, (M, N)).astype(np.int32) if case == "int"
            else _mk((M, N)))
    extra = {"row": _mk((1, N), 1), "column": _mk((M, 1), 1), "full": _mk((M, N), 1),
             "scalar": _mk((), 1), "bf16_row": _mk((1, N), 1), "compare": _mk((1, N), 1),
             "int": np.arange(N, dtype=np.int32).reshape(1, N)}[case]
    t_extra = torch.from_numpy(np.asarray(extra))
    if case == "bf16_row":
        t_extra = t_extra.bfloat16()
    leaf = program.leaf(tuple(t_extra.shape), t_extra.dtype)
    fn = {"compare": lambda p, e: sm.where(p > e, p, e * 0.5),
          "int": lambda p, e: sm.maximum(p * 3 - e, 0)}.get(
              case, lambda p, e: sm.maximum(p * 0.25 + e, 0.0) - 1.0)
    prog = program.lower_epilogue(fn(acc, leaf), acc, [leaf])
    assert prog.leaf_dtypes[0] == acc_dtype and prog.kernel_codes is not None
    if case == "bf16_row":  # widened at the load: the leaf enters as float32
        assert prog.leaf_dtypes[1] == torch.float32
        assert not any(op == "cast" for op, *_ in prog.insts)
        t_extra = t_extra.float()
    got = program.run_plain(prog, [torch.from_numpy(prod), t_extra], (M, N)).numpy()
    e = t_extra.numpy()
    want = {"compare": lambda: np.where(prod > e, prod, e * np.float32(0.5)),
            "int": lambda: np.maximum(prod * 3 - e, 0)}.get(
                case, lambda: np.maximum(prod * np.float32(0.25) + e, 0) - np.float32(1.0))()
    np.testing.assert_array_equal(got, want.astype(got.dtype))


def test_epilogue_that_computes_in_bfloat16_has_no_kernel_form():
    """The elementwise kernel takes bfloat16 instructions; the matmul
    kernel's epilogue does not (matmul.EPILOGUE_DTYPES), and its wrapper
    refuses such a program."""
    acc = program.leaf((4, 4), torch.float32)
    b1, b2 = program.leaf((1, 4), torch.bfloat16), program.leaf((1, 4), torch.bfloat16)
    prog = program.lower_epilogue(acc + b1 * b2, acc, [b1, b2])
    assert prog.leaf_dtypes[1:] == (torch.bfloat16, torch.bfloat16)
    assert torch.bfloat16 in prog.dtypes and not prog.dtypes <= matmul.EPILOGUE_DTYPES
    acc = program.leaf((4, 4), torch.float32)
    rounded = program.lower_epilogue(
        program.cast(program.cast(acc, torch.bfloat16) * 2.0, torch.float32), acc, [])
    with pytest.raises(TypeError, match="does not compute in"):
        matmul.matmul(torch.ones(4, 3), torch.ones(3, 4), epilogue=rounded)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "uint8", "float16"])
def test_from_reference_keeps_narrow_dtypes(dtype):
    """Arrays of the JAX package in the matmul path's narrow types arrive in
    the port with the dtype and the bits kept, views included."""
    x = _mk((6, 8)) * 20
    ja = jsm.Array(jnp.asarray(x).astype(dtype))[1::2, ::-1]
    pa = sm.from_reference(np.asarray(ja._storage.buf), ja._spec)
    assert dtypes.name(pa.dtype) == dtype and pa.shape == ja.shape and pa.is_view
    np.testing.assert_array_equal(pa.numpy().astype(np.float32),
                                  np.asarray(ja.jax().astype(jnp.float32)))


# ------------------------------------ the tensor-core route (bf16 @ bf16)
_VARIANT_PAIRS = [
    ("bfloat16", "bfloat16", "wgmma_bf16"), ("float32", "float32", "fma_f32"),
    ("float32", "bfloat16", "fma_f32"), ("bfloat16", "float32", "fma_f32"),
    ("int8", "int8", "wgmma_s8"), ("int8", "uint8", "wgmma_s8"), ("uint8", "uint8", "wgmma_s8"),
    ("uint8", "int8", "wgmma_s8"),
    ("int32", "int32", "imad_i32"), ("int32", "int8", "imad_i32"), ("uint8", "int32", "imad_i32"),
    ("int64", "int64", "imad_i64"), ("uint64", "uint64", "imad_i64"), ("int64", "int32", "imad_i64"),
    ("int8", "int64", "imad_i64"), ("uint8", "uint64", "imad_i64"), ("uint64", "int64", "imad_i64"),
    ("float64", "float64", None), ("float16", "float16", None), ("bfloat16", "int8", None),
    ("float32", "int32", None), ("int16", "int64", None), ("float32", "int64", None),
]


@pytest.mark.parametrize("a,b,want", _VARIANT_PAIRS, ids=str)
def test_kernel_variant_follows_the_operand_types_alone(a, b, want):
    """bf16 @ bf16 takes the bf16 tensor-core kernel and a pair of 1-byte
    integers the int8 one; every other pair the kernel takes (any with an
    int32 or a float32 operand) keeps its CUDA-core instantiation; the rest
    have none."""
    da, db = getattr(torch, a), getattr(torch, b)
    assert matmul.variant(da, db) == want
    assert (matmul.variant(da, db) is None) == (matmul.accumulator(da, db) is None)
    assert want is None or want in matmul.VARIANTS


def _bf16_view(case):
    """(operand of the product's shape (b, m, k) or (b, k, n), its
    contraction dim) for one staging case; bfloat16, on the CPU."""
    base = torch.zeros(64, 48, dtype=torch.bfloat16)          # 16-byte aligned, rows of 96 bytes
    return {
        "a_contiguous": (base, 2),                            # (M, K), K contiguous
        "b_contiguous": (base, 1),                            # (K, N), N contiguous
        "a_transposed": (base.T, 2),                          # (M, K) with M contiguous
        "b_transposed": (base.T, 1),                          # (K, N) with K contiguous
        "rows_reversed": (base.flip(0), 2),                   # handled by View below
        "row_slice_aligned": (base[::2, 8:40], 2),            # strides (96, 1), base 16 bytes in
        "unaligned_base": (base[::2, 10:42], 2),              # base 20 bytes in
        "odd_row_stride": (torch.zeros(64, 45, dtype=torch.bfloat16), 2),
        "column_step": (base[:, ::2], 2),                     # inner stride 2
        "ragged_k": (base[:, :45], 2),                        # K = 45: rows still start on 16 bytes
        "ragged_n": (base[:, :45], 1),
        "broadcast_rows": (base[:1].expand(64, 48), 2),       # stride 0 over m
        "broadcast_inner": (base[:, :1].expand(64, 48), 2),   # stride 0 over k
        "single_row": (base[:1], 2),                          # M = 1: its stride counts as 0
        "single_column_k": (base[:, :1], 2),                  # K = 1, rows 96 bytes apart
        "contiguous_column_k": (torch.zeros(64, 1, dtype=torch.bfloat16), 2),  # K = 1, m contiguous
        "batched": (torch.zeros(3, 16, 24, dtype=torch.bfloat16), 2),
        "batched_odd_batch_stride": (torch.zeros(3, 17, 24, dtype=torch.bfloat16)[:, :16], 2),
    }[case]


_STAGING = {
    # case: (k_major, vec16)
    "a_contiguous": (True, True), "b_contiguous": (False, True),
    "a_transposed": (False, True), "b_transposed": (True, True),
    "rows_reversed": (True, True), "row_slice_aligned": (True, True),
    "unaligned_base": (True, False), "odd_row_stride": (True, False),
    "column_step": (True, False), "ragged_k": (True, True), "ragged_n": (False, True),
    "broadcast_rows": (True, True), "broadcast_inner": (True, False),
    "single_row": (True, True), "single_column_k": (True, False),
    "contiguous_column_k": (False, True),
    "batched": (True, True), "batched_odd_batch_stride": (True, True),
}


@pytest.mark.parametrize("case", sorted(_STAGING))
def test_staging_decision_per_operand(case):
    """16-byte copies need stride 1 along one matrix dim, every other stride
    a multiple of 8 elements and a 16-byte-aligned first element; anything
    else is read element by element.  The order says which dim is the
    shared tile's contiguous one."""
    t, contraction = _bf16_view(case)
    if case == "rows_reversed":  # torch has no negative strides: a View does
        from simplemath_tpu_torch.ops import elementwise
        flat = torch.zeros(64, 48, dtype=torch.bfloat16)
        t = elementwise.View(flat, 63 * 48, (64, 48), (-48, 1))
    op = matmul._MmOperand()
    matmul._set_operand(op, t, len(t.shape) == 3, contraction, "wgmma_bf16")
    assert (bool(op.inner_fast), bool(op.vec16)) == _STAGING[case]
    # and the plain function on the same strides and address
    strides = [op.strides[d] for d in range(3)]
    assert matmul.staging(strides, contraction, op.ptr) == _STAGING[case]
    if case == "batched_odd_batch_stride":
        assert strides[0] == 17 * 24  # 408: a multiple of 8, so batches stay aligned


def test_staging_needs_aligned_batches_and_negative_inner_steps_go_element_wise():
    assert matmul.staging([404, 24, 1], 2, 0) == (True, False)   # batch stride 404 % 8 != 0
    assert matmul.staging([0, 24, 1], 2, 16) == (True, True)
    assert matmul.staging([0, 24, 1], 2, 18) == (True, False)    # base off by 2 bytes
    assert matmul.staging([0, 24, -1], 2, 0) == (True, False)    # negative step along k
    assert matmul.staging([0, -24, 1], 2, 0) == (True, True)     # rows backwards: still rows
    assert matmul.staging([0, -1, 24], 2, 0) == (False, False)
    assert matmul.staging([0, 3, 50], 1, 0) == (True, False)     # B: the smaller step leads
    assert matmul.staging([0, 50, 3], 1, 0) == (False, False)
    # The CUDA-core kernel copies its 4-byte operands 16 bytes at a time too
    # (rows of 8 float32 are 32 bytes), and a narrower one element by element.
    op = matmul._MmOperand()
    matmul._set_operand(op, torch.zeros(8, 8), False, 2, "fma_f32")
    assert (op.inner_fast, op.vec16) == (1, 1)
    matmul._set_operand(op, torch.zeros(8, 8, dtype=torch.bfloat16), False, 2, "fma_f32")
    assert (op.inner_fast, op.vec16) == (1, 0)


def _f32_view(case):
    """(operand, its contraction dim, kernel) for one staging case of the
    CUDA-core kernel; 4-byte types (and the narrow operand of a mixed
    pair), on the CPU."""
    base = torch.zeros(64, 48)                                 # rows of 192 bytes
    return {
        "a_contiguous": (base, 2, "fma_f32"),
        "b_contiguous": (base, 1, "fma_f32"),
        "a_transposed": (base.T, 2, "fma_f32"),               # M contiguous: MN-major copies
        "b_transposed": (base.T, 1, "fma_f32"),
        "int32": (base.int(), 2, "imad_i32"),
        "rows_of_45": (torch.zeros(64, 45), 2, "fma_f32"),     # 180 bytes: not a multiple of 16
        "four_bytes_off": (base[:, 1:45], 2, "fma_f32"),
        "sixteen_bytes_in": (base[::2, 4:44], 2, "fma_f32"),
        "column_step": (base[:, ::2], 2, "fma_f32"),
        "ragged_k": (base[:, :45], 2, "fma_f32"),             # rows still start on 16 bytes
        "broadcast_rows": (base[:1].expand(64, 48), 2, "fma_f32"),
        "batched": (torch.zeros(3, 16, 24), 2, "fma_f32"),
        "batched_odd_batch_stride": (torch.zeros(3, 17, 24)[:, :16], 2, "fma_f32"),  # 408 = 4 x 102
        "bf16_beside_f32": (base.bfloat16(), 2, "fma_f32"),   # widened element by element
        "int8_beside_int32": (base.to(torch.int8), 1, "imad_i32"),
    }[case]


_F32_STAGING = {
    # case: (k_major, vec16)
    "a_contiguous": (True, True), "b_contiguous": (False, True),
    "a_transposed": (False, True), "b_transposed": (True, True), "int32": (True, True),
    "rows_of_45": (True, False), "four_bytes_off": (True, False),
    "sixteen_bytes_in": (True, True), "column_step": (True, False), "ragged_k": (True, True),
    "broadcast_rows": (True, True), "batched": (True, True),
    "batched_odd_batch_stride": (True, True), "bf16_beside_f32": (True, False),
    "int8_beside_int32": (False, False),
}


@pytest.mark.parametrize("case", sorted(_F32_STAGING))
def test_staging_decision_per_four_byte_operand(case):
    """The CUDA-core kernel copies a 4-byte operand 16 bytes at a time where
    one matrix dim has stride 1, every other stride is a multiple of 4
    elements and the first element lies on 16 bytes, into a K-major or an
    MN-major tile by ``k_major``; anything else, and any narrower operand,
    is read element by element into the same layout."""
    t, contraction, kernel = _f32_view(case)
    op = matmul._MmOperand()
    matmul._set_operand(op, t, len(t.shape) == 3, contraction, kernel)
    assert (bool(op.inner_fast), bool(op.vec16)) == _F32_STAGING[case]
    strides = [op.strides[d] for d in range(3)]
    k_major, vec16 = matmul.staging(strides, contraction, op.ptr, t.element_size())
    assert k_major == _F32_STAGING[case][0]
    if t.element_size() == 4:  # a narrower operand is read element by element whatever it is
        assert vec16 == _F32_STAGING[case][1]


def _int8_view(case):
    """(operand of the product's shape (b, m, k) or (b, k, n), its
    contraction dim) for one staging case; int8 or uint8, on the CPU."""
    base = torch.zeros(64, 48, dtype=torch.int8)               # rows of 48 bytes: 16-byte aligned
    return {
        "a_contiguous": (base, 2),                             # (M, K), K contiguous: copied
        "b_contiguous": (base, 1),                             # (K, N), N contiguous: transposed
        "a_transposed": (base.T, 2),                           # (M, K) with M contiguous: transposed
        "b_transposed": (base.T, 1),                           # (K, N) with K contiguous: copied
        "rows_of_40_bytes": (torch.zeros(64, 40, dtype=torch.uint8), 2),   # 40 % 16 != 0
        "rows_of_8_elements": (torch.zeros(64, 8, dtype=torch.uint8), 2),  # a bf16 chunk, not a byte one
        "one_byte_off": (base[:, 1:33], 2),
        "sixteen_bytes_in": (base[:, 16:48], 2),
        "column_step": (base[:, ::2], 2),
        "ragged_k": (base[:, :45], 2),                         # K = 45: rows still start on 16 bytes
        "ragged_n": (base[:, :45], 1),
        "broadcast_rows": (base[:1].expand(64, 48), 2),        # stride 0 over m
        "broadcast_inner": (base[:, :1].expand(64, 48), 2),    # stride 0 over k
        "batched": (torch.zeros(3, 16, 32, dtype=torch.int8), 2),
        "batched_odd_batch_stride": (torch.zeros(3, 17, 24, dtype=torch.int8)[:, :16], 2),  # 408 % 16
        "batched_aligned_batch_stride": (torch.zeros(3, 18, 32, dtype=torch.int8)[:, :16], 2),
    }[case]


_INT8_STAGING = {
    # case: (k_major, vec16)
    "a_contiguous": (True, True), "b_contiguous": (False, True),
    "a_transposed": (False, True), "b_transposed": (True, True),
    "rows_of_40_bytes": (True, False), "rows_of_8_elements": (True, False),
    "one_byte_off": (True, False), "sixteen_bytes_in": (True, True),
    "column_step": (True, False), "ragged_k": (True, True), "ragged_n": (False, True),
    "broadcast_rows": (True, True), "broadcast_inner": (True, False),
    "batched": (True, True), "batched_odd_batch_stride": (True, False),
    "batched_aligned_batch_stride": (True, True),
}


@pytest.mark.parametrize("case", sorted(_INT8_STAGING))
def test_staging_decision_per_one_byte_operand(case):
    """A 1-byte operand is read 16 bytes at a time where one matrix dim has
    stride 1, every other stride is a multiple of 16 elements and the first
    element lies on 16 bytes; ``k_major`` then says whether it is copied as
    it is or transposed on its way in.  Anything else is read byte by
    byte."""
    t, contraction = _int8_view(case)
    op = matmul._MmOperand()
    matmul._set_operand(op, t, len(t.shape) == 3, contraction, "wgmma_s8")
    assert (bool(op.inner_fast), bool(op.vec16)) == _INT8_STAGING[case]
    strides = [op.strides[d] for d in range(3)]
    assert matmul.staging(strides, contraction, op.ptr, 1) == _INT8_STAGING[case]


def test_staging_of_one_byte_operands_negative_and_zero_strides():
    assert matmul.staging([0, 48, 1], 2, 0, 1) == (True, True)
    assert matmul.staging([0, 48, 1], 2, 8, 1) == (True, False)     # 8 bytes in: a bf16 chunk only
    assert matmul.staging([0, 48, 1], 2, 8, 2) == (True, False)     # 48 elements of bf16: 96 bytes, base 8
    assert matmul.staging([0, 24, 1], 2, 0, 1) == (True, False)     # rows of 24 bytes
    assert matmul.staging([0, 24, 1], 2, 0, 2) == (True, True)      # rows of 24 bf16: 48 bytes
    assert matmul.staging([0, -48, 1], 2, 0, 1) == (True, True)     # rows backwards: still rows
    assert matmul.staging([0, 48, -1], 2, 0, 1) == (True, False)    # negative step along k
    assert matmul.staging([0, 0, 1], 2, 0, 1) == (True, True)       # one row broadcast over m
    assert matmul.staging([0, 1, 0], 2, 0, 1) == (False, True)      # one column broadcast over k
    assert matmul.staging([0, 1, 48], 1, 0, 1) == (True, True)      # B with k contiguous: copied
    assert matmul.staging([0, 48, 1], 1, 0, 1) == (False, True)     # row-major B: transposed
    assert matmul.staging([40, 48, 1], 2, 0, 1) == (True, False)    # batch stride 40 % 16 != 0
    assert matmul.staging([0, 3, 50], 1, 0, 1) == (True, False)     # B: the smaller step leads
    assert matmul.staging([0, 50, 3], 1, 0, 1) == (False, False)


_BF16_EDGES = {
    # name: (shape of a, shape of b, views applied to both packages' arrays)
    "k1": ((40, 1), (1, 24), None),
    "k77": ((33, 77), (77, 50), None),
    "ragged": ((129, 33), (33, 257), None),
    "a_transposed": ((77, 40), (77, 24), lambda a, b: (a.T, b)),
    "b_transposed": ((40, 77), (24, 77), lambda a, b: (a, b.T)),
    "both_transposed": ((77, 40), (24, 77), lambda a, b: (a.T, b.T)),
    "sliced": ((40, 90), (180, 30), lambda a, b: (a[:, 5:82], b[3:157:2, ::-1])),
    "batched": ((3, 20, 77), (3, 77, 12), None),
}


@pytest.mark.parametrize("name", sorted(_BF16_EDGES))
def test_bf16_product_matches_jax_at_the_edges(name):
    """The bare bf16 @ bf16 root of ``sm.fuse`` (the route to the matmul
    wrapper; ``sm.matmul`` of floats is ``torch.matmul``) against the JAX
    package (its Pallas kernels in interpret mode where they take the
    shape).  Both accumulate exact bf16 products in float32, in different
    orders, and round the sum to bfloat16 once: within one bfloat16 ulp
    (2**-7 relative) plus the sums' 2e-5 * (|A| @ |B|)."""
    sa, sb, views = _BF16_EDGES[name]
    (ja, pa), (jb, pb) = _operand(sa, "bfloat16", 0), _operand(sb, "bfloat16", 1)
    if views:
        (ja, jb), (pa, pb) = views(ja, jb), views(pa, pb)
    want = jsm.fuse(lambda x, w: x @ w)(ja, jb)
    got = sm.fuse(lambda x, w: x @ w)(pa, pb)
    _same_meta(got, want)
    assert got.dtype == torch.bfloat16
    a64 = np.asarray(ja.jax().astype(jnp.float32), np.float64)
    b64 = np.asarray(jb.jax().astype(jnp.float32), np.float64)
    ref, scale = a64 @ b64, np.abs(a64) @ np.abs(b64)
    tol = 2.0 ** -7 * np.abs(ref) + 2e-5 * scale + 1e-30
    w = np.asarray(want.jax().astype(jnp.float32), np.float64)
    assert np.all(np.abs(got.numpy().astype(np.float64) - ref) <= tol)
    assert np.all(np.abs(got.numpy().astype(np.float64) - w) <= 2 * tol)
    assert dispatch.count("matmul", "wgmma_bf16") == 1
    assert matmul.VARIANTS == {"wgmma_bf16": 0, "wgmma_s8": 0, "fma_f32": 0,
                               "imad_i32": 0, "imad_i64": 0}  # the CPU launches nothing


@pytest.mark.parametrize("name", ["k1", "k77", "a_transposed", "both_transposed", "batched"])
def test_fused_bf16_root_matches_jax_at_the_edges(name):
    """The fused bf16 root relu(x @ w + bias) * 0.5 - 0.25 at the same edge
    shapes: the epilogue sees the float32 accumulator and the result is
    rounded to bfloat16 once (tolerance as above, through the epilogue's
    slope of 0.5, plus the bias's own bfloat16 rounding: none, it is read
    as stored)."""
    sa, sb, views = _BF16_EDGES[name]
    (ja, pa), (jb, pb) = _operand(sa, "bfloat16", 0), _operand(sb, "bfloat16", 1)
    if views:
        (ja, jb), (pa, pb) = views(ja, jb), views(pa, pb)
    n = pb.shape[-1]
    jbias, pbias = _operand((1,) * (len(pb.shape) - 1) + (n,), "bfloat16", 2)

    def make(mod):
        return lambda x, w, b: mod.maximum(x @ w + b, 0.0) * 0.5 - 0.25

    want = jsm.fuse(make(jsm))(ja, jb, jbias)
    got = sm.fuse(make(sm))(pa, pb, pbias)
    _same_meta(got, want)
    a64 = np.asarray(ja.jax().astype(jnp.float32), np.float64)
    b64 = np.asarray(jb.jax().astype(jnp.float32), np.float64)
    bias64 = np.asarray(jbias.jax().astype(jnp.float32), np.float64)
    ref = np.maximum(a64 @ b64 + bias64, 0.0) * 0.5 - 0.25
    tol = 2.0 ** -7 * np.abs(ref) + 2e-5 * (np.abs(a64) @ np.abs(b64)) + 1e-6
    w = np.asarray(want.jax().astype(jnp.float32), np.float64)
    assert np.all(np.abs(got.numpy().astype(np.float64) - ref) <= tol)
    assert np.all(np.abs(got.numpy().astype(np.float64) - w) <= 2 * tol)
    batched = len(pa.shape) == 3
    assert dispatch.count("matmul", "bmm_epilogue" if batched else "mm_epilogue") == 1
    assert dispatch.count("matmul", "wgmma_bf16") == 1
    assert dispatch.count("torch_path", "matmul_epilogue") == 0


def test_mixed_and_float32_products_do_not_record_the_tensor_core_route():
    a, b = torch.from_numpy(_mk((8, 6))), torch.from_numpy(_mk((6, 4), 1))
    matmul.matmul(a, b.bfloat16())
    matmul.matmul(a.bfloat16(), b)
    matmul.matmul(a, b)
    matmul.matmul(a.to(torch.int32), b.to(torch.int8))
    assert dispatch.count("matmul", "wgmma_bf16") == 0 and dispatch.count("matmul", "wgmma_s8") == 0
    matmul.matmul(a.to(torch.int8), b.to(torch.uint8))
    assert dispatch.count("matmul", "wgmma_bf16") == 0 and dispatch.count("matmul", "wgmma_s8") == 1
    matmul.matmul(a.bfloat16(), b.bfloat16())
    matmul.matmul(a.bfloat16()[None], b.bfloat16()[None])
    assert dispatch.count("matmul", "wgmma_bf16") == 2 and dispatch.count("matmul", "wgmma_s8") == 1
    assert dispatch.count("matmul", "mm") == 6 and dispatch.count("matmul", "bmm") == 1


def test_epilogue_dispatch_lists_every_opcode():
    """The tensor-core kernels' epilogue and ``ew_flat`` dispatch an
    instruction once for four elements (or once per thread) through a list
    of the opcodes, ``SM_FOR_EACH_OPCODE`` in csrc/program.cuh; an opcode
    missing from it would still be right, but slow: the list is held to the
    kernel's opcode enum and to the port's table."""
    import pathlib
    import re

    csrc = pathlib.Path(program.__file__).resolve().parent.parent / "csrc"
    enum = re.search(r"enum SmOpcode : uint8_t \{(.*?)\};", (csrc / "tiles.cuh").read_text(), re.S)
    opcodes = [name.strip() for name in enum.group(1).replace("\n", " ").split(",") if name.strip()]
    macro = re.search(r"#define SM_FOR_EACH_OPCODE\(X\)(.*?)\n\n", (csrc / "program.cuh").read_text(),
                      re.S)
    listed = re.findall(r"X\((\w+)\)", macro.group(1))
    assert listed == opcodes
    assert [name.lower() for name in opcodes] == [name.lower() for name in program.OPCODES]
