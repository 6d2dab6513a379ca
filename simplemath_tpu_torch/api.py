"""User-facing factories and free functions.

Counterpart of ``simplemath_tpu/api.py``: the factories, the arithmetic
and transcendental free functions, the registry unaries,
``maximum``/``minimum``/``where``/``clip``, ``fuse``, the reductions
``sum/mean/max/min``, ``dot`` and ``matmul`` of every rank,
``int8_matmul`` with ``quantize``/``dequantize``, and the ``jnp`` façades
over torch (``prod``/``var``/``std``/``argmax``/``argmin``/``cumsum``/
``stack``/``concatenate``, ``eye``/``linspace``, ``transpose``/``reshape``/
``repeat``/``expand_dims``/``squeeze``, ``sort``, the rounding, inverse
trigonometric, hyperbolic, ``log10``/``log1p``/``expm1``/``arctan2`` and
``isnan``/``isinf``/``isfinite``).  Factories create arrays on
``config.device``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import dtypes as _dtypes
from .array import Array, asarray
from .config import config
from .ops import engine, fusion, reduction


def _shape_args(shape):
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        return tuple(int(s) for s in shape[0])
    return tuple(int(s) for s in shape)


def _full(shape, value, dtype) -> Array:
    return Array(torch.full(shape, value, dtype=_dtypes.canonicalize(dtype),
                            device=config.device))


def empty(*shape, dtype=torch.float32) -> Array:
    """Uninitialized-array factory; zero-filled, as in the JAX package."""
    return zeros(*shape, dtype=dtype)


def zeros(*shape, dtype=torch.float32) -> Array:
    return _full(_shape_args(shape), 0, dtype)


def ones(*shape, dtype=torch.float32) -> Array:
    return _full(_shape_args(shape), 1, dtype)


def full(*shape, fill_value, dtype=torch.float32) -> Array:
    return _full(_shape_args(shape), fill_value, dtype)


def eye(n, m=None, dtype=torch.float32) -> Array:
    return Array(torch.eye(n, n if m is None else m, dtype=_dtypes.canonicalize(dtype),
                           device=config.device))


def linspace(start, stop, num=50, dtype=torch.float32) -> Array:
    """``jnp.linspace``: ``num`` points from ``start`` to ``stop`` (both
    included), computed in float64 and cast once."""
    t = torch.linspace(float(start), float(stop), int(num), dtype=torch.float64)
    return Array(t.to(_dtypes.canonicalize(dtype)).to(config.device))


def arange(*args, dtype=None) -> Array:
    """``jnp.arange`` under x64: int64 for ints, float64 for floats."""
    if dtype is not None:
        dtype = _dtypes.to_numpy(_dtypes.canonicalize(dtype))
    return Array(np.arange(*args, dtype=dtype))


def zeros_like(a) -> Array:
    a = asarray(a)
    return _full(a.shape, 0, a.dtype)


def ones_like(a) -> Array:
    a = asarray(a)
    return _full(a.shape, 1, a.dtype)


def full_like(a, fill_value) -> Array:
    a = asarray(a)
    return _full(a.shape, fill_value, a.dtype)


def array(data, dtype=None) -> Array:
    return Array(data, dtype=dtype)


def pow(a, exponent) -> Array:
    """Free-function pow with working float pow and the reference's
    integer-pow edge semantics."""
    return engine.pow(a, exponent)


def dot(a, b):
    """``numpy.dot`` for every rank (ops/engine.py::dot).  Inside
    ``sm.fuse``, a product of two direct arguments is the matmul root whose
    elementwise consumers run as the matmul kernel's epilogue."""
    from .ops import fusion

    if fusion.is_fused(a) or fusion.is_fused(b):
        return fusion.matmul_node(a, b)
    return engine.dot(a, b)


def matmul(a, b) -> Array:
    """``numpy.matmul`` (ops/engine.py::matmul); inside ``sm.fuse`` the
    matmul root, as ``dot``."""
    from .ops import fusion

    if fusion.is_fused(a) or fusion.is_fused(b):
        return fusion.matmul_node(a, b)
    return engine.matmul(a, b)


def int8_matmul(a, b, scale=None) -> Array:
    """int8/uint8 matrix product (rank 2, or rank 3 with a batch) with exact
    int32 accumulation in the matmul kernel.  ``scale`` (typically
    ``scale_a * scale_b``) fuses the dequantization into the kernel's
    epilogue and gives float32."""
    from .ops import matmul as _mm

    a, b = asarray(a), asarray(b)
    if scale is not None and not isinstance(scale, (bool, int, float)):
        scale = asarray(scale)._operand()
    return Array(_mm.int8_matmul(a._operand(), b._operand(), scale=scale))


def quantize(x, scale=None, axis=None):
    """Symmetric int8 quantization: ``(q, scale)`` with
    ``q = clip(round(x / scale), -127, 127)`` (default scale max|x| / 127).
    ``axis`` gives per-channel scales (dims kept): ``axis=0`` on a (K, N)
    weight gives the (1, N) scales that ``int8_matmul``'s dequantizing
    epilogue reads in place."""
    from .ops import matmul as _mm

    if scale is not None and not isinstance(scale, (bool, int, float)):
        scale = asarray(scale).torch()
    q, s = _mm.quantize_int8(asarray(x).torch(), scale, axis=axis)
    return Array(q), Array(s)


def dequantize(q, scale) -> Array:
    """Inverse of ``quantize``; for ``int8_matmul`` results pass
    ``scale_a * scale_b``."""
    from .ops import matmul as _mm

    if not isinstance(scale, (bool, int, float)):
        scale = asarray(scale).torch()
    return Array(_mm.dequantize_int8(asarray(q).torch(), scale))


def add(a, b) -> Array:
    return engine.binary("add", a, b)


def subtract(a, b) -> Array:
    return engine.binary("subtract", a, b)


def multiply(a, b) -> Array:
    return engine.binary("multiply", a, b)


def divide(a, b) -> Array:
    return engine.binary("divide", a, b)


def maximum(a, b) -> Array:
    return engine.binary("maximum", a, b)


def minimum(a, b) -> Array:
    return engine.binary("minimum", a, b)


def _transcendental_unary(name: str, a) -> Array:
    """exp/log/exp2/log2 and the trig ops: crafted f32 implementations
    (sin/cos/tan native), float64 through torch's own op.  No engine
    record, as in the JAX package."""
    from .ops import fusion, lazy

    if fusion.is_fused(a):
        return fusion.unary_node(name, a)
    out = lazy.defer_unary(name, a)
    if out is not None:
        return out
    return engine.unary_eager(name, a)


def exp(a) -> Array:
    return _transcendental_unary("exp", a)


def log(a) -> Array:
    return _transcendental_unary("log", a)


def exp2(a) -> Array:
    return _transcendental_unary("exp2", a)


def log2(a) -> Array:
    return _transcendental_unary("log2", a)


def sin(a) -> Array:
    return _transcendental_unary("sin", a)


def cos(a) -> Array:
    return _transcendental_unary("cos", a)


def tan(a) -> Array:
    return _transcendental_unary("tan", a)


def tanh(a) -> Array:
    return _transcendental_unary("tanh", a)


def _unary_engine(name):
    def fn(a):
        return engine.unary(name, a)

    fn.__name__ = name
    return fn


abs = _unary_engine("abs")  # noqa: A001 - numpy-style namespace
sqrt = _unary_engine("sqrt")
square = _unary_engine("square")
negative = _unary_engine("negative")
sign = _unary_engine("sign")


def where(cond, x, y) -> Array:
    """Elementwise select: a registered ternary op."""
    return engine.ternary("where", cond, x, y)


def clip(a, a_min=None, a_max=None) -> Array:
    """NumPy ``clip``; a registered ternary op with both bounds, one
    ``maximum``/``minimum`` with one.  With one bound the JAX package runs
    ``jnp.clip`` at once, outside its deferred queue: so does the port,
    but inside ``sm.fuse``."""
    if a_min is None and a_max is None:
        raise ValueError("clip needs at least one of a_min and a_max")
    if a_min is None or a_max is None:
        name, bound = ("maximum", a_min) if a_max is None else ("minimum", a_max)
        if fusion.is_fused(a):
            return fusion.binary_node(name, a, bound)
        return engine.binary_eager(name, a, bound)
    return engine.ternary("clip", a, a_min, a_max)


def _reduce_free(name):
    """Free-function reductions: the same path as the Array methods; on a
    fused expression, the reduction root of ``sm.fuse``."""

    def fn(a, axis=None, keepdims=False):
        from .ops import fusion

        if fusion.is_fused(a):
            return fusion.reduce_node(name, a, axis=axis, keepdims=keepdims)
        return getattr(asarray(a), name)(axis=axis, keepdims=keepdims)

    fn.__name__ = name
    return fn


sum = _reduce_free("sum")  # noqa: A001 - numpy-style namespace
mean = _reduce_free("mean")
max = _reduce_free("max")  # noqa: A001
min = _reduce_free("min")  # noqa: A001


# The JAX package's jnp façades, as torch with jnp's result dtypes under
# x64; none of them composes with sm.fuse.
def _facade_input(name, a) -> torch.Tensor:
    from .ops import fusion

    if fusion.is_fused(a):
        raise TypeError(f"sm.{name} is not supported inside sm.fuse")
    return asarray(a).torch()


def _widened(t: torch.Tensor) -> torch.Tensor:
    """bool and unsigned integers as int64, which torch's CPU kernels take."""
    return t.to(torch.int64) if t.dtype in (torch.bool, torch.uint16, torch.uint32) else t


def prod(a, axis=None, keepdims=False) -> Array:
    """``jnp.prod``: integer and bool products in int64 (unsigned in uint64),
    bfloat16 and float16 in float32 cast back."""
    t = _facade_input("prod", a)
    dt, out = t.dtype, _dtypes.reduction_dtype(t.dtype, "prod")
    if dt == torch.bool or _dtypes.is_integer(dt):
        w = t.to(torch.int64)
    else:
        w = t.float() if dt in (torch.bfloat16, torch.float16) else t
    for d in sorted(reduction.axes(axis, t.ndim), reverse=True):
        w = w.prod(d, keepdim=keepdims)
    return Array(w.to(out))


def var(a, axis=None, keepdims=False, ddof=0) -> Array:
    """``jnp.var``: float inputs keep their dtype (bfloat16 computed in
    float32), integer and bool inputs give float32."""
    t = _facade_input("var", a)
    return Array(_var(t, axis, keepdims, ddof))


def std(a, axis=None, keepdims=False, ddof=0) -> Array:
    t = _facade_input("std", a)
    return Array(torch.sqrt(_var(t, axis, keepdims, ddof)))


def _var(t, axis, keepdims, ddof):
    dims = reduction.axes(axis, t.ndim)
    out = _dtypes.to_inexact(t.dtype)
    comp = torch.float32 if out in (torch.bfloat16, torch.float16) else out
    x = t.to(comp)
    n = 1
    for d in dims:
        n *= t.shape[d]
    centered = x - reduction.divide(x.sum(dims, keepdim=True), n)
    total = (centered * centered).sum(dims, keepdim=keepdims)
    return reduction.divide(total, n - ddof).to(out)


def _arg(name, fn):
    def wrapped(a, axis=None, keepdims=False):
        t = _widened(_facade_input(name, a))
        if axis is None:
            out = fn(t.reshape(-1))
            return Array(out.reshape((1,) * t.ndim) if keepdims else out)
        return Array(fn(t, reduction.axes(axis, t.ndim)[0], keepdim=keepdims))

    wrapped.__name__ = name
    return wrapped


argmax = _arg("argmax", torch.argmax)
argmin = _arg("argmin", torch.argmin)


def cumsum(a, axis=None, dtype=None) -> Array:
    """``jnp.cumsum``: keeps integer dtypes (wrapping), bool gives int64;
    ``axis=None`` runs over the flattened array."""
    t = _facade_input("cumsum", a)
    if dtype is not None:
        out = _dtypes.canonicalize(dtype)
    else:
        out = torch.int64 if t.dtype == torch.bool else t.dtype
    if axis is None:
        t, axis = t.reshape(-1), 0
    w = t.to(torch.int64) if _dtypes.is_integer(out) or out == torch.bool else t.to(out)
    return Array(w.cumsum(reduction.axes(axis, t.ndim)[0]).to(out))


def _joined(name, arrays):
    """The arrays' tensors, each in the type ``jnp`` gives their stack."""
    ts = [_facade_input(name, a) for a in arrays]
    if not ts:
        raise ValueError(f"need at least one array to {name}")
    out = _dtypes.result_dtype(*(t.dtype for t in ts))
    return [t.to(out) for t in ts]


def concatenate(arrays, axis=0) -> Array:
    """``jnp.concatenate``: the arrays joined along an existing axis, in
    their promoted type."""
    ts = _joined("concatenate", arrays)
    return Array(torch.cat(ts, dim=axis))


def stack(arrays, axis=0) -> Array:
    """``jnp.stack``: the arrays joined along a new axis, in their promoted
    type."""
    ts = _joined("stack", arrays)
    return Array(torch.stack(ts, dim=axis))


def transpose(a, axes=None) -> Array:
    """``jnp.transpose``: a new array (``Array.transpose`` is the view)."""
    t = _facade_input("transpose", a)
    return Array(t.permute(tuple(reversed(range(t.ndim))) if axes is None else tuple(axes))
                 .contiguous())


def reshape(a, newshape) -> Array:
    _facade_input("reshape", a)
    return asarray(a).reshape(newshape)


def repeat(a, repeats, axis=None) -> Array:
    _facade_input("repeat", a)
    return asarray(a).repeat(repeats, axis)


def expand_dims(a, axis) -> Array:
    t = _facade_input("expand_dims", a)
    axes = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
    ndim = t.ndim + len(axes)
    for d in sorted(int(x) % ndim for x in axes):
        t = t.unsqueeze(d)
    return Array(t.clone())


def squeeze(a, axis=None) -> Array:
    t = _facade_input("squeeze", a)
    if axis is None:
        return Array(t.squeeze().clone())
    dims = reduction.axes(axis, t.ndim)
    for d in dims:
        if t.shape[d] != 1:
            raise ValueError(f"cannot select an axis to squeeze out which has size not "
                             f"equal to one, got shape={tuple(t.shape)} and dimensions={dims}")
    return Array(t.squeeze(dims).clone())


def sort(a, axis=-1) -> Array:
    """``jnp.sort``: ascending along ``axis`` (the flattened array for
    None), NaNs last."""
    t = _facade_input("sort", a)
    if axis is None:
        t, axis = t.reshape(-1), 0
    return Array(torch.sort(_widened(t), dim=axis).values.to(t.dtype))


def _rounding(name, fn):
    """``jnp.floor/ceil/round``: integers and bool unchanged."""

    def wrapped(a) -> Array:
        t = _facade_input(name, a)
        return Array(fn(t) if t.dtype.is_floating_point else t.clone())

    wrapped.__name__ = name
    return wrapped


floor = _rounding("floor", torch.floor)
ceil = _rounding("ceil", torch.ceil)
round = _rounding("round", torch.round)  # noqa: A001 - half to even, as jnp.round


def _inexact(name, fn):
    """A ``jnp`` float function: integer and bool inputs in
    ``dtypes.to_inexact`` of their type."""

    def wrapped(a) -> Array:
        t = _facade_input(name, a)
        return Array(fn(t.to(_dtypes.to_inexact(t.dtype))))

    wrapped.__name__ = name
    return wrapped


log10 = _inexact("log10", torch.log10)
log1p = _inexact("log1p", torch.log1p)
expm1 = _inexact("expm1", torch.expm1)
sinh = _inexact("sinh", torch.sinh)
cosh = _inexact("cosh", torch.cosh)
arcsin = _inexact("arcsin", torch.asin)
arccos = _inexact("arccos", torch.acos)
arctan = _inexact("arctan", torch.atan)


def _predicate(name, fn):
    def wrapped(a) -> Array:
        t = _facade_input(name, a)
        return Array(fn(t))

    wrapped.__name__ = name
    return wrapped


isnan = _predicate("isnan", torch.isnan)
isinf = _predicate("isinf", torch.isinf)
isfinite = _predicate("isfinite", torch.isfinite)


def arctan2(a, b) -> Array:
    """``jnp.arctan2`` in the operands' promoted inexact type."""
    x, y = _facade_input("arctan2", a), _facade_input("arctan2", b)
    out = _dtypes.to_inexact(_dtypes.result_dtype(x.dtype, y.dtype))
    return Array(torch.atan2(x.to(out), y.to(out)))


def fuse(fn, donate=None, iterations=1, carry=0):
    """Fuse a chain of sm ops into one kernel launch (ops/fusion.py).
    ``iterations=L`` iterates the chain L times inside the one launch with
    input ``carry`` as a register-resident loop carry."""
    from .ops import fusion

    return fusion.fuse(fn, donate=donate, iterations=iterations, carry=carry)


def allclose(a, b, rtol=1e-5, atol=1e-8) -> bool:
    return bool(np.allclose(asarray(a).numpy(), asarray(b).numpy(), rtol=rtol, atol=atol))
