"""Dispatch engine: broadcast check, expression building and kernel launch.

Counterpart of ``simplemath_tpu/ops/engine.py``: operator -> ``binary`` ->
``broadcast_shapes`` (NumPy error semantics) -> the deferred-eager queue or
an immediate launch.  An op is built as an IR node over its operands
(ops/program.py) and runs through the elementwise kernel when the kernel
takes its signature (float32, bfloat16, int32, uint32 and bool:
``dtypes.KERNEL_DTYPES``); float64, float16, the 8-, 16- and 64-bit
integers and complex run as plain torch, recorded as
``torch_path:<name>``.  There is no size gate: on a CUDA tensor every
signature the kernel takes launches it.  An operand under a ``torch.func``
transform takes the same kernel through ``ops/autodiff.py`` (``run``).

View operands pass to the kernel as (base tensor, offset, signed strides)
and are read in place; this replaces the JAX package's
``_prepare_operands`` + ``viewkernel.plan_view``.  ``dot`` of 1-D operands
runs the map-reduce kernel (ops/reduction.py).  ``dot``/``matmul`` of
rank >= 2 operands are a plain product that the JAX package computes
outside any Pallas kernel: float and complex operands go to
``torch.matmul`` (complex64 natively: the three-product split of the JAX
package's ``complexmm.py`` exists only because a TPU has no complex type),
integer operands, for which torch has no matmul on CUDA, to the matmul
kernel (ops/matmul.py).
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from .. import dtypes as _dt
from ..array import Array, asarray
from ..broadcast import broadcast_shapes
from ..config import config
from . import autodiff, dispatch, elementwise, program, reduction, registry


def _scalarlike(x) -> bool:
    return isinstance(x, (bool, int, float, complex, np.number))


def _shape(x):
    if _scalarlike(x):
        return ()
    s = getattr(x, "shape", None)
    return tuple(s) if s is not None else np.shape(x)


def run(node, leaves, operands, name, donate=None, iterations=1, carry=0) -> Array:
    """Run the expression ``node`` over ``operands`` (one per leaf node):
    the elementwise kernel's one route.  The kernel when it takes the
    signature, plain torch otherwise.  Operands under a ``torch.func``
    transform go through ``autodiff.Elementwise`` (the same kernel, with
    derivative and batching rules; an iterated program one application a
    pass) where the kernel takes the program."""
    prog = program.lower(node, leaves)
    shape = node.shape
    if any(map(autodiff.transformed, operands)):
        if autodiff.takes(prog, shape):
            tensors = [elementwise.read(o) for o in operands]
            for _ in range(iterations - 1):
                tensors[carry] = autodiff.run(prog, shape, name, tensors)
            return Array(autodiff.run(prog, shape, name, tensors))
    elif prog.kernel_codes is not None and elementwise.supported(
        shape, prog.leaf_dtypes, prog.dtype
    ):
        return Array(elementwise.elementwise(
            prog, shape, prog.dtype, *operands, name=name, donate=donate,
            iterations=iterations, carry=carry,
        ))
    dispatch.record("torch_path", name)
    device = operands[0].device if operands else torch.device(config.device)
    return Array(program.run_plain(
        prog, [elementwise.read(o) for o in operands], shape, iterations,
        carry, device,
    ))


def _eager(name, xs, build) -> Array:
    """Leaves for the array operands, constants for Python scalars, then
    ``build(*nodes)`` run at once."""
    leaves, arrays, args = [], [], []
    for x in xs:
        if _scalarlike(x):
            args.append(program.const(x))
            continue
        a = asarray(x)
        leaf = program.leaf(a.shape, a.dtype)
        leaves.append(leaf)
        arrays.append(a)
        args.append(leaf)
    try:
        node = build(*args)
    except program.NotLowerable:
        # A user op whose function does not trace onto IR nodes.
        dispatch.record("torch_path", name)
        tensors = [x if _scalarlike(x) else asarray(x).torch() for x in xs]
        return Array(torch.as_tensor(registry.get_op(name).fn(*tensors)))
    return run(node, leaves, [a._operand() for a in arrays], name)


def binary(name: str, a: Any, b: Any) -> Array:
    from . import fusion, lazy

    if fusion.is_fused(a) or fusion.is_fused(b):
        return fusion.binary_node(name, a, b)
    dispatch.record("engine", name)
    if registry.get_op(name).pallas_ok:
        out = lazy.defer_binary(name, a, b)
        if out is not None:
            return out
    return binary_eager(name, a, b)


def binary_eager(name: str, a: Any, b: Any) -> Array:
    """The non-deferring compute path (also the lazy queue's single-op
    flush; ``binary`` records the engine dispatch before deferring)."""
    broadcast_shapes(_shape(a), _shape(b))  # raises ValueError on mismatch
    return _eager(name, (a, b), lambda x, y: program.apply(name, x, y))


def unary(name: str, a: Any) -> Array:
    from . import fusion, lazy

    if fusion.is_fused(a):
        return fusion.unary_node(name, a)
    dispatch.record("engine", name)
    if registry.get_op(name).pallas_ok:
        out = lazy.defer_unary(name, a)
        if out is not None:
            return out
    return unary_eager(name, a)


def unary_eager(name: str, a: Any) -> Array:
    """Non-deferring compute path for registry unaries and the
    transcendentals (also the lazy single-op flush)."""
    return _eager(name, (a,), lambda x: program.apply(name, x))


def ternary(name: str, a: Any, b: Any, c: Any) -> Array:
    from . import fusion, lazy

    if fusion.is_fused(a) or fusion.is_fused(b) or fusion.is_fused(c):
        return fusion.ternary_node(name, a, b, c)
    dispatch.record("engine", name)
    if registry.get_op(name).pallas_ok:
        out = lazy.defer_ternary(name, a, b, c)
        if out is not None:
            return out
    return ternary_eager(name, a, b, c)


def ternary_eager(name: str, a: Any, b: Any, c: Any) -> Array:
    """Non-deferring compute path (also the lazy single-op flush)."""
    broadcast_shapes(broadcast_shapes(_shape(a), _shape(b)).result_shape, _shape(c))
    return _eager(name, (a, b, c), lambda x, y, z: program.apply(name, x, y, z))


def apply_op(name: str, *operands) -> Array:
    """Public entry for registered (incl. user) ops."""
    op = registry.get_op(name)
    if op.arity == 1:
        return unary(name, *operands)
    if op.arity == 3:
        return ternary(name, *operands)
    return binary(name, *operands)


# ----------------------------------------------------------------- pow
def _static_int_pow(x, e: int):
    """x**e for a STATIC integer exponent by repeated squaring: exact, a
    handful of multiplies, no transcendentals.  ``x`` is an IR node."""
    if e == 0:
        return program.const(1, x.dtype, x.shape)
    inv = e < 0
    e = -e if inv else e
    result = None
    base = x
    while e:
        if e & 1:
            result = base if result is None else result * base
        base = base * base
        e >>= 1
    return 1.0 / result if inv else result


def _static_exponent(a_dtype, b):
    """The exponent when ``b`` takes the repeated-squaring rung, else None."""
    if (
        isinstance(b, (int, float, np.integer, np.floating))
        and not isinstance(b, (bool, np.bool_))
        and float(b) == int(b)
        and abs(int(b)) <= 64
        and a_dtype.is_floating_point
    ):
        return int(b)
    return None


def pow_label(a_dtype, b) -> str:
    """Dispatch name of ``pow``'s rung: "powi", "ipow" or "pow"."""
    if _static_exponent(a_dtype, b) is not None:
        return "powi"
    b_dtype = _dt.weak_to_dtype(_dt.key(b)) if _scalarlike(b) else b.dtype
    if _dt.is_integer(a_dtype) and _dt.is_integer(b_dtype):
        return "ipow"
    return "pow"


def pow_expr(a, b):
    """The node of ``a ** b`` with the JAX package's ladder: a static
    integer exponent with |e| <= 64 on a float base -> repeated squaring;
    int ** int -> square-and-multiply ``ipow`` (wrapping, 0 for negative
    exponents except bases ±1); otherwise the crafted float pow (float64:
    torch.pow).  ``a`` is a node; ``b`` a node or a Python scalar."""
    e = _static_exponent(a.dtype, b)
    if e is not None:
        return _static_int_pow(a, e)
    if not isinstance(b, program.Node):
        b = program.const(b)
    out = _dt.weak_to_dtype(_dt.join_keys(a.key, b.key))
    shape = broadcast_shapes(a.shape, b.shape).result_shape
    if _dt.is_integer(a.dtype) and _dt.is_integer(b.dtype):
        return program.Node("ipow", (program.cast(a, out), program.cast(b, out)), out, shape)
    if not out.is_floating_point:
        out = torch.float32
    if out == torch.float64:
        return program.Node("pow", (program.cast(a, out), program.cast(b, out)), out, shape)
    f32 = torch.float32
    node = program.Node("pow", (program.cast(a, f32), program.cast(b, f32)), f32, shape)
    return program.cast(node, out)


def pow(a: Any, b: Any) -> Array:
    """Elementwise power (see ``pow_expr`` for the ladder)."""
    from . import fusion, lazy

    if fusion.is_fused(a) or fusion.is_fused(b):
        return fusion.pow_node(a, b)
    out = lazy.defer_pow(a, b)
    if out is not None:
        return out
    return pow_eager(a, b)


def pow_eager(a: Any, b: Any) -> Array:
    """Non-deferring compute path (also the lazy single-op flush)."""
    broadcast_shapes(_shape(a), _shape(b))
    a = asarray(a)
    if _scalarlike(b):
        label = pow_label(a.dtype, b)
        return _eager(label, (a,), lambda x: pow_expr(x, b))
    b = asarray(b)
    return _eager(pow_label(a.dtype, b), (a, b), pow_expr)


# ----------------------------------------------------------------- dot
_CONTRACTION = (
    "dot_general requires contracting dimensions to have the same shape, "
    "got ({},) and ({},)."
)


def product_dtype(a_dtype, b_dtype) -> torch.dtype:
    """The type ``dot``/``matmul`` give for rank >= 2 operands: ``jnp``'s
    result type, with bfloat16 and float16 products widened to the float32
    they are accumulated in."""
    out = _dt.result_dtype(a_dtype, b_dtype)
    return torch.float32 if out in (torch.bfloat16, torch.float16) else out


def _float_product(fn, a, b, out, name):
    """A float or complex product as plain torch, computed in ``out`` (so a
    bfloat16 or float16 product accumulates in float32), float32 in full
    float32 whatever the caller's TF32 setting."""
    from . import matmul as _mm

    dispatch.record("torch_path", name)
    with _mm.exact_float32():
        return fn(a.torch().to(out), b.torch().to(out))


def _as_kernel_int(t: torch.Tensor) -> torch.Tensor:
    """An integer or bool tensor of at most 32 bits in a type the matmul
    kernel reads (int8, uint8, int32), the value mod 2**32 kept."""
    if t.dtype in (torch.int8, torch.uint8, torch.int32):
        return t
    if t.dtype == torch.uint32:
        return t.view(torch.int32)
    return t.to(torch.int32)


def _as_kernel_int64(x):
    """An integer or bool operand in a type the 64-bit accumulator reads
    (int8, uint8, int32, int64, uint64 are read in place; the rest are
    widened to int64 first), the value kept."""
    if x.dtype in (torch.int8, torch.uint8, torch.int32, torch.int64, torch.uint64):
        return x
    return elementwise.read(x).to(torch.int64)


def _int_product(a2, b2, shape, out, name) -> torch.Tensor:
    """The integer product of rank-2 or rank-3 ``a2 @ b2`` (tensors or view
    operands), reshaped to ``shape``, as ``out``.  Types of at most 32 bits
    run the matmul kernel with its exact int32 accumulator: the value mod
    2**32 is the product mod 2**32 of any such type.  A 64-bit result
    (int64 or uint64) runs it with its int64 accumulator, which wraps mod
    2**64 as the JAX package's ``jnp.dot`` in int64 does; torch has no
    integer matmul on CUDA."""
    from . import matmul as _mm

    if math.prod(shape) == 0 or a2.shape[-1] == 0:
        dispatch.record("torch_path", name)
        return torch.zeros(shape, dtype=out, device=a2.device)
    if out in (torch.int64, torch.uint64):
        a2, b2 = _as_kernel_int64(a2), _as_kernel_int64(b2)
        if a2.dtype not in _mm.WIDE_OPERANDS and b2.dtype not in _mm.WIDE_OPERANDS:
            a2 = elementwise.read(a2).to(torch.int64)  # the accumulator follows the operands
        acc = _mm.matmul(a2, b2, torch.int64).reshape(shape)
        return acc.view(torch.uint64) if out == torch.uint64 else acc
    if not (a2.dtype in _mm.INT_OPERANDS and b2.dtype in _mm.INT_OPERANDS):
        a2 = _as_kernel_int(elementwise.read(a2))
        b2 = _as_kernel_int(elementwise.read(b2))
    acc = _mm.matmul(a2, b2, torch.int32).reshape(shape)
    if out == torch.bool:
        return acc != 0
    if out == torch.uint32:
        return acc.view(torch.uint32)
    return acc if out == torch.int32 else acc.to(out)


def _is_int(dtype) -> bool:
    return dtype == torch.bool or _dt.is_integer(dtype)


def dot(a: Any, b: Any) -> Array:
    """Dot product with ``numpy.dot`` semantics (the reference's
    ``operator%``) for every rank: 1-D . 1-D is the inner product, 2-D . 2-D
    the matrix product, N-D . 1-D sums over the last axes, N-D . M-D
    contracts ``a``'s last axis with ``b``'s second-to-last.  A 0-d operand
    multiplies.  Views are read through their strides.

    1-D operands of one length: float32 and int32 results in the map-reduce
    kernel's fused multiply+reduce (int32 exact mod 2**32), as the JAX
    package's ``pallas_dot1d``; the rest as plain torch.  Rank >= 2: float
    and complex operands run ``torch.matmul``'s contraction (the JAX package
    leaves these to XLA), bfloat16 and float16 accumulating in and giving
    float32; integer operands run the matmul kernel (ops/matmul.py)."""
    a, b = asarray(a), asarray(b)
    if a.ndim == 0 or b.ndim == 0:
        wide = product_dtype(a.dtype, b.dtype)
        if wide != _dt.result_dtype(a.dtype, b.dtype):  # bfloat16, float16: in float32
            a, b = a.astype(wide), b.astype(wide)
        return binary("multiply", a, b)
    k_b = b.shape[0] if b.ndim == 1 else b.shape[-2]
    if a.shape[-1] != k_b:
        raise TypeError(_CONTRACTION.format(a.shape[-1], k_b))
    if a.ndim == 1 and b.ndim == 1:
        out = _dt.result_dtype(a.dtype, b.dtype)
        if (
            out in (torch.float32, torch.bfloat16, torch.int32)
            and a.dtype in _dt.KERNEL_DTYPES
            and b.dtype in _dt.KERNEL_DTYPES
            and a.size > 0
        ):
            return Array(reduction.dot1d(a._operand(), b._operand()).to(out))
        return Array(reduction.torch_dot(a.torch(), b.torch(), out))
    out = product_dtype(a.dtype, b.dtype)
    b_axis = 0 if b.ndim == 1 else b.ndim - 2
    if not _is_int(out):
        return Array(_float_product(
            lambda x, y: torch.tensordot(x, y, dims=([x.ndim - 1], [b_axis])), a, b, out, "dot"))
    shape = a.shape[:-1] + b.shape[:b_axis] + b.shape[b_axis + 1:]
    if a.ndim == 2 and b.ndim == 2:
        return Array(_int_product(a._operand(), b._operand(), shape, out, "dot"))
    k = a.shape[-1]
    return Array(_int_product(a.torch().reshape(-1, k),
                              b.torch().movedim(b_axis, 0).reshape(k, -1), shape, out, "dot"))


def matmul(a: Any, b: Any) -> Array:
    """``numpy.matmul`` semantics: the matrix product over the last two
    dims, leading dims broadcast, a 1-D operand promoted to a matrix and its
    dim removed from the result.  Routes as ``dot`` does: float and complex
    operands through ``torch.matmul``, integers through the matmul kernel."""
    a, b = asarray(a), asarray(b)
    for i, x in enumerate((a, b)):
        if x.ndim == 0:
            raise ValueError(
                f"matmul input operand {i} must have ndim at least 1, but it has ndim 0"
            )
    k_b = b.shape[0] if b.ndim == 1 else b.shape[-2]
    if a.shape[-1] != k_b:
        raise TypeError(_CONTRACTION.format(a.shape[-1], k_b))
    try:
        batch = tuple(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]))
    except RuntimeError:
        raise ValueError(
            f"Incompatible shapes for matmul arguments: {a.shape} and {b.shape}"
        ) from None
    if a.ndim == 1 and b.ndim == 1:
        out = product_dtype(a.dtype, b.dtype)
        if out != _dt.result_dtype(a.dtype, b.dtype):  # bfloat16, float16: in float32
            return Array(reduction.torch_dot(a.torch(), b.torch(), out))
        return dot(a, b)
    out = product_dtype(a.dtype, b.dtype)
    if not _is_int(out):
        return Array(_float_product(torch.matmul, a, b, out, "matmul"))
    shape = batch + a.shape[-2:-1] + (b.shape[-1:] if b.ndim > 1 else ())
    if a.ndim == b.ndim and a.ndim in (2, 3) and a.shape[:-2] == b.shape[:-2]:
        return Array(_int_product(a._operand(), b._operand(), shape, out, "matmul"))
    at = a.torch() if a.ndim > 1 else a.torch().reshape(1, -1)
    bt = b.torch() if b.ndim > 1 else b.torch().reshape(-1, 1)
    a3 = at.expand(batch + at.shape[-2:]).reshape((-1,) + at.shape[-2:])
    b3 = bt.expand(batch + bt.shape[-2:]).reshape((-1,) + bt.shape[-2:])
    return Array(_int_product(a3, b3, shape, out, "matmul"))
