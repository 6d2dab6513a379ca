"""Fused elementwise expressions: chain sm ops into ONE kernel launch.

Counterpart of ``simplemath_tpu/ops/fusion.py``.  ``sm.fuse`` traces a
user function built from sm ops over symbolic ``FusedExpr`` nodes.  In the
JAX package a node composes tile-function closures; here it is an IR node
(ops/program.py), and the traced expression is lowered to an opcode
program that ONE launch of the elementwise kernel executes: one read of
each operand, one write of the output, broadcast operands never
materialized::

    fused = sm.fuse(lambda a, e: sm.exp(sm.pow(a, e)))
    y = fused(a, e_row)        # ONE kernel launch; e_row (1, n) broadcasts

The expression is traced once per input signature (shapes + dtypes) and
cached with its lowered program.

A reduction may be the ROOT of the fused function (``FusedReduction``):
``sm.sum/mean/max/min`` of an expression, full or along one axis, runs as
one map-reduce call (ops/reduction.py) that never stores the mapped
expression::

    dist = sm.fuse(lambda a, b: sm.sum(sm.square(a - b)))

A matmul of two direct arguments may be the root's source
(``matmul_node``): ``x @ w`` runs in the matmul kernel (ops/matmul.py) and
the elementwise ops on it become the kernel's epilogue, applied to the
float32 accumulator at the store, so the (M, N) product never goes to
device memory::

    layer = sm.fuse(lambda x, w, b: sm.maximum(x @ w + b, 0.0))
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import numpy as np
import torch

from .. import dtypes as _dt
from ..array import Array, asarray
from ..config import config
from . import dispatch, elementwise, engine, matmul, program, reduction

FusedExpr = program.Node


class _Trace:
    """One ``sm.fuse`` trace: the argument leaves and, once the function has
    multiplied two of them, the matmul (``a``, ``b``: argument indices;
    ``product``: the leaf that stands for ``a @ b``).  ``product_dtype``
    overrides the product leaf's dtype (see ``_trace``)."""

    __slots__ = ("leaves", "a", "b", "product", "product_dtype")

    def __init__(self, leaves, product_dtype=None):
        self.leaves = leaves
        self.a = self.b = self.product = None
        self.product_dtype = product_dtype


# The trace that ``fuse`` is running, innermost last.
_TRACES: list = []


class FusedReduction:
    """Root node: a reduction over a fused elementwise expression.

    ``sm.sum/mean/max/min`` applied to a ``FusedExpr`` produce one;
    ``sm.fuse`` materializes it as ONE map-reduce call: full reductions
    through ``reduction.map_reduce``, single-axis reductions of 2-D
    expressions through ``reduction.map_reduce_axis``.  Every operand is
    read once, broadcast ones in place, and the mapped expression is never
    stored.  Float32, bfloat16 and float16 expressions with kernel opcodes
    run the kernel (float32 accumulation, the result cast back), as the JAX
    package sends every float type but float64 to its Pallas kernels; the
    rest run as plain torch with ``jnp``'s result dtypes.  A reduction
    result cannot be composed further inside the same fused function."""

    __slots__ = ("kind", "expr", "axis", "keepdims")

    def __init__(self, kind: str, expr: FusedExpr, axis=None, keepdims=False):
        self.kind = kind
        self.expr = expr
        self.axis = axis
        self.keepdims = keepdims

    def _no_compose(self, *_a, **_k):
        _reject_reduction(self)

    __add__ = __radd__ = __sub__ = __rsub__ = _no_compose
    __mul__ = __rmul__ = __truediv__ = __rtruediv__ = _no_compose
    __floordiv__ = __mod__ = __pow__ = __neg__ = __abs__ = _no_compose

    def materialize(self, leaves, operands) -> Array:
        expr = self.expr
        kind = "sum" if self.kind == "mean" else self.kind
        shape, dtype = expr.shape, expr.dtype
        prog = program.lower(expr, leaves)
        kernel = (dtype in reduction.FLOAT_INPUTS and math.prod(shape) > 0 and len(shape) >= 1
                  and prog.kernel_codes is not None)
        ax = self.axis
        if kernel and (ax is None or len(shape) == 2):
            if ax is None:
                total = reduction.map_reduce(prog, kind, shape, *operands)
            else:
                total = reduction.map_reduce_axis(prog, kind, ax, shape, *operands)
        else:
            vals = reduction.values(prog, shape, operands,
                                    elementwise.operand_device(prog, shape, operands))
            if dtype in (torch.bfloat16, torch.float16):
                vals = vals.float()  # the JAX package reduces these in f32
            total = reduction.torch_reduce(vals, kind, ax)
        if self.kind == "mean":
            total = reduction.divide(total, math.prod(shape) if ax is None else shape[ax])
        if dtype.is_floating_point:
            total = total.to(dtype)
        if self.keepdims:
            total = total.unsqueeze(ax)
        return Array(total)


def reduce_node(kind: str, a, axis=None, keepdims=False) -> FusedReduction:
    """``api._reduce_free``'s hook: a (full or single-axis) reduction rooting
    a fused expression."""
    if isinstance(a, FusedReduction):
        raise TypeError("a reduction result cannot be reduced again inside sm.fuse")
    if not isinstance(a, FusedExpr):
        raise TypeError(f"sm.{kind} fused-reduction requires a fused expression")
    if axis is not None:
        if isinstance(axis, (tuple, list)):
            raise TypeError(
                f"sm.{kind} inside sm.fuse supports a single int axis, got {axis!r}"
            )
        nd = len(a.shape)
        ax = int(axis) + nd if int(axis) < 0 else int(axis)
        if not 0 <= ax < nd:
            raise ValueError(
                f"axis {axis} out of bounds for fused expression of rank {nd}"
            )
        return FusedReduction(kind, a, axis=ax, keepdims=keepdims)
    if keepdims:
        raise TypeError(
            f"sm.{kind}(keepdims=True) without an axis is not supported inside sm.fuse"
        )
    return FusedReduction(kind, a)


def _reject_reduction(*xs):
    if any(isinstance(x, FusedReduction) for x in xs):
        raise TypeError(
            "reduction results cannot be composed further inside sm.fuse; "
            "make the reduction the LAST op of the fused function"
        )


def is_fused(x) -> bool:
    return isinstance(x, (FusedExpr, FusedReduction))


def _lift(x) -> FusedExpr:
    """Coerce a scalar to a constant node; reject array constants."""
    if isinstance(x, FusedExpr):
        return x
    if engine._scalarlike(x):
        return program.const(x)
    if isinstance(x, (np.ndarray, torch.Tensor, Array)) and np.ndim(x) == 0:
        a = asarray(x)
        return program.const(a.item(), a.dtype)
    raise TypeError(
        "fused expressions only accept Python scalars as constants; pass "
        f"array values (got {type(x).__name__}) as arguments to the fused "
        "function so the kernel reads them as operands"
    )


def binary_node(name: str, a, b) -> FusedExpr:
    _reject_reduction(a, b)
    if name == "pow":
        return pow_node(a, b)
    return program.apply(name, _lift(a), _lift(b))


def unary_node(name: str, a) -> FusedExpr:
    _reject_reduction(a)
    if not isinstance(a, FusedExpr):
        raise TypeError(f"unary fused op {name!r} requires a FusedExpr")
    return program.apply(name, a)


def pow_node(a, b) -> FusedExpr:
    """Fused ``sm.pow``: the same ladder as the public ``engine.pow``."""
    _reject_reduction(a, b)
    return engine.pow_expr(_lift(a), b if engine._scalarlike(b) else _lift(b))


def ternary_node(name: str, a, b, c) -> FusedExpr:
    _reject_reduction(a, b, c)
    return program.apply(name, _lift(a), _lift(b), _lift(c))


def matmul_node(a, b) -> FusedExpr:
    """``x @ w`` inside a fused function: the matmul kernel's product, whose
    elementwise consumers become the kernel's epilogue.

    Both operands must be direct arguments of the fused function (the
    kernel reads them from memory), there is at most one matmul per fused
    function, and the operands cannot also be used elementwise."""
    _reject_reduction(a, b)
    trace = _TRACES[-1] if _TRACES else None
    index = {id(n): i for i, n in enumerate(trace.leaves)} if trace else {}
    if id(a) not in index or id(b) not in index:
        raise TypeError(
            "matmul inside sm.fuse requires direct arguments of the fused "
            "function (not composed expressions)"
        )
    if trace.product is not None:
        raise TypeError("sm.fuse supports at most one matmul per fused function")
    try:
        matmul.product_shape(a.shape, b.shape)
    except ValueError:
        raise TypeError(
            f"fused matmul requires 2-D (M,K) @ (K,N) or batched "
            f"(B,M,K) @ (B,K,N) arguments; got {a.shape} @ {b.shape}"
        ) from None
    dtype = trace.product_dtype or _dt.result_dtype(a.dtype, b.dtype)
    trace.a, trace.b = index[id(a)], index[id(b)]
    trace.product = program.leaf(a.shape[:-1] + b.shape[-1:], dtype)
    return trace.product


def _reads(root, leaves) -> set:
    """Which of ``leaves`` (by position) the expression ``root`` reads."""
    index = {id(n): i for i, n in enumerate(leaves)}
    found, seen, stack = set(), set(), [root]
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        if id(n) in index:
            found.add(index[id(n)])
        stack.extend(n.args)
    return found


def _trace(fn, arrs, product_dtype=None):
    """``fn`` over fresh leaves for ``arrs``: (expression, trace)."""
    trace = _Trace([program.leaf(a.shape, a.dtype) for a in arrs], product_dtype)
    _TRACES.append(trace)
    try:
        expr = fn(*trace.leaves)
    finally:
        _TRACES.pop()
    return expr, trace


@dataclasses.dataclass(frozen=True)
class _MatmulRoot:
    """A traced function whose result is an epilogue over ``x @ w``.

    ``a``, ``b`` and ``extras`` are argument positions.  ``epilogue`` reads
    the product as it is computed (float32 for bfloat16 and float16
    operands, as ``sm.matmul`` gives it) and is the kernel's form
    (``program.lower_epilogue``); ``dtype`` is the result's type, traced
    with the product in its operands' own type as the JAX package does."""

    a: int
    b: int
    extras: tuple
    epilogue: program.Program
    shape: tuple
    dtype: torch.dtype

    def materialize(self, arrs) -> Array:
        a, b = arrs[self.a], arrs[self.b]
        extras = [arrs[i] for i in self.extras]
        prog = self.epilogue
        dims = matmul.product_shape(a.shape, b.shape)
        kernel = (
            matmul.accumulator(a.dtype, b.dtype) == prog.leaf_dtypes[0]
            and math.prod(dims) > 0
            and self.shape == a.shape[:-1] + b.shape[-1:]
            and all(e.dtype in matmul.EXTRA_DTYPES for e in extras)
            and prog.kernel_codes is not None
            and prog.dtypes <= matmul.EPILOGUE_DTYPES
            and self.dtype in matmul.stored_dtypes(prog.dtype)
        )
        if kernel:
            return Array(matmul.matmul(
                a._operand(), b._operand(), self.dtype, epilogue=prog,
                extras=[e._operand() for e in extras],
            ))
        # Signatures the kernel does not take (float64, float16, complex
        # and narrow-integer products, an extra of another type or of more
        # dims than the product): the product and the epilogue as torch.
        dispatch.record("torch_path", "matmul_epilogue")
        prod = engine.matmul(a, b).torch()
        wide = [e.torch() for e in extras]
        wide = [t.float() if want == torch.float32 and t.dtype == torch.bfloat16 else t
                for t, want in zip(wide, prog.leaf_dtypes[1:])]
        out = program.run_plain(prog, [prod, *wide], self.shape, device=prod.device)
        return Array(out.to(self.dtype))


def _matmul_root(fn, arrs, expr, trace) -> _MatmulRoot:
    read = _reads(expr, trace.leaves)
    if trace.a in read or trace.b in read:
        raise TypeError(
            "the matmul operands cannot also be used elementwise in the fused "
            "epilogue (the kernel reads them as matrix tiles); pass a separate "
            "argument"
        )
    a, b = arrs[trace.a], arrs[trace.b]
    computed = engine.product_dtype(a.dtype, b.dtype)
    if computed != trace.product.dtype:
        # bfloat16 and float16 products are computed, and seen by the
        # epilogue, in float32; only the result's type comes from the
        # first trace.
        run_expr, run_trace = _trace(fn, arrs, product_dtype=computed)
    else:
        run_expr, run_trace = expr, trace
    extras = tuple(sorted(_reads(run_expr, run_trace.leaves)))
    prog = program.lower_epilogue(run_expr, run_trace.product,
                                  [run_trace.leaves[i] for i in extras])
    return _MatmulRoot(trace.a, trace.b, extras, prog, expr.shape, expr.dtype)


def fuse(
    fn: Callable,
    donate: int | None = None,
    iterations: int = 1,
    carry: int = 0,
) -> Callable:
    """Wrap ``fn`` (built from sm ops) so calls execute as ONE kernel launch.

    The returned function accepts Arrays, torch tensors and numpy arrays;
    view Arrays are read in place.  The expression is traced once per input
    signature and cached.

    ``donate=i`` declares input ``i`` (same shape and dtype as the output)
    dead after the call.  The port still returns a new array and never
    writes into the caller's, as the JAX package's eager ``donate`` leaves
    the caller's array unchanged.

    ``iterations=L`` runs the WHOLE chain L times inside the one launch,
    feeding the result back as input ``carry`` each pass; the carry stays
    in registers for all L iterations.  The expression's output must match
    input ``carry``'s shape and dtype.
    """
    if iterations < 1:
        raise ValueError(f"iterations must be >= 1, got {iterations}")
    cache = {}

    @functools.wraps(fn)
    def fused(*arrays):
        arrs = [asarray(a) for a in arrays]
        key = tuple((a.shape, a.dtype) for a in arrs) + (config.transcendental_impl,)
        hit = cache.get(key)
        if hit is None:
            expr, trace = _trace(fn, arrs)
            leaves = trace.leaves
            if not is_fused(expr):
                raise TypeError(
                    "the function passed to sm.fuse must return a fused "
                    f"expression built from sm ops; got {type(expr).__name__}"
                )
            if isinstance(expr, FusedReduction):
                if iterations != 1:
                    raise ValueError(
                        "sm.fuse(iterations=...) does not compose with a "
                        "reduction root (the result is a scalar)"
                    )
                if trace.product is not None and _reads(expr.expr, [trace.product]):
                    raise TypeError(
                        "a reduction over a fused matmul epilogue is not "
                        "supported; materialize the epilogue first"
                    )
            elif trace.product is not None and _reads(expr, [trace.product]):
                if iterations != 1:
                    raise ValueError(
                        "sm.fuse(iterations=...) does not compose with a "
                        "matmul root"
                    )
                expr = _matmul_root(fn, arrs, expr, trace)
            elif iterations != 1 and (
                expr.shape != arrs[carry].shape or expr.dtype != arrs[carry].dtype
            ):
                raise ValueError(
                    f"sm.fuse(iterations={iterations}): the expression "
                    f"result ({expr.shape}, {expr.dtype}) must match carry "
                    f"input {carry} ({arrs[carry].shape}, {arrs[carry].dtype}) "
                    "so it can feed back"
                )
            hit = cache[key] = (expr, leaves)
        expr, leaves = hit
        if isinstance(expr, FusedReduction):
            return expr.materialize(leaves, [a._operand() for a in arrs])
        if isinstance(expr, _MatmulRoot):
            return expr.materialize(arrs)
        return engine.run(
            expr, leaves, [a._operand() for a in arrs], "fused",
            donate=donate, iterations=iterations, carry=carry,
        )

    return fused
