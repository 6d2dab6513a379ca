"""Deferred-eager elementwise queue: chains of eager ops flush as ONE kernel.

Counterpart of ``simplemath_tpu/ops/lazy.py``.  Eager elementwise and
transcendental ops return a ``LazyArray`` that records the op as an IR node
(ops/program.py) instead of computing it; chains extend the recorded
expression, and the first materialization (``torch()``/``numpy()``/print/
indexing/``sm.fuse``) lowers it to one program and launches the kernel
once for the whole chain.

Semantics are preserved:

* operand values are snapshotted at defer time: the operand's buffer is
  held by reference and marked frozen, so a later in-place write to it
  copies the buffer first (array.py::_Storage) and cannot change a
  recorded op;
* broadcast shape errors raise at the op call;
* result dtypes follow the eager engine's promotion, Python scalars
  included (dtypes.py's weak types);
* a single-op expression flushes under the op's own dispatch name
  (``elementwise:add``), a chain as ``elementwise:fused``;
* ``sum/mean/max/min`` of a pending expression (full, or one axis of a
  2-D one) do not flush it: the recorded expression becomes the map of ONE
  map-reduce call (``fusion.FusedReduction``), so
  ``sm.sum(sm.square(a - b))`` never stores ``a - b`` or its square.

Disable with ``SM_DEFERRED_EAGER=0`` (config.deferred_eager).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree

from .. import array as _array
from .. import dtypes as _dt
from ..array import Array, asarray
from ..config import config
from . import autodiff, engine, program

# Bounds on recorded chains: past these, the lazy operand is flushed first
# (one launch) and the chain restarts from its value.  _MAX_NODES counts IR
# op nodes, which keeps a chain well inside the kernel's 128 instructions.
_MAX_OPERANDS = 10
_MAX_NODES = 64


class LazyArray(Array):
    """An ``Array`` whose value is a recorded elementwise expression.

    ``_pending`` is ``(node, leaves, operands, name)`` until the first
    materialization, after which the instance behaves exactly like the
    ``Array`` it flushed into.
    """

    __slots__ = ("_pending",)

    def __init__(self, node, leaves, operands, name):
        self._pending = (node, tuple(leaves), tuple(operands), name)
        self._storage = None
        self._spec = None

    # ------------------------------------------------------------- metadata
    @property
    def shape(self):
        p = self._pending
        return p[0].shape if p is not None else super().shape

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def dtype(self):
        p = self._pending
        return p[0].dtype if p is not None else super().dtype

    @property
    def device(self):
        return self._flush()._storage.buf.device

    @property
    def strides(self):
        return self._flush()._spec.strides()

    @property
    def is_view(self):
        return False if self._pending is not None else super().is_view

    # ---------------------------------------------------------------- flush
    def _flush(self) -> "LazyArray":
        p = self._pending
        if p is not None:
            node, leaves, operands, name = p
            arr = engine.run(node, leaves, operands, name)
            self._storage = arr._storage
            self._spec = arr._spec
            self._pending = None
        return self

    def torch(self):
        return self._flush()._spec.read(self._storage.buf)

    def _operand(self):
        self._flush()
        return super()._operand()

    def __getitem__(self, key):
        self._flush()
        return super().__getitem__(key)

    def __setitem__(self, key, value):
        self._flush()
        super().__setitem__(key, value)

    def transpose(self, *axes):
        self._flush()
        return super().transpose(*axes)

    def _reduce(self, kind, axis, keepdims):
        """A full reduction, or one along an int axis of a 2-D expression, of
        the pending expression does not flush it: one map-reduce call over
        the recorded operands.  Anything else flushes first."""
        from . import fusion

        p = self._pending
        if p is not None and (
            not keepdims if axis is None else isinstance(axis, int) and len(p[0].shape) == 2
        ):
            node, leaves, operands, _ = p
            return fusion.reduce_node(kind, node, axis=axis, keepdims=keepdims).materialize(
                leaves, operands
            )
        return super()._reduce(kind, axis, keepdims)


# A pending expression flattens to its value, as an Array does.
_pytree.register_pytree_node(LazyArray, _array._flatten, _array._unflatten,
                             serialized_type_name="simplemath_tpu_torch.LazyArray")


# ---------------------------------------------------------------- recording
def _as_operand(x):
    """(node, leaves, operands) for one input."""
    if isinstance(x, LazyArray) and x._pending is not None:
        node, leaves, ops, _ = x._pending
        if len(ops) < _MAX_OPERANDS and node.n_ops < _MAX_NODES:
            return node, leaves, ops
        x._flush()
    if engine._scalarlike(x):
        return program.const(x), (), ()
    a = asarray(x)
    leaf = program.leaf(a.shape, a.dtype)
    return leaf, (leaf,), (a._snapshot(),)


def _merge(*frags):
    """Concatenate the fragments' leaves and operands, each leaf node once."""
    leaves, ops, seen = [], [], set()
    for _, f_leaves, f_ops in frags:
        for leaf, o in zip(f_leaves, f_ops):
            if id(leaf) not in seen:
                seen.add(id(leaf))
                leaves.append(leaf)
                ops.append(o)
    return leaves, ops


def enabled() -> bool:
    return config.deferred_eager


def _deferrable(x) -> bool:
    if autodiff.transformed(x):
        return False  # computed at once: engine.run sends it to ops/autodiff.py
    return engine._scalarlike(x) or isinstance(x, (Array, np.ndarray, torch.Tensor))


def _by_value(xs, nodes):
    """The reference's queue carries a Python int in int32's range as a
    0-d int32 operand (``simplemath_tpu/ops/lazy.py``,
    ``_narrow_weak_scalars``), so an op on an integer array whose type
    cannot hold that int computes by value, in the promoted type, and the
    result is cast to the type the weak rule gives: ``u32 > -1`` is all
    True and ``maximum(u32, -1)`` is ``u32``, where the eager path wraps
    -1 to 2**32 - 1.  An int beyond int32 stays weak, and so converts to
    the promoted type: ``clip(u32, 1, 2**40)`` is ``maximum(u32, 1)``.  The
    nodes with the int32-range ints made int32 constants, or None where
    that changes no value (every int fits every integer array's type, or
    no wider int meets a type that int32 promotes)."""
    ints = [i for i, x in enumerate(xs)
            if type(x) is int and -(2**31) <= x < 2**31]
    wide = [x for x in xs if type(x) is int and not -(2**31) <= x < 2**31]
    arrays = [n.dtype for n in nodes
              if n.op != "const" and _dt.is_integer(n.dtype) and n.dtype != torch.uint64]
    promoted = [dt for dt in arrays if _dt.result_dtype(dt, torch.int32) != dt]
    if not (any(not _dt.holds(dt, xs[i]) for i in ints for dt in arrays)
            or (ints and wide and promoted)):
        return None
    return [program.const(xs[i], torch.int32) if i in ints else n
            for i, n in enumerate(nodes)]


def _record(name, xs, build):
    """Record ``build(*nodes)`` over the inputs ``xs``; None (the caller
    computes eagerly) when the queue is off or an input cannot be
    recorded."""
    if not (enabled() and all(_deferrable(x) for x in xs)):
        return None
    frags = [_as_operand(x) for x in xs]
    nodes = [f[0] for f in frags]
    try:
        node = build(*nodes)
        by_value = _by_value(xs, nodes)
        if by_value is not None:
            node = program.cast(build(*by_value), node.dtype)
    except program.NotLowerable:
        return None
    single = all(f[0].op in ("leaf", "const") for f in frags)
    leaves, ops = _merge(*frags)
    return LazyArray(node, leaves, ops, name if single else "fused")


def defer_binary(name: str, a, b):
    """Record a registry binary op; returns a LazyArray or None."""
    return _record(name, (a, b), lambda x, y: program.apply(name, x, y))


def defer_ternary(name: str, a, b, c):
    """Record a registry ternary op (where/clip)."""
    return _record(name, (a, b, c), lambda x, y, z: program.apply(name, x, y, z))


def defer_unary(name: str, a):
    """Record a registry unary op or a transcendental (exp/log/...)."""
    if engine._scalarlike(a):
        return None
    return _record(name, (a,), lambda x: program.apply(name, x))


def defer_pow(a, b):
    """Record ``sm.pow`` with the eager engine's specialization ladder."""
    if engine._scalarlike(a) or not (_deferrable(a) and _deferrable(b)):
        return None
    a = asarray(a)
    if engine._scalarlike(b):
        return _record(engine.pow_label(a.dtype, b), (a,),
                       lambda x: engine.pow_expr(x, b))
    return _record(engine.pow_label(a.dtype, b), (a, b), engine.pow_expr)
