"""Expression IR, its lowering to a flat opcode program, and the program's
plain interpreter.

Counterpart of the JAX package's tile-function composition
(``simplemath_tpu/ops/elementwise.py::_TILE_FNS`` and the closures
``ops/fusion.py`` builds).  A CUDA kernel cannot call Python tile
functions, so an elementwise expression is data here:

* ``Node`` — the IR: a leaf (an operand of the kernel), a scalar constant,
  or an op applied to nodes.  Nodes overload the arithmetic and comparison
  operators, so ``sm.fuse`` and user ops trace onto them.  Every node knows
  its dtype (with JAX's weak-scalar promotion, dtypes.py) and its broadcast
  shape.
* ``Program`` — the flat SSA form the kernel executes: registers
  ``[0, n_leaves)`` hold the operands, the next ``n_consts`` the constants,
  and instruction ``k`` writes register ``n_leaves + n_consts + k``.
* ``run_plain`` — the plain PyTorch version of the kernel: the same program
  run with torch ops on whole tensors.  The CPU tests cover the lowering
  and every opcode's semantics through it; the card adds only the CUDA
  transcription of the opcode table (csrc/tiles.cuh).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from .. import dtypes as _dt
from ..broadcast import broadcast_shapes
from . import registry

# Kernel opcodes, in the order of ``enum SmOpcode`` in csrc/tiles.cuh (a
# test holds the two lists equal).
OPCODES = (
    "ADD_F", "SUB_F", "MUL_F", "DIV_F", "MAX_F", "MIN_F",
    "NEG_F", "ABS_F", "SQRT_F", "SQUARE_F", "SIGN_F",
    "EXP_F", "LOG_F", "EXP2_F", "LOG2_F", "TANH_F", "SIN_F", "COS_F", "TAN_F",
    "POW_F",
    "ADD_I", "SUB_I", "MUL_I", "MAX_I", "MIN_I", "NEG_I", "ABS_I", "SQUARE_I",
    "SIGN_I", "IPOW_I",
    "EQ_F", "NE_F", "LT_F", "LE_F", "GT_F", "GE_F",
    "EQ_I", "NE_I", "LT_I", "LE_I", "GT_I", "GE_I",
    "SELECT",
    "I2F", "F2I", "B2F", "B2I", "F2B", "I2B",
    "LT_U", "LE_U", "GT_U", "GE_U", "MAX_U", "MIN_U", "SIGN_U",
    "U2F", "F2U", "BITS",
    "FDIV_I", "MOD_I", "FDIV_U", "MOD_U",
)
OPCODE_INDEX = {name: i for i, name in enumerate(OPCODES)}

# Casts by register type (``register_type``): a bfloat16 register holds its
# value widened to float32, so bfloat16 <-> float32 is a copy of the bits
# (BITS) and the instruction's rounding step (``Program.kernel_rounds``)
# rounds to bfloat16 where the result is bfloat16; uint32 and int32 are the
# same bits.
_CASTS = {
    (torch.int32, torch.float32): "I2F",
    (torch.float32, torch.int32): "F2I",
    (torch.bool, torch.float32): "B2F",
    (torch.bool, torch.int32): "B2I",
    (torch.float32, torch.bool): "F2B",
    (torch.int32, torch.bool): "I2B",
    (torch.float32, torch.float32): "BITS",
    (torch.int32, torch.uint32): "BITS",
    (torch.uint32, torch.int32): "BITS",
    (torch.uint32, torch.float32): "U2F",
    (torch.float32, torch.uint32): "F2U",
    (torch.bool, torch.uint32): "B2I",
    (torch.uint32, torch.bool): "I2B",
}


def register_type(dtype):
    """The type of the kernel register that holds a ``dtype`` value:
    bfloat16 values are held as float32."""
    return torch.float32 if dtype == torch.bfloat16 else dtype

# Kernel limits (csrc/tiles.cuh): a program beyond them raises on CUDA.
MAX_OPERANDS = 16
MAX_CONSTS = 32
MAX_INSTS = 128


class Node:
    """One node of an elementwise expression."""

    __slots__ = ("op", "args", "dtype", "ctype", "weak", "shape", "value", "n_ops")

    def __init__(self, op, args, dtype, shape, *, ctype=None, weak=False,
                 value=None):
        self.op = op
        self.args = tuple(args)
        self.dtype = dtype
        self.ctype = ctype if ctype is not None else dtype
        self.weak = weak
        self.shape = tuple(shape)
        self.value = value
        self.n_ops = sum(a.n_ops for a in self.args) + (op not in ("leaf", "const"))

    @property
    def key(self) -> str:
        """Promotion key: the dtype's name, or a weak kind for scalars."""
        if self.weak:
            if self.dtype == torch.bool:
                return "bool"
            if self.dtype.is_complex:
                return "c*"
            return "f*" if self.dtype.is_floating_point else "i*"
        return _dt.name(self.dtype)

    @property
    def ndim(self):
        return len(self.shape)

    def __repr__(self):
        return f"Node({self.op}, {_dt.name(self.dtype)}, {self.shape})"

    # Operators go through the sm-level node constructors (ops/fusion.py), so a
    # traced user function composes exactly as the public API does.
    def _bin(self, name, o, reverse=False):
        from . import fusion

        return fusion.binary_node(name, o, self) if reverse else fusion.binary_node(name, self, o)

    def __add__(self, o):
        return self._bin("add", o)

    def __radd__(self, o):
        return self._bin("add", o, True)

    def __sub__(self, o):
        return self._bin("subtract", o)

    def __rsub__(self, o):
        return self._bin("subtract", o, True)

    def __mul__(self, o):
        return self._bin("multiply", o)

    def __rmul__(self, o):
        return self._bin("multiply", o, True)

    def __truediv__(self, o):
        return self._bin("divide", o)

    def __rtruediv__(self, o):
        return self._bin("divide", o, True)

    def __floordiv__(self, o):
        return self._bin("floor_divide", o)

    def __rfloordiv__(self, o):
        return self._bin("floor_divide", o, True)

    def __mod__(self, o):
        return self._bin("remainder", o)

    def __rmod__(self, o):
        return self._bin("remainder", o, True)

    def __pow__(self, o):
        from . import fusion

        return fusion.pow_node(self, o)

    def __rpow__(self, o):
        from . import fusion

        return fusion.pow_node(o, self)

    def __matmul__(self, o):
        from . import fusion

        return fusion.matmul_node(self, o)

    def __rmatmul__(self, o):
        from . import fusion

        return fusion.matmul_node(o, self)

    def __neg__(self):
        from . import fusion

        return fusion.unary_node("negative", self)

    def __abs__(self):
        from . import fusion

        return fusion.unary_node("abs", self)

    def __eq__(self, o):
        return self._bin("equal", o)

    def __ne__(self, o):
        return self._bin("not_equal", o)

    def __lt__(self, o):
        return self._bin("less", o)

    def __le__(self, o):
        return self._bin("less_equal", o)

    def __gt__(self, o):
        return self._bin("greater", o)

    def __ge__(self, o):
        return self._bin("greater_equal", o)

    def __hash__(self):
        return id(self)

    def __bool__(self):
        raise TypeError(
            "a fused expression has no truth value; use sm.where for "
            "data-dependent selection"
        )


# ------------------------------------------------------------- construction
def leaf(shape, dtype) -> Node:
    return Node("leaf", (), dtype, shape)


def const(value, dtype=None, shape=()) -> Node:
    """A scalar constant: a Python scalar is weak (it takes the other
    operand's type, JAX's rule); a numpy scalar or an explicit dtype is
    strong.  ``shape`` lets a constant stand for a full array of one value
    (``ones_like``)."""
    if dtype is not None:
        return Node("const", (), dtype, shape, value=_py(value, dtype))
    if isinstance(value, np.generic):
        dt = _dt.from_numpy(value.dtype)
        return Node("const", (), dt, shape, value=_py(value.item(), dt))
    dt = _dt.result_dtype(value)
    return Node("const", (), dt, shape, weak=True, value=_py(value, dt))


def _py(value, dtype):
    if dtype == torch.bool:
        return bool(value)
    if dtype.is_floating_point:
        return float(value)
    if dtype.is_complex:
        return complex(value)
    # An int the type cannot hold wraps, as XLA's conversion does.
    info = torch.iinfo(dtype)
    return (int(value) - info.min) % (info.max - info.min + 1) + info.min


def cast(n: Node, dtype) -> Node:
    if n.dtype == dtype and not n.weak:
        return n
    if n.op == "const":
        return Node("const", (), dtype, n.shape, value=_py(n.value, dtype))
    if n.dtype == dtype:
        return n
    return Node("cast", (n,), dtype, n.shape, ctype=n.dtype)


def broadcast_all(*args) -> tuple:
    """The broadcast shape of the nodes ``args``."""
    out = ()
    for a in args:
        out = broadcast_shapes(out, a.shape).result_shape
    return out


# Ops that compute a bool operand as int32, as jnp does: ``square``,
# ``floor_divide`` and ``remainder`` give int32 (``//`` and ``%`` with
# XLA's values at a zero divisor), ``abs`` the bool unchanged.
_BOOL_AS_INT32 = frozenset(["abs", "square", "floor_divide", "remainder"])


def apply(name: str, *args: Node) -> Node:
    """The node for op ``name`` over ``args``, with its dtype rule.

    Operands are cast to the op's compute dtype, so every instruction of
    the lowered program reads registers of one type."""
    op = registry.op_def(name)
    rule = op.rule
    if rule == "user":
        return _trace_user(op, args)
    shape = broadcast_all(*args)
    if rule == "clip":
        a, lo, hi = args
        return apply("minimum", apply("maximum", a, lo), hi)
    weak = all(a.weak for a in args)
    if rule in ("promote", "inexact", "compare"):
        k = _dt.join_keys(*(a.key for a in args))
        ct = _dt.weak_to_dtype(k)
        if rule == "inexact":
            ct = _dt.to_inexact(ct)
        elif ct == torch.bool and name in _BOOL_AS_INT32:
            ct = torch.int32
        ins = [cast(a, ct) for a in args]
        out = torch.bool if rule == "compare" else ct
        return Node(name, ins, out, shape, ctype=ct, weak=weak and rule != "compare")
    if rule == "same":
        (a,) = args
        if a.dtype == torch.bool and name in _BOOL_AS_INT32:
            n = Node(name, (cast(a, torch.int32),), torch.int32, shape)
            return cast(n, torch.bool) if name == "abs" else n
        return Node(name, (a,), a.dtype, shape, weak=a.weak)
    if rule == "transcendental":
        (a,) = args
        if a.dtype == torch.float64:
            return Node(name, (a,), a.dtype, shape)
        out = a.dtype if a.dtype.is_floating_point and not a.weak else torch.float32
        return cast(Node(name, (cast(a, torch.float32),), torch.float32, shape), out)
    if rule == "where":
        c, x, y = args
        k = _dt.join_keys(x.key, y.key)
        ct = _dt.weak_to_dtype(k)
        return Node(name, (cast(c, torch.bool), cast(x, ct), cast(y, ct)), ct,
                    shape, weak=x.weak and y.weak)
    raise AssertionError(f"op {name!r} has no node rule {rule!r}")


_UNTRACEABLE: set = set()


class NotLowerable(TypeError):
    """A user op whose function does not trace onto IR nodes."""


def _trace_user(op, args):
    if op.name in _UNTRACEABLE or not op.pallas_ok:
        raise NotLowerable(op.name)
    try:
        out = op.fn(*args)
    except (TypeError, AttributeError, NotImplementedError) as e:
        _UNTRACEABLE.add(op.name)
        raise NotLowerable(op.name) from e
    if not isinstance(out, Node):
        _UNTRACEABLE.add(op.name)
        raise NotLowerable(op.name)
    return out


# ----------------------------------------------------------------- lowering
@dataclasses.dataclass(frozen=True)
class Program:
    """Flat SSA program.  ``insts[k] = (op, ctype, dtype, a, b, c)`` reads
    registers a, b, c (-1 = unused) of compute dtype ``ctype`` and writes
    register ``n_leaves + len(consts) + k`` of dtype ``dtype``."""

    leaf_dtypes: tuple
    consts: tuple  # ((value, dtype), ...)
    insts: tuple
    result: int
    dtype: torch.dtype

    @property
    def n_regs(self) -> int:
        return len(self.leaf_dtypes) + len(self.consts) + len(self.insts)

    @functools.cached_property
    def kernel_codes(self) -> Optional[tuple]:
        """Opcode per instruction, or None when some instruction, constant
        or register type has no kernel form.  A float16 operand has one (a
        load widens it) but no instruction computes in float16: it is the
        reductions' input, and the elementwise kernel stores no float16
        (``elementwise.check_program``)."""
        types = list(self.leaf_dtypes) + [d for _, d in self.consts] + [self.dtype]
        if any(t not in _dt.KERNEL_DTYPES and t != torch.float16 for t in types):
            return None
        codes = []
        for op, ctype, dtype, *_ in self.insts:
            if op == "cast":
                code = _CASTS.get((register_type(ctype), register_type(dtype)))
            else:
                code = registry.op_def(op).opcodes.get(register_type(ctype))
            if code is None:
                return None
            codes.append(OPCODE_INDEX[code])
        return tuple(codes)

    @functools.cached_property
    def kernel_rounds(self) -> tuple:
        """Per instruction, whether the kernel rounds its result to
        bfloat16: every instruction whose result is bfloat16, as torch's
        and jnp's bfloat16 ops compute in float32 and round once."""
        return tuple(dtype == torch.bfloat16 for _, _, dtype, *_ in self.insts)

    @functools.cached_property
    def dtypes(self) -> frozenset:
        """Every type the program reads, computes in or writes."""
        types = set(self.leaf_dtypes) | {d for _, d in self.consts} | {self.dtype}
        for _, ctype, dtype, *_ in self.insts:
            types |= {ctype, dtype}
        return frozenset(types)

    def within_limits(self) -> bool:
        return (
            len(self.leaf_dtypes) <= MAX_OPERANDS
            and len(self.consts) <= MAX_CONSTS
            and len(self.insts) <= MAX_INSTS
        )


def lower(root: Node, leaves: Sequence[Node]) -> Program:
    """Lower the expression ``root`` over the operand nodes ``leaves``."""
    reg = {id(n): i for i, n in enumerate(leaves)}
    consts, order, seen = [], [], set()

    def visit(n):
        if id(n) in reg or id(n) in seen:
            return
        seen.add(id(n))
        if n.op == "leaf":
            raise ValueError(
                "the expression reads an array that is not one of its operands"
            )
        if n.op == "const":
            consts.append(n)
            return
        for a in n.args:
            visit(a)
        order.append(n)

    visit(root)
    const_vals, const_reg = [], {}
    for n in consts:
        k = (n.dtype, repr(n.value))
        if k not in const_reg:
            const_reg[k] = len(leaves) + len(const_vals)
            const_vals.append((n.value, n.dtype))
        reg[id(n)] = const_reg[k]
    base = len(leaves) + len(const_vals)
    insts = []
    for k, n in enumerate(order):
        regs = [reg[id(a)] for a in n.args] + [-1] * (3 - len(n.args))
        insts.append((n.op, n.ctype, n.dtype, *regs))
        reg[id(n)] = base + k
    return Program(
        leaf_dtypes=tuple(n.dtype for n in leaves),
        consts=tuple(const_vals),
        insts=tuple(insts),
        result=reg[id(root)],
        dtype=root.dtype,
    )


def lower_epilogue(root: Node, product: Node, extras: Sequence[Node]) -> Program:
    """Lower the epilogue ``root`` of a matmul for the matmul kernel.

    Operand 0 of the program is ``product``, the leaf that stands for the
    accumulator: the kernel fills its register and loads nothing for it.
    The other operands are ``extras``.  The kernel widens a bfloat16 extra
    to float32 at the load, which is exact, so such a leaf enters the
    program as float32 and the cast the trace put on it is dropped.  An
    instruction that computes in bfloat16 is kept as it is; the program
    then has a type the epilogue does not take (``matmul.EPILOGUE_DTYPES``)."""
    prog = lower(root, [product, *extras])
    wide = {i for i, dt in enumerate(prog.leaf_dtypes) if i > 0 and dt == torch.bfloat16}
    if not wide:
        return prog
    base = len(prog.leaf_dtypes) + len(prog.consts)
    alias, insts = {}, []
    for k, (op, ctype, dtype, *regs) in enumerate(prog.insts):
        if op == "cast" and regs[0] in wide and dtype == torch.float32:
            alias[base + k] = regs[0]
            continue
        if any(r in wide for r in regs):
            return prog  # the leaf is read as bfloat16: nothing to widen
        alias[base + k] = base + len(insts)
        insts.append((op, ctype, dtype, *(alias.get(r, r) for r in regs)))
    if prog.result in wide:
        return prog
    return Program(
        leaf_dtypes=tuple(torch.float32 if i in wide else dt
                          for i, dt in enumerate(prog.leaf_dtypes)),
        consts=prog.consts,
        insts=tuple(insts),
        result=alias.get(prog.result, prog.result),
        dtype=prog.dtype,
    )


# ---------------------------------------------------------------- interpret
# torch implements little arithmetic for these on the CPU; the plain path
# widens them to int64 and wraps the result back.
_UNSIGNED = (torch.uint16, torch.uint32)


def _plain_fn(op: str, dtype):
    if op == "cast":
        return lambda x: x.to(dtype)
    op_def = registry.op_def(op)
    fn = op_def.fn
    unsigned_fn = op_def.unsigned_fn or fn

    def widening(*args):
        if any(a.dtype in _UNSIGNED for a in args):
            wide = (a.to(torch.int64) if a.dtype in _UNSIGNED else a for a in args)
            return unsigned_fn(*wide).to(dtype)
        return fn(*args)

    return widening


def run_plain(prog: Program, operands, out_shape, iterations: int = 1,
              carry: int = 0, device=None) -> torch.Tensor:
    """The plain version of the elementwise kernel: run ``prog`` on whole
    (broadcastable) tensors with torch ops, ``iterations`` times with
    operand ``carry`` replaced by the previous result.  Returns a new
    contiguous tensor of ``out_shape``; never one of ``operands``."""
    regs = list(operands)
    if device is None:
        device = operands[0].device
    for v, dt in prog.consts:
        regs.append(torch.tensor(v, dtype=dt, device=device))
    base = len(regs)
    regs += [None] * len(prog.insts)
    fns = [_plain_fn(op, dt) for op, _, dt, *_ in prog.insts]
    for _ in range(iterations):
        for k, (fn, inst) in enumerate(zip(fns, prog.insts)):
            regs[base + k] = fn(*(regs[r] for r in inst[3:] if r >= 0))
        if iterations > 1:
            regs[carry] = regs[prog.result]
    res = regs[prog.result]
    out_shape = tuple(out_shape)
    if (
        tuple(res.shape) == out_shape
        and res.dtype == prog.dtype
        and res.is_contiguous()
        and not any(res is o for o in operands)
    ):
        return res
    # Out of place, so that a tensor under a torch.func transform passes.
    return res.to(prog.dtype).broadcast_to(out_shape).clone(
        memory_format=torch.contiguous_format)
