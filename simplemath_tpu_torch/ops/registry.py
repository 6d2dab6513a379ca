"""Op registry — the extension mechanism of the framework.

Counterpart of ``simplemath_tpu/ops/registry.py``.  Each built-in ``Op``
carries its plain torch ``fn`` (what the plain interpreter and the torch
path run), a dtype ``rule`` (how its result type follows from its operands,
see ops/program.py) and its kernel ``opcodes`` by compute dtype.

``register_op(name, fn)`` adds a user op.  The kernel cannot call Python,
so a user op is lowered by calling ``fn`` on symbolic IR nodes, which works
when ``fn`` is built from operators and sm ops (``lambda a, b: (a + b) * 2``).
A user fn that cannot be traced that way runs as plain torch on the
tensors, and the dispatch counters record it (``torch_path:<name>``)::

    import simplemath_tpu_torch as sm
    sm.register_op("my_op", lambda a, b: (a + b) * 2)
    c = sm.apply_op("my_op", x, y)          # broadcast + kernel dispatch
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from . import transcendental as _tr

F32, I32, U32 = torch.float32, torch.int32, torch.uint32


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    fn: Callable  # plain torch function on tensors of the compute dtype
    arity: int = 2
    # Dtype rule (ops/program.py::apply); "user" ops are traced instead.
    rule: str = "user"
    # Kernel opcode name per register type (program.register_type: a
    # bfloat16 op takes the float32 opcode, the kernel then rounds);
    # empty = plain torch only.
    opcodes: Dict[torch.dtype, str] = dataclasses.field(default_factory=dict)
    # Whether the elementwise kernel may execute this op.
    pallas_ok: bool = True
    # ``fn`` for unsigned operands widened to int64 (ops/program.py), where
    # the two differ; None = ``fn``.
    unsigned_fn: Optional[Callable] = None


_REGISTRY: Dict[str, Op] = {}


def register_op(
    name: str,
    fn: Callable,
    *,
    arity: int = 2,
    pallas_ok: bool = True,
    overwrite: bool = False,
) -> Op:
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"op {name!r} already registered")
    op = Op(name=name, fn=fn, arity=arity, pallas_ok=pallas_ok)
    _REGISTRY[name] = op
    return op


def get_op(name: str) -> Op:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown op {name!r}; register it with sm.register_op"
        ) from None


def registered_ops():
    return dict(_REGISTRY)


def _builtin(name, fn, rule, arity=2, f32: Optional[str] = None,
             i32: Optional[str] = None, u32: Optional[str] = None, table=_REGISTRY,
             unsigned_fn=None):
    codes = {}
    if f32:
        codes[F32] = f32
    if i32:
        codes[I32] = i32
    if u32:
        codes[U32] = u32
    table[name] = Op(name=name, fn=fn, arity=arity, rule=rule, opcodes=codes,
                     unsigned_fn=unsigned_fn)


# Floor division and remainder with jnp.floor_divide's and jnp.remainder's
# values everywhere, division by zero included.  torch raises on an integer
# division by zero on the CPU, leaves it unspecified on CUDA and gives ±inf
# for a float x // 0.0, so no divisor of 0 (or -1, whose INT_MIN quotient
# overflows) ever reaches a torch division: explicit guards give XLA's
# values instead.  Floats: x // 0.0 and x % 0.0 are NaN.  Integers: XLA's
# x / 0 is -1 (all ones unsigned) and x % 0 is 0; the floor step then makes
# a signed x // 0 -2 for x != 0; INT_MIN // -1 wraps to INT_MIN.
def _floor_divide(x, y):
    zero = y == 0
    if x.is_floating_point():
        q = torch.floor_divide(x, torch.where(zero, 1.0, y))
        return torch.where(zero, torch.nan, q)
    neg1 = y == -1
    q = torch.div(x, torch.where(zero | neg1, 1, y), rounding_mode="trunc")
    q = torch.where(neg1, -x, torch.where(zero, -1, q))
    r = x - q * y
    return torch.where((torch.sign(x) != torch.sign(y)) & (r != 0), q - 1, q)


def _floor_divide_unsigned(x, y):
    zero = y == 0
    q = torch.div(x, torch.where(zero, 1, y), rounding_mode="trunc")
    return torch.where(zero, -1, q)


def _remainder(x, y):
    if x.is_floating_point():
        zero = y == 0
        return torch.where(zero, torch.nan, torch.remainder(x, torch.where(zero, 1.0, y)))
    return torch.remainder(x, torch.where((y == 0) | (y == -1), 1, y))


# ---------------------------------------------------------------- built-ins
# Binary arithmetic.  True division follows NumPy (int/int -> float).
# uint32 takes the int32 opcode wherever the bits are the same (wrapping
# arithmetic, equality, select) and an unsigned one elsewhere.  Floor
# division and remainder have integer opcodes only; float ones run as
# plain torch.
_builtin("add", torch.add, "promote", f32="ADD_F", i32="ADD_I", u32="ADD_I")
_builtin("subtract", torch.sub, "promote", f32="SUB_F", i32="SUB_I", u32="SUB_I")
_builtin("multiply", torch.mul, "promote", f32="MUL_F", i32="MUL_I", u32="MUL_I")
_builtin("divide", torch.div, "inexact", f32="DIV_F")
_builtin("floor_divide", _floor_divide, "promote", i32="FDIV_I", u32="FDIV_U",
         unsigned_fn=_floor_divide_unsigned)
_builtin("remainder", _remainder, "promote", i32="MOD_I", u32="MOD_U")
_builtin("maximum", torch.maximum, "promote", f32="MAX_F", i32="MAX_I", u32="MAX_U")
_builtin("minimum", torch.minimum, "promote", f32="MIN_F", i32="MIN_I", u32="MIN_U")

# Comparisons write bool.
_builtin("equal", torch.eq, "compare", f32="EQ_F", i32="EQ_I", u32="EQ_I")
_builtin("not_equal", torch.ne, "compare", f32="NE_F", i32="NE_I", u32="NE_I")
_builtin("less", torch.lt, "compare", f32="LT_F", i32="LT_I", u32="LT_U")
_builtin("less_equal", torch.le, "compare", f32="LE_F", i32="LE_I", u32="LE_U")
_builtin("greater", torch.gt, "compare", f32="GT_F", i32="GT_I", u32="GT_U")
_builtin("greater_equal", torch.ge, "compare", f32="GE_F", i32="GE_I", u32="GE_U")

# Unary.
_builtin("negative", torch.neg, "same", 1, f32="NEG_F", i32="NEG_I", u32="NEG_I")
_builtin("abs", torch.abs, "same", 1, f32="ABS_F", i32="ABS_I", u32="BITS")
_builtin("sqrt", torch.sqrt, "inexact", 1, f32="SQRT_F")
_builtin("square", lambda a: a * a, "same", 1, f32="SQUARE_F", i32="SQUARE_I", u32="SQUARE_I")
_builtin("sin", torch.sin, "transcendental", 1, f32="SIN_F")
_builtin("cos", torch.cos, "transcendental", 1, f32="COS_F")
_builtin("tan", torch.tan, "transcendental", 1, f32="TAN_F")
_builtin("tanh", lambda a: _tr.unary("tanh", a), "transcendental", 1, f32="TANH_F")
_builtin("sign", _tr.sign, "same", 1, f32="SIGN_F", i32="SIGN_I", u32="SIGN_U")

# Ternary: select and clamp (NumPy where/clip semantics).  clip lowers to
# minimum(maximum(a, lo), hi), which is what jnp.clip computes.
_builtin("where", torch.where, "where", 3, f32="SELECT", i32="SELECT", u32="SELECT")
_builtin(
    "clip", lambda a, lo, hi: torch.minimum(torch.maximum(a, lo), hi), "clip", 3
)

# Ops the IR uses that are not public registry entries: the transcendentals
# reached through sm.exp/... and sm.pow, and dtype conversion.
INTERNAL: Dict[str, Op] = {}
for _n, _c in (("exp", "EXP_F"), ("log", "LOG_F"), ("exp2", "EXP2_F"),
               ("log2", "LOG2_F")):
    _builtin(_n, (lambda n: lambda a: _tr.unary(n, a))(_n), "transcendental", 1,
             f32=_c, table=INTERNAL)
_builtin("pow", _tr.pow, "internal", f32="POW_F", table=INTERNAL)
_builtin("ipow", _tr.ipow_tile, "internal", i32="IPOW_I", table=INTERNAL)


def op_def(name: str) -> Op:
    """A registry op or one of the IR's internal ops."""
    op = INTERNAL.get(name)
    return op if op is not None else get_op(name)
