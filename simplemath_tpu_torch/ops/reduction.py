"""The wrapper of the hand-written map-reduce kernel, and the reductions
that run as plain torch.

Counterpart of ``simplemath_tpu/ops/reduction.py`` and its six Pallas
kernels.  On the card they become one CUDA kernel with two entry points
(csrc/reduction.cu; its first passes are reduction_full.cu, _cols.cu and
_rows.cu over reduction.cuh), which run the elementwise kernel's opcode
program on quads of four elements and reduce its results without storing
them:

* ``rd_full`` reduces a program over operands of rank <= 8 to one scalar:
  ``reduce`` (the identity program; ``_build_reduce_1d``/``_2d``),
  ``dot1d`` (``a*b``; ``_build_dot1d``) and ``map_reduce`` (any fused
  expression; ``_build_map_reduce_1d``/``_2d``);
* ``rd_axis`` reduces a mapped 2-D expression along axis 0 or 1:
  ``reduce_axis`` and ``map_reduce_axis`` (``_build_reduce_axis``).

Operands are tensors or ``elementwise.View``s, read in place through their
strides (stride 0 broadcasts).  Each function looks at their device.  CPU
tensors take the kernel's plain version: ``program.run_plain``, then
``torch.sum/amax/amin`` accumulating in float32 (the int32 dot in int64,
masked to 32 bits).  CUDA tensors launch the kernel or raise: there is no
fallback, but for the caller's ``interpret_kernels()`` (the plain version,
counted as ``interpret:reduce``); a traced call goes through
``sm::rd_full``/``sm::rd_axis`` (ops/library.py).  ``LAUNCHES`` counts the calls that launched the kernel, by
entry point, and ``PATHS`` the same launches by the way the kernel
evaluated them, which ``path`` decides from the program, the shape and the
operands' layouts: ``direct`` (the identity program), ``single`` (a sum of
one instruction, its opcode hoisted out of the loop) or ``generated`` (any
other program, and any program whose operands do not allow quad loads: an
evaluator generated for the program, the reduction and the walk, compiled
at run time, ops/codegen.py, kind ``"reduce"``); ``interp`` counts the
launches of the interpreter, which ``interpret`` alone makes: the reference
the generated evaluators are held to, bit for bit.  A quad is four elements
read with one load: 16 bytes of a 4-byte type, or 8 bytes of a 2-byte type
(bfloat16, float16) widened to float32 in registers; an operand allows it
where it is quad-aligned (``elementwise.quad_aligned``) and, along rows, its
rows are whole quads (``reach``: otherwise its elements are gathered).

The kernel accumulates in float32 whatever the float input; the int32 dot
wraps mod 2**32.  Dispatch names are the JAX package's: ``reduce:<kind>``,
``dot1d``, ``reduce_fused:<kind>`` and ``reduce_axis:<kind><axis>``.

``torch_reduce``, ``torch_mean`` and ``torch_dot`` are the reductions the
kernel does not take (integer, bool, bfloat16 and float64 inputs, axis
tuples, rank > 2 with an axis), with ``jnp``'s result dtypes under x64;
they record ``torch_path:<kind>``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import dtypes as _dt
from . import codegen, dispatch, elementwise, library, program

# Kernel launches by entry point since the last reset, and the same
# launches by path.
LAUNCHES = {"rd_full": 0, "rd_axis": 0}
PATHS = {"direct": 0, "single": 0, "generated": 0, "interp": 0}
_RD_DIRECT, _RD_SINGLE, _RD_LANES4, _RD_ELEMENT = 0, 1, 2, 3  # enum RdPath
# The opcodes the kernel's hoisted loop is built for (rd_single_takes in
# csrc/reduction.cuh): all but the transcendental and trigonometric
# functions, the integer power, and the unsigned, bit-copy and
# integer-division opcodes (LT_U on).
HOISTED = frozenset(
    i for i, name in enumerate(program.OPCODES[:program.OPCODE_INDEX["LT_U"]])
    if name not in ("EXP_F", "LOG_F", "EXP2_F", "LOG2_F", "TANH_F", "SIN_F", "COS_F", "TAN_F",
                    "POW_F", "IPOW_I"))

KINDS = ("sum", "max", "min")
# The input types the kernel reduces (in float32) for Array.sum/max/min/mean:
# every float type but float64, as the JAX package's Pallas reductions.
FLOAT_INPUTS = frozenset([torch.float32, torch.bfloat16, torch.float16])
_OP = {"sum": 0, "max": 1, "min": 2}
_SUM_I32 = 3

# Grid sizes: functions of the shape alone, so a call's order of
# combination, and its bits, are the same every time (csrc/reduction.cuh).
_THREADS = 256
_WARPS = _THREADS // 32
_MAX_BLOCKS = 132 * 8
_MAX_SEGMENTS = 65535  # gridDim.y


def reset_launches() -> None:
    for counts in (LAUNCHES, PATHS):
        for k in counts:
            counts[k] = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def full_blocks(n: int) -> int:
    """Partial blocks of rd_full for ``n`` elements: one thread per quad of
    4 elements, at most ``_MAX_BLOCKS`` blocks."""
    return max(1, min(_MAX_BLOCKS, _cdiv(_cdiv(n, 4), _THREADS)))


def axis_grid(rows: int, cols: int, axis: int):
    """(blocks, rows per segment) of rd_axis.

    Axis 1: a block takes a row at a time, or, where a row has at most 32
    quads of 4 columns, 8 rows at a time (a warp each); the second value is
    that 1 or 8, and there are at most 8 * ``_MAX_BLOCKS`` blocks, which
    stride over the rows.

    Axis 0: a block is 32 quads of columns by 8 row lanes over one segment
    of rows; the segments are whole multiples of 32 rows (4 a row lane),
    enough of them to give ~2 * ``_MAX_BLOCKS`` blocks."""
    quads = _cdiv(cols, 4)
    if axis == 1:
        per_block = _WARPS if quads <= 32 else 1
        return min(_cdiv(rows, per_block), 8 * _MAX_BLOCKS), per_block
    segs = max(1, min(_cdiv(rows, 32), _cdiv(2 * _MAX_BLOCKS, _cdiv(quads, 32)),
                      _MAX_SEGMENTS))
    seg_rows = _cdiv(_cdiv(rows, segs), 32) * 32
    return _cdiv(rows, seg_rows), seg_rows


# ------------------------------------------------------------ the path
layout = elementwise.layout


def _wide(shape, operand_layout, rows: bool) -> bool:
    """Whether every operand of more than one element can be read a quad
    at a time: 4- or 2-byte elements and, as flat data, contiguous and
    full-size at a quad-aligned address; or (``rows``), over the
    expression's (rows, cols), a column stride of 1 with quad-aligned rows
    (a row stride that is a multiple of 4; full-size operands and (1, C)
    rows) or of 0 ((R, 1) columns, read an element a row)."""
    for s, st, dt, address in operand_layout:
        if math.prod(s) == 1:
            continue
        if dt.itemsize not in (2, 4):
            return False
        if not rows:
            if not elementwise._is_full(s, st, shape) or not elementwise.quad_aligned(dt, address):
                return False
            continue
        s2, st2 = (1,) * (2 - len(s)) + tuple(s), (0,) * (2 - len(s)) + tuple(st)
        row_stride = 0 if s2[0] == 1 else st2[0]
        col_stride = 0 if s2[1] == 1 else st2[1]
        if col_stride == 0:
            continue
        if col_stride != 1 or row_stride % 4 or not elementwise.quad_aligned(dt, address):
            return False
    return True


def reach(shape, operand_layout, axis=None) -> str:
    """How the kernel reaches the operands: ``"flat"`` (rd_full: quad
    loads of flat data), ``"rows"`` (quad loads along the rows of a 2-D
    expression with full-size, (1, C), (R, 1) or one-element operands:
    rd_axis, and rd_full where an operand is broadcast) or ``"gather"``
    (element by element through the strides)."""
    shape = tuple(shape)
    if axis is None and _wide(shape, operand_layout, False):
        return "flat"
    if len(shape) == 2 and _wide(shape, operand_layout, True):
        return "rows"
    return "gather"


def path(prog, kind: str, shape, operand_layout, axis=None) -> str:
    """The way the kernel evaluates a launch (csrc/reduction.cuh): a pure
    function of the program, the reduction, the expression's shape and
    ``layout(operands)``.  ``axis`` None is rd_full, 0 or 1 rd_axis."""
    how = reach(shape, operand_layout, axis)
    if how == "gather" or (axis is None and how == "rows"):
        return "generated"  # the compiled loops take quads of flat data (rd_full) or rows (rd_axis)
    n_ops = len(operand_layout)
    if not prog.insts:
        return "direct" if prog.result < n_ops else "generated"
    codes = prog.kernel_codes
    if (kind == "sum" and len(prog.insts) == 1 and prog.result == n_ops + len(prog.consts)
            and codes is not None and codes[0] in HOISTED):
        return "single"
    return "generated"


def walk(shape, operand_layout, axis=None) -> tuple:
    """(walk, gathered) of a generated evaluator's launch: the walk of
    csrc/reduction.cuh it is handed to (rd_full's ``"flat"``, ``"rows"`` of
    a 2-D expression or ``"strided"``, gathered only; rd_axis's ``"axis0"``
    or ``"axis1"``) and whether its operands are gathered element by
    element."""
    how = reach(shape, operand_layout, axis)
    if axis is not None:
        return f"axis{axis}", how == "gather"
    if how == "gather":
        flat = all(elementwise._flat(s, st, tuple(shape)) for s, st, _, _ in operand_layout)
        return ("flat" if flat else "strided"), True
    return how, False


# ------------------------------------------------------------ C interface
class _RdParams(ctypes.Structure):
    _fields_ = [
        ("p", elementwise._Params),
        ("op", ctypes.c_int32),
        ("strided", ctypes.c_int32),
        ("blocks", ctypes.c_int64),
        ("seg_rows", ctypes.c_int64),
        ("axis", ctypes.c_int32),
        ("path", ctypes.c_int32),
    ]


@functools.lru_cache(maxsize=None)
def _library():
    """The built kernel library, its parameter layout checked once."""
    lib = elementwise._library()
    if lib.sm_rd_params_size() != ctypes.sizeof(_RdParams):
        raise RuntimeError("reduction kernel parameter layout does not match its binding")
    return lib


def _launch(entry, prog, kind, op, shape, operands, device, axis=None, interpreted=False):
    lib = _library()
    codes = elementwise.check_program(prog, entry, _dt.KERNEL_DTYPES | FLOAT_INPUTS)
    q = _RdParams()
    q.p, _ = elementwise.params(prog, codes, shape, operands)
    q.op = op
    where = layout(operands)
    taken = "interp" if interpreted else path(prog, kind, shape, where, axis)
    how, gathered = walk(shape, where, axis)
    q.path = {"direct": _RD_DIRECT, "single": _RD_SINGLE}.get(
        taken, _RD_ELEMENT if gathered else _RD_LANES4)
    if entry == "rd_full":
        # enum RdReach: flat data, strides over the shape (gathered), or
        # the quads of the rows of a 2-D expression.
        q.strided = {"flat": 0, "strided": 1, "rows": 2}[how]
        q.blocks = full_blocks(shape[0] * _cdiv(shape[1], 4) * 4 if how == "rows"
                               else math.prod(shape))
        out = torch.empty((), dtype=torch.int32 if op == _SUM_I32 else torch.float32,
                          device=device)
        partial = torch.empty(q.blocks, dtype=torch.int32, device=device)
    else:
        rows, cols = shape
        q.axis = axis
        q.blocks, q.seg_rows = axis_grid(rows, cols, axis)
        out = torch.empty(cols if axis == 0 else rows,
                          dtype=torch.int32 if op == _SUM_I32 else torch.float32, device=device)
        # Axis 0: a row of partials per segment, padded to whole quads.
        partial = torch.empty(q.blocks * _cdiv(cols, 4) * 4 if axis == 0 else 1,
                              dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if taken == "generated":
            sig = signature(prog, codes, op, shape, operands, axis)
            rc = lib.sm_rd_launch_kernel(codegen.kernel(lib, sig), ctypes.byref(q),
                                         int(entry == "rd_axis"), partial.data_ptr(),
                                         out.data_ptr(), stream)
        else:
            launch = lib.sm_rd_full_launch if entry == "rd_full" else lib.sm_rd_axis_launch
            rc = launch(ctypes.byref(q), partial.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{entry} ({taken}) launch failed: cudaError {rc}")
    LAUNCHES[entry] += 1
    PATHS[taken] += 1
    return out


def signature(prog, codes, op, shape, operands, axis=None) -> codegen.Signature:
    """The signature of the evaluator generated for this launch (``op``: the
    reduction's code, ``RdOp``): the program, the operands' types, which
    are one element, the walk and whether the operands are gathered; never
    the shape, the strides or the constants' values."""
    how, gathered = walk(shape, layout(operands), axis)
    descs = [elementwise._describe(o) for o in operands]
    return codegen.signature(
        prog, codes, [elementwise._DTYPE_CODE[buf.dtype] for buf, _, _, _ in descs],
        elementwise._DTYPE_CODE[prog.dtype], 0, 1, 0, False, kind="reduce",
        scalars=[math.prod(s) == 1 for _, _, s, _ in descs], reduce=op, walk=how,
        gathered=gathered)


# ------------------------------------------------------- plain versions
def values(prog, shape, operands, device):
    """The mapped expression, stored: the plain version's first step."""
    return program.run_plain(prog, [elementwise.read(o) for o in operands], shape,
                             device=device)


def _plain(vals, kind, dim=None):
    """``vals`` cast to float32, then reduced (the kernel's accumulator)."""
    v = vals.to(torch.float32)
    if kind == "sum":
        return v.sum() if dim is None else v.sum(dim)
    fn = torch.amax if kind == "max" else torch.amin
    return fn(v) if dim is None else fn(v, dim)


def _plain_sum_i32(vals, dim=None):
    """Sum of int32 ``vals`` (along ``dim``) wrapping mod 2**32 (no int64
    overflow: each term is masked to 32 bits first)."""
    masked = vals.to(torch.int64) & 0xFFFFFFFF
    s = (masked.sum() if dim is None else masked.sum(dim)) & 0xFFFFFFFF
    return torch.where(s >= 2**31, s - 2**32, s).to(torch.int32)


# ------------------------------------------------------------- entries
def run(prog, kind, axis, shape, operands, int_acc=False) -> torch.Tensor:
    """The ``kind`` reduction of the expression ``prog`` over ``operands``
    (shape ``shape``), full (``axis`` None, any rank) or along axis 0 or 1
    of a 2-D expression: a float32 result, or with ``int_acc`` the int32
    sum wrapping mod 2**32.  The map-reduce kernel's one route: operands
    under a ``torch.func`` transform go through ``autodiff.Reduce`` (the
    same kernel with derivative and batching rules), the rest to the
    kernel, or to its plain version on the CPU.  Records no dispatch: the
    entries below do."""
    from . import autodiff

    shape = tuple(int(s) for s in shape)
    if kind not in KINDS:
        raise ValueError(f"unknown reduction {kind!r}; expected one of {KINDS}")
    if axis is not None and (len(shape) != 2 or axis not in (0, 1)):
        raise ValueError(f"the axis kernel reduces axis 0 or 1 of a 2-D expression; "
                         f"got axis {axis} of shape {shape}")
    if int_acc and (kind != "sum" or prog.dtype != torch.int32 or axis == 0):
        raise ValueError("the int32 accumulator takes an int32 sum, full or along axis 1")
    if any(map(autodiff.transformed, operands)):
        return autodiff.reduce(prog, kind, axis, shape,
                               [elementwise.read(o) for o in operands], int_acc)
    device = elementwise.operand_device(prog, shape, operands)
    if math.prod(shape) == 0:
        raise ValueError("the reduction kernel takes a non-empty expression")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the reduction kernel runs on CUDA tensors, not {device}")
    op = _SUM_I32 if int_acc else _OP[kind]
    plain = device.type == "cpu" or dispatch.INTERPRET.get()
    if device.type == "cuda" and plain:
        dispatch.record("interpret", "reduce")
    elif library.tracing(operands) and (device.type == "cuda" or elementwise.takes(
            prog, "reduction", _dt.KERNEL_DTYPES | FLOAT_INPUTS)):
        elementwise.check_program(prog, "reduction", _dt.KERNEL_DTYPES | FLOAT_INPUTS)
        return library.call_reduction(prog, op, shape, operands, axis)
    if plain:
        vals = values(prog, shape, operands, device)
        return _plain_sum_i32(vals, axis) if int_acc else _plain(vals, kind, axis)
    return _launch("rd_full" if axis is None else "rd_axis", prog, kind, op, shape,
                   operands, device, axis)



def interpret(prog, kind, axis, shape, operands, int_acc=False) -> torch.Tensor:
    """The reduction ``run`` computes, but on CUDA tensors through the
    interpreter (csrc/reduction.cuh, ``RdLanes4``: quads loaded whole, or
    gathered where ``reach`` says so), whatever the program: the reference
    of the generated evaluators.  CPU tensors take the plain version."""
    shape = tuple(int(s) for s in shape)
    device = elementwise.operand_device(prog, shape, operands)
    if device.type == "cpu":
        vals = values(prog, shape, operands, device)
        return _plain_sum_i32(vals, axis) if int_acc else _plain(vals, kind, axis)
    return _launch("rd_full" if axis is None else "rd_axis", prog, kind,
                   _SUM_I32 if int_acc else _OP[kind], shape, operands, device, axis,
                   interpreted=True)


@functools.lru_cache(maxsize=None)
def identity(dtype) -> program.Program:
    leaf = program.leaf((), dtype)
    return program.lower(leaf, [leaf])


def reduce(x, kind: str = "sum") -> torch.Tensor:
    """Full sum/max/min of ``x`` as a 0-d float32 tensor (float32
    accumulation).  Counterpart of ``pallas_reduce``."""
    dispatch.record("reduce", kind)
    return run(identity(x.dtype), kind, None, x.shape, [x])


def reduce_axis(x, kind: str, axis: int) -> torch.Tensor:
    """Sum/max/min of the 2-D ``x`` along ``axis`` as a 1-D float32 tensor.
    Counterpart of ``pallas_reduce_axis``."""
    dispatch.record("reduce_axis", f"{kind}{axis}")
    return run(identity(x.dtype), kind, axis, x.shape, [x])


def dot_program(a_shape, a_dtype, b_shape, b_dtype) -> program.Program:
    """The product ``a*b`` of the 1-D dot: in the operands' promoted type,
    a float one in float32 (bfloat16 operands are multiplied in float32, as
    ``_build_dot1d`` multiplies in its accumulator's type)."""
    la, lb = program.leaf(tuple(a_shape), a_dtype), program.leaf(tuple(b_shape), b_dtype)
    prod = program.apply("multiply", la, lb)
    if prod.dtype.is_floating_point and prod.dtype != torch.float32:
        prod = program.apply("multiply", program.cast(la, torch.float32),
                             program.cast(lb, torch.float32))
    return program.lower(prod, [la, lb])


def dot1d(a, b) -> torch.Tensor:
    """The 1-D dot of ``a`` and ``b`` in one pass, the product never
    stored: a 0-d float32 tensor, or int32 wrapping mod 2**32 when the
    product is int32.  Counterpart of ``pallas_dot1d``."""
    dispatch.record("dot1d")
    if len(a.shape) != 1 or tuple(a.shape) != tuple(b.shape):
        raise ValueError(f"dot1d takes two 1-D operands of one length, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    prog = dot_program(a.shape, a.dtype, b.shape, b.dtype)
    return run(prog, "sum", None, a.shape, [a, b], int_acc=prog.dtype == torch.int32)


def map_reduce(prog: program.Program, kind: str, out_shape, *operands) -> torch.Tensor:
    """Sum/max/min of the expression ``prog`` over broadcast ``operands``
    (shape ``out_shape``) as a 0-d float32 tensor, in one pass.
    Counterpart of ``pallas_map_reduce``."""
    dispatch.record("reduce_fused", kind)
    return run(prog, kind, None, out_shape, operands)


def map_reduce_axis(prog: program.Program, kind: str, axis: int, out_shape,
                    *operands) -> torch.Tensor:
    """Sum/max/min along ``axis`` of the 2-D expression ``prog`` over
    (1|R, 1|C) ``operands`` as a 1-D float32 tensor, in one pass.
    Counterpart of ``pallas_map_reduce_axis``."""
    dispatch.record("reduce_axis", f"{kind}{axis}")
    return run(prog, kind, axis, out_shape, operands)


# ------------------------------------------------------ the torch path
def axes(axis, ndim: int) -> tuple:
    """``axis`` (None, an int or a sequence) as a tuple of dims in
    [0, ndim), raising ValueError as NumPy does for one out of bounds."""
    if axis is None:
        return tuple(range(ndim))
    out = []
    for a in (tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)):
        a = int(a)
        if not -ndim <= a < ndim:
            raise ValueError(f"axis {a} is out of bounds for array of dimension {ndim}")
        out.append(a % ndim)
    if len(set(out)) != len(out):
        raise ValueError(f"repeated axis in {axis!r}")
    return tuple(out)


def torch_reduce(t: torch.Tensor, kind: str, axis=None, keepdims=False) -> torch.Tensor:
    """``jnp.sum/max/min`` under x64 as plain torch: integer and bool sums
    widen to int64 (unsigned to uint64); a bfloat16 or float16 sum
    accumulates in float32; max/min keep the dtype."""
    dispatch.record("torch_path", kind)
    dims = axes(axis, t.ndim)
    dt = t.dtype
    if kind != "sum" and any(t.shape[d] == 0 for d in dims):
        raise ValueError(
            f"zero-size array to reduction operation {kind} which has no identity"
        )
    if kind == "sum":
        if dt == torch.bool or _dt.is_integer(dt):
            out = _dt.reduction_dtype(dt, kind)
            return t.to(torch.int64).sum(dims, keepdim=keepdims).to(out)
        if dt in (torch.bfloat16, torch.float16):
            return t.sum(dims, keepdim=keepdims, dtype=torch.float32).to(dt)
        return t.sum(dims, keepdim=keepdims)
    if dt == torch.bool:
        fn = torch.any if kind == "max" else torch.all
        return fn(t, dims, keepdim=keepdims)
    fn = torch.amax if kind == "max" else torch.amin
    if dt in _dt.UNSIGNED:
        return fn(t.to(torch.int64), dims, keepdim=keepdims).to(dt)
    return fn(t, dims, keepdim=keepdims)


def divide(total: torch.Tensor, count: int) -> torch.Tensor:
    """``total / count`` as JAX divides a reduction by a Python int: in the
    total's float dtype (int64 totals in float64), by a tensor on the same
    device, so CUDA divides and does not multiply by a reciprocal."""
    dt = _dt.to_inexact(total.dtype)
    return total.to(dt) / torch.full((), count, dtype=dt, device=total.device)


def torch_mean(t: torch.Tensor, axis=None, keepdims=False) -> torch.Tensor:
    """``jnp.mean`` under x64 as plain torch: integer and bool inputs give
    float32 (64-bit ones float64), a bfloat16 or float16 mean is taken in
    float32 and cast back."""
    dispatch.record("torch_path", "mean")
    dims = axes(axis, t.ndim)
    out = _dt.reduction_dtype(t.dtype, "mean")
    comp = torch.float32 if out in (torch.bfloat16, torch.float16) else out
    total = t.to(comp).sum(dims, keepdim=keepdims)
    return divide(total, math.prod(t.shape[d] for d in dims)).to(out)


def torch_dot(a: torch.Tensor, b: torch.Tensor, out: torch.dtype) -> torch.Tensor:
    """The 1-D dot as plain torch, giving ``out``: integers wrap exactly to
    the width of ``out`` (computed in int64, each product masked first);
    floats accumulate in float32 at least; bool is any(a & b)."""
    dispatch.record("torch_path", "dot")
    if out == torch.bool:
        return (a.to(torch.bool) & b.to(torch.bool)).any()
    if _dt.is_integer(out):
        prod = a.to(torch.int64) * b.to(torch.int64)
        bits = torch.iinfo(out).bits
        if bits == 64:
            return prod.sum().to(out)
        mask = (1 << bits) - 1
        s = (prod & mask).sum() & mask
        if out not in _dt.UNSIGNED:
            s = torch.where(s >= 1 << (bits - 1), s - (1 << bits), s)
        return s.to(out)
    acc = torch.float32 if out in (torch.bfloat16, torch.float16) else out
    return (a.to(acc) * b.to(acc)).sum().to(out)
