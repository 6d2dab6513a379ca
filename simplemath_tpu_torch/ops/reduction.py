"""The wrapper of the hand-written map-reduce kernel, and the reductions
that run as plain torch.

Counterpart of ``simplemath_tpu/ops/reduction.py`` and its six Pallas
kernels.  On the card they become one CUDA kernel with two entry points
(csrc/reduction.cu), which run the elementwise kernel's opcode program per
element and reduce its results without storing them:

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
fallback.  ``LAUNCHES`` counts the calls that launched the kernel, by
entry point.

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
from . import dispatch, elementwise, program

# Kernel launches by entry point since the last reset.
LAUNCHES = {"rd_full": 0, "rd_axis": 0}

KINDS = ("sum", "max", "min")
_OP = {"sum": 0, "max": 1, "min": 2}
_SUM_I32 = 3

# Grid sizes: functions of the shape alone, so a call's order of
# combination, and its bits, are the same every time (csrc/reduction.cu).
_THREADS = 256
_MAX_BLOCKS = 132 * 8
_MAX_SEGMENTS = 65535  # gridDim.y


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def full_blocks(n: int) -> int:
    """Partial blocks of rd_full for ``n`` elements: one thread per quad of
    4 elements, at most ``_MAX_BLOCKS`` blocks."""
    return max(1, min(_MAX_BLOCKS, _cdiv(_cdiv(n, 4), _THREADS)))


def axis_grid(rows: int, cols: int, axis: int):
    """(blocks, rows per segment) of rd_axis: axis 1 takes a block per row
    (at most ``_MAX_BLOCKS``); axis 0 a thread per column and the rows in
    segments of at least 32, enough of them to give ~2 * ``_MAX_BLOCKS``
    blocks."""
    if axis == 1:
        return min(rows, _MAX_BLOCKS), 0
    segs = max(1, min(_cdiv(rows, 32), _cdiv(2 * _MAX_BLOCKS, _cdiv(cols, _THREADS)),
                      _MAX_SEGMENTS))
    seg_rows = _cdiv(rows, segs)
    return _cdiv(rows, seg_rows), seg_rows


# ------------------------------------------------------------ C interface
class _RdParams(ctypes.Structure):
    _fields_ = [
        ("p", elementwise._Params),
        ("op", ctypes.c_int32),
        ("strided", ctypes.c_int32),
        ("blocks", ctypes.c_int64),
        ("seg_rows", ctypes.c_int64),
        ("axis", ctypes.c_int32),
        ("pad", ctypes.c_int32),
    ]


@functools.lru_cache(maxsize=None)
def _library():
    """The built kernel library, its parameter layout checked once."""
    lib = elementwise._library()
    if lib.sm_rd_params_size() != ctypes.sizeof(_RdParams):
        raise RuntimeError("reduction kernel parameter layout does not match its binding")
    return lib


def _launch(entry, prog, op, shape, operands, device, axis=0):
    lib = _library()
    codes = elementwise.check_program(prog, entry)
    q = _RdParams()
    q.p, flat = elementwise.params(prog, codes, shape, operands)
    q.op = op
    if entry == "rd_full":
        q.strided = int(not flat)
        q.blocks = full_blocks(math.prod(shape))
        out = torch.empty((), dtype=torch.int32 if op == _SUM_I32 else torch.float32,
                          device=device)
        partial = torch.empty(q.blocks, dtype=torch.int32, device=device)
    else:
        rows, cols = shape
        q.axis = axis
        q.blocks, q.seg_rows = axis_grid(rows, cols, axis)
        out = torch.empty(cols if axis == 0 else rows, dtype=torch.float32, device=device)
        partial = torch.empty(q.blocks * cols if axis == 0 else 1, dtype=torch.int32,
                              device=device)
    launch = lib.sm_rd_full_launch if entry == "rd_full" else lib.sm_rd_axis_launch
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = launch(ctypes.byref(q), partial.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {rc}")
    LAUNCHES[entry] += 1
    return out


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


def _plain_sum_i32(vals):
    """Sum of int32 ``vals`` wrapping mod 2**32 (no int64 overflow: each
    term is masked to 32 bits first)."""
    s = (vals.to(torch.int64) & 0xFFFFFFFF).sum() & 0xFFFFFFFF
    return torch.where(s >= 2**31, s - 2**32, s).to(torch.int32)


# ------------------------------------------------------------- entries
def _full(prog, kind, shape, operands, int_acc=False):
    shape = tuple(int(s) for s in shape)
    if kind not in KINDS:
        raise ValueError(f"unknown reduction {kind!r}; expected one of {KINDS}")
    device = elementwise.operand_device(prog, shape, operands)
    if math.prod(shape) == 0:
        raise ValueError("the reduction kernel takes a non-empty expression")
    if int_acc and (kind != "sum" or prog.dtype != torch.int32):
        raise ValueError("the int32 accumulator takes an int32 sum")
    if device.type == "cpu":
        vals = values(prog, shape, operands, device)
        return _plain_sum_i32(vals) if int_acc else _plain(vals, kind)
    if device.type != "cuda":
        raise ValueError(f"the reduction kernel runs on CUDA tensors, not {device}")
    return _launch("rd_full", prog, _SUM_I32 if int_acc else _OP[kind], shape,
                   operands, device)


def _axis(prog, kind, axis, shape, operands):
    shape = tuple(int(s) for s in shape)
    if kind not in KINDS:
        raise ValueError(f"unknown reduction {kind!r}; expected one of {KINDS}")
    if len(shape) != 2 or axis not in (0, 1):
        raise ValueError(f"the axis kernel reduces axis 0 or 1 of a 2-D expression; "
                         f"got axis {axis} of shape {shape}")
    device = elementwise.operand_device(prog, shape, operands)
    if math.prod(shape) == 0:
        raise ValueError("the reduction kernel takes a non-empty expression")
    if device.type == "cpu":
        return _plain(values(prog, shape, operands, device), kind, axis)
    if device.type != "cuda":
        raise ValueError(f"the reduction kernel runs on CUDA tensors, not {device}")
    return _launch("rd_axis", prog, _OP[kind], shape, operands, device, axis)


@functools.lru_cache(maxsize=None)
def _identity(dtype) -> program.Program:
    leaf = program.leaf((), dtype)
    return program.lower(leaf, [leaf])


def reduce(x, kind: str = "sum") -> torch.Tensor:
    """Full sum/max/min of ``x`` as a 0-d float32 tensor (float32
    accumulation).  Counterpart of ``pallas_reduce``."""
    dispatch.record("reduce", kind)
    return _full(_identity(x.dtype), kind, x.shape, [x])


def reduce_axis(x, kind: str, axis: int) -> torch.Tensor:
    """Sum/max/min of the 2-D ``x`` along ``axis`` as a 1-D float32 tensor.
    Counterpart of ``pallas_reduce_axis``."""
    dispatch.record("reduce_axis", f"{kind}{axis}")
    return _axis(_identity(x.dtype), kind, axis, x.shape, [x])


def dot1d(a, b) -> torch.Tensor:
    """The 1-D dot of ``a`` and ``b`` in one pass, the product never
    stored: a 0-d float32 tensor, or int32 wrapping mod 2**32 when the
    product is int32.  Counterpart of ``pallas_dot1d``."""
    dispatch.record("dot1d")
    if len(a.shape) != 1 or tuple(a.shape) != tuple(b.shape):
        raise ValueError(f"dot1d takes two 1-D operands of one length, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    la, lb = program.leaf(tuple(a.shape), a.dtype), program.leaf(tuple(b.shape), b.dtype)
    prog = program.lower(program.apply("multiply", la, lb), [la, lb])
    return _full(prog, "sum", a.shape, [a, b], int_acc=prog.dtype == torch.int32)


def map_reduce(prog: program.Program, kind: str, out_shape, *operands) -> torch.Tensor:
    """Sum/max/min of the expression ``prog`` over broadcast ``operands``
    (shape ``out_shape``) as a 0-d float32 tensor, in one pass.
    Counterpart of ``pallas_map_reduce``."""
    dispatch.record("reduce_fused", kind)
    return _full(prog, kind, out_shape, operands)


def map_reduce_axis(prog: program.Program, kind: str, axis: int, out_shape,
                    *operands) -> torch.Tensor:
    """Sum/max/min along ``axis`` of the 2-D expression ``prog`` over
    (1|R, 1|C) ``operands`` as a 1-D float32 tensor, in one pass.
    Counterpart of ``pallas_map_reduce_axis``."""
    dispatch.record("reduce_axis", f"{kind}{axis}")
    return _axis(prog, kind, axis, out_shape, operands)


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
