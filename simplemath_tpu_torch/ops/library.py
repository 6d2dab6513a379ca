"""The hand-written kernels as ``torch.library`` custom ops.

The kernels are reached through ``ctypes`` with raw pointers, which
``torch.export`` cannot trace.  Each of the seven entry points is therefore
also an op of the ``sm`` namespace, with a CUDA implementation that is its
wrapper's ``_launch`` (the hand kernel, counted in its ``LAUNCHES``), a CPU
implementation that is its plain version, and a fake implementation that
gives the result's shape and dtype:

* ``sm::ew_flat``, ``sm::ew_strided`` (ops/elementwise.py; which one a call
  takes follows from the operands' shapes and strides, as ``_launch``
  decides it);
* ``sm::rd_full``, ``sm::rd_axis`` (ops/reduction.py);
* ``sm::mm``, ``sm::bmm`` (ops/matmul.py; a rank-2 or rank-3 product).
* ``sm::psd_project`` (ops/linalg_small.py; the solvers' PSD projection of
  matrices with any leading dims).

The program and the launch parameters are op arguments, as lists of ints
(``encode_program``, ``encode_views``), so an exported graph names the
kernel and its program, and a loaded graph launches that same kernel
(``ew_strided`` compiles its generated kernel there, or reads its CUBIN
from the cache).  Loading such a graph needs ``import
simplemath_tpu_torch``, which registers the ops.

The wrappers call an op only while a graph is being traced (``tracing``:
fake tensors, or a proxy or fake mode active); an eager call takes
``_launch`` or the plain version directly, so the op dispatcher adds
nothing to its host time.  Both routes end in the same ``_launch``.
"""

from __future__ import annotations

import functools
import struct
from typing import List

import torch
from torch._subclasses.fake_tensor import FakeTensor

from . import program

# Type codes of the encoding (never reordered; new types go at the end).
DTYPES = (torch.float32, torch.int32, torch.bool, torch.bfloat16, torch.int8, torch.uint8,
          torch.int64, torch.uint32, torch.float16, torch.uint64)
_DTYPE_INDEX = {dt: i for i, dt in enumerate(DTYPES)}
# Op codes of the encoding: "cast" and every op that has a kernel opcode
# (never reordered; new ops go at the end).
PROGRAM_OPS = ("cast", "add", "subtract", "multiply", "divide", "floor_divide", "remainder",
               "maximum", "minimum", "equal", "not_equal", "less", "less_equal", "greater",
               "greater_equal", "negative", "abs", "sqrt", "square", "sin", "cos", "tan",
               "tanh", "sign", "where", "exp", "log", "exp2", "log2", "pow", "ipow")
_OP_INDEX = {name: i for i, name in enumerate(PROGRAM_OPS)}
_KINDS = ("sum", "max", "min", "sum")  # by reduction op code (3: the int32 sum)

_PROXY = torch._C._TorchDispatchModeKey.PROXY
_FAKE = torch._C._TorchDispatchModeKey.FAKE


def tracing(tensors=()) -> bool:
    """Whether a graph is being traced: a proxy or fake mode is active
    (``make_fx``, ``torch.export``), or an operand is a fake tensor."""
    if torch._C._get_dispatch_mode(_PROXY) is not None or \
            torch._C._get_dispatch_mode(_FAKE) is not None:
        return True
    return any(isinstance(getattr(t, "base", t), FakeTensor) for t in tensors)


# ------------------------------------------------------------- encoding
def _const_value(bits: int, dtype):
    if dtype.is_floating_point:
        return struct.unpack("<f", struct.pack("<I", bits))[0]
    if dtype == torch.bool:
        return bool(bits)
    if dtype == torch.int32:
        return bits - (1 << 32) if bits >= 1 << 31 else bits
    return bits


def encode_program(prog: program.Program) -> List[int]:
    """``prog`` as a list of ints: its operand types, its constants (type
    and register bits), its instructions (op, compute type, type and three
    registers), its result register and type.  ValueError for an op the
    encoding has no code for."""
    from .elementwise import _const_bits

    out = [len(prog.leaf_dtypes), *(_DTYPE_INDEX[dt] for dt in prog.leaf_dtypes),
           len(prog.consts)]
    for value, dt in prog.consts:
        out += [_DTYPE_INDEX[dt], _const_bits(value, dt)]
    out.append(len(prog.insts))
    for op, ctype, dtype, a, b, c in prog.insts:
        if op not in _OP_INDEX:
            raise ValueError(f"op {op!r} has no code in the sm ops' program encoding")
        out += [_OP_INDEX[op], _DTYPE_INDEX[ctype], _DTYPE_INDEX[dtype], a, b, c]
    return out + [prog.result, _DTYPE_INDEX[prog.dtype]]


@functools.lru_cache(maxsize=512)
def _decode(code: tuple) -> program.Program:
    it = iter(code)
    leaves = tuple(DTYPES[next(it)] for _ in range(next(it)))
    consts = []
    for _ in range(next(it)):
        dt = DTYPES[next(it)]
        consts.append((_const_value(next(it), dt), dt))
    insts = []
    for _ in range(next(it)):
        op, ct, dt, a, b, c = (next(it) for _ in range(6))
        insts.append((PROGRAM_OPS[op], DTYPES[ct], DTYPES[dt], a, b, c))
    result, dtype = next(it), DTYPES[next(it)]
    return program.Program(leaf_dtypes=leaves, consts=tuple(consts), insts=tuple(insts),
                           result=result, dtype=dtype)


def decode_program(code) -> program.Program:
    """The ``Program`` that ``encode_program`` encoded."""
    return _decode(tuple(code))


def encode_views(operands) -> List[int]:
    """Each operand's element offset, rank, shape and strides, in order."""
    from .elementwise import _describe

    out = []
    for o in operands:
        _, off, shape, strides = _describe(o)
        out += [off, len(shape), *shape, *strides]
    return out


def bases(operands) -> List[torch.Tensor]:
    """The tensors ``encode_views`` describes: each view's base."""
    from .elementwise import _describe

    return [_describe(o)[0] for o in operands]


def views(tensors, code) -> list:
    """``elementwise.View``s of ``tensors`` from ``encode_views``' ints."""
    from .elementwise import View

    out, i = [], 0
    for t in tensors:
        off, rank = code[i], code[i + 1]
        shape, strides = tuple(code[i + 2:i + 2 + rank]), tuple(code[i + 2 + rank:i + 2 + 2 * rank])
        out.append(View(t, off, shape, strides))
        i += 2 + 2 * rank
    return out


# ------------------------------------------------------ the elementwise ops
def _ew_plain(operands, code, out_shape, view_code, iterations, carry):
    from .elementwise import read

    prog = decode_program(code)
    ops = [read(v) for v in views(operands, view_code)]
    return program.run_plain(prog, ops, tuple(out_shape), iterations, carry, operands[0].device)


def _ew_kernel(operands, code, out_shape, view_code, iterations, carry):
    from . import elementwise

    prog = decode_program(code)
    codes = elementwise.check_program(prog, "sm op")
    return elementwise._launch(prog, codes, tuple(out_shape), views(operands, view_code),
                               iterations, carry, operands[0].device)


def _ew_fake(operands, code, out_shape, view_code, iterations, carry):
    return torch.empty(tuple(out_shape), dtype=DTYPES[code[-1]], device=operands[0].device)


def _define_ew(name):
    @torch.library.custom_op(f"sm::{name}", mutates_args=(), device_types="cpu")
    def op(operands: List[torch.Tensor], program: List[int], out_shape: List[int],
           views: List[int], iterations: int, carry: int) -> torch.Tensor:
        return _ew_plain(operands, program, out_shape, views, iterations, carry)

    op.register_kernel("cuda")(_ew_kernel)
    op.register_fake(_ew_fake)
    return op


ew_flat = _define_ew("ew_flat")
ew_strided = _define_ew("ew_strided")


# -------------------------------------------------------- the reduction ops
def _rd_plain(operands, code, shape, view_code, op, axis):
    from . import reduction

    prog = decode_program(code)
    vals = reduction.values(prog, tuple(shape), views(operands, view_code), operands[0].device)
    if op == reduction._SUM_I32:
        return reduction._plain_sum_i32(vals, axis)
    return reduction._plain(vals, _KINDS[op], axis)


def _rd_kernel(operands, code, shape, view_code, op, axis):
    from . import reduction

    return reduction._launch("rd_full" if axis is None else "rd_axis", decode_program(code),
                             _KINDS[op], op, tuple(shape), views(operands, view_code),
                             operands[0].device, axis)


def _rd_dtype(op):
    return torch.int32 if op == 3 else torch.float32


@torch.library.custom_op("sm::rd_full", mutates_args=(), device_types="cpu")
def rd_full(operands: List[torch.Tensor], program: List[int], shape: List[int],
            views: List[int], op: int) -> torch.Tensor:
    return _rd_plain(operands, program, shape, views, op, None)


@rd_full.register_kernel("cuda")
def _(operands, program, shape, views, op):
    return _rd_kernel(operands, program, shape, views, op, None)


@rd_full.register_fake
def _(operands, program, shape, views, op):
    return torch.empty((), dtype=_rd_dtype(op), device=operands[0].device)


@torch.library.custom_op("sm::rd_axis", mutates_args=(), device_types="cpu")
def rd_axis(operands: List[torch.Tensor], program: List[int], shape: List[int],
            views: List[int], op: int, axis: int) -> torch.Tensor:
    return _rd_plain(operands, program, shape, views, op, axis)


@rd_axis.register_kernel("cuda")
def _(operands, program, shape, views, op, axis):
    return _rd_kernel(operands, program, shape, views, op, axis)


@rd_axis.register_fake
def _(operands, program, shape, views, op, axis):
    n = shape[1] if axis == 0 else shape[0]
    return torch.empty((n,), dtype=_rd_dtype(op), device=operands[0].device)


# ----------------------------------------------------------- the matmul ops
def _mm_args(a, b, extras, view_code, epilogue):
    va, vb, *ve = views([a, b, *extras], view_code)
    return va, vb, ve, (decode_program(epilogue) if epilogue else None)


def _mm_plain(a, b, extras, view_code, epilogue, out_dtype):
    from . import matmul

    va, vb, ve, epi = _mm_args(a, b, extras, view_code, epilogue)
    return matmul.matmul_plain(va, vb, DTYPES[out_dtype], epi, ve)


def _mm_kernel(a, b, extras, view_code, epilogue, out_dtype):
    from . import matmul

    va, vb, ve, epi = _mm_args(a, b, extras, view_code, epilogue)
    dims = matmul.product_shape(va.shape, vb.shape)
    return matmul._launch(va, vb, dims, matmul.accumulator(va.dtype, vb.dtype),
                          DTYPES[out_dtype], epi, ve, a.device)


def _mm_fake(a, b, extras, view_code, epilogue, out_dtype):
    from .matmul import product_shape

    va, vb = views([a, b], view_code)
    B, M, N, _ = product_shape(va.shape, vb.shape)
    shape = (B, M, N) if len(va.shape) == 3 else (M, N)
    return torch.empty(shape, dtype=DTYPES[out_dtype], device=a.device)


def _define_mm(name):
    @torch.library.custom_op(f"sm::{name}", mutates_args=(), device_types="cpu")
    def op(a: torch.Tensor, b: torch.Tensor, extras: List[torch.Tensor], views: List[int],
           epilogue: List[int], out_dtype: int) -> torch.Tensor:
        return _mm_plain(a, b, extras, views, epilogue, out_dtype)

    op.register_kernel("cuda")(_mm_kernel)
    op.register_fake(_mm_fake)
    return op


mm = _define_mm("mm")
bmm = _define_mm("bmm")


# -------------------------------------------------------- the wrappers' calls
def call_elementwise(prog, out_shape, operands, flat: bool, iterations: int, carry: int):
    """``prog`` over ``operands`` through ``sm::ew_flat`` or ``sm::ew_strided``."""
    op = ew_flat if flat else ew_strided
    return op(bases(operands), encode_program(prog), list(out_shape), encode_views(operands),
              iterations, carry)


def call_reduction(prog, op: int, shape, operands, axis):
    """A reduction through ``sm::rd_full`` (``axis`` None) or ``sm::rd_axis``."""
    args = (bases(operands), encode_program(prog), list(shape), encode_views(operands), op)
    return rd_full(*args) if axis is None else rd_axis(*args, axis)


def call_matmul(a, b, out_dtype, epilogue, extras):
    """A product through ``sm::mm`` (rank 2) or ``sm::bmm`` (rank 3)."""
    a_base, b_base, *ex = bases([a, b, *extras])
    op = bmm if len(a.shape) == 3 else mm
    return op(a_base, b_base, ex, encode_views([a, b, *extras]),
              encode_program(epilogue) if epilogue is not None else [],
              _DTYPE_INDEX[out_dtype])


def sm_nodes(graph) -> List[str]:
    """The ``sm::*`` ops a ``torch.fx`` graph calls, in order."""
    names = []
    for node in graph.nodes:
        if node.op == "call_function" and str(node.target).startswith("sm."):
            names.append(str(node.target))
    return names



# ------------------------------------------------------ the PSD projection
@torch.library.custom_op("sm::psd_project", mutates_args=(), device_types="cpu")
def psd_project(H: torch.Tensor, eps: float) -> torch.Tensor:
    from .linalg_small import psd_project_plain

    return psd_project_plain(H, eps)


@psd_project.register_kernel("cuda")
def _(H, eps):
    from .linalg_small import _launch

    return _launch(H, eps)


@psd_project.register_fake
def _(H, eps):
    return torch.empty_like(H, memory_format=torch.contiguous_format)


@psd_project.register_vmap
def _(info, in_dims, H, eps):
    # The op takes any leading dims: the batch dim goes to the front.
    dim = in_dims[0]
    if dim is None:
        return psd_project(H, eps), None
    return psd_project(H.movedim(dim, 0), eps), 0
