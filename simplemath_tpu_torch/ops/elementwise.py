"""The wrapper of the hand-written elementwise kernel.

Counterpart of ``simplemath_tpu/ops/elementwise.py::pallas_elementwise``
and its two Pallas kernels, ``_build_call_1d`` (flat) and ``_build_call``
(N-D, broadcast dims pinned, view operands through ``ViewPlan``).  On the
card both become one CUDA kernel with two entry points
(csrc/elementwise.cu): ``ew_flat`` when every operand is contiguous and
full-size or a single element, ``ew_strided`` otherwise, each operand then
read in place through a base pointer, an element offset and signed strides
(stride 0 broadcasts; a negative stride reads a negative-step view, which
torch itself cannot represent).

``ew_strided`` runs a kernel written for its program and compiled at run
time (ops/codegen.py), whatever the program: on an H100 that kernel is
faster than interpreting the program per element at every length measured,
one instruction included.  The compiled interpreter of csrc/elementwise.cu
stays as ``interpret``, the reference the card tests and chip_smoke.py hold
the generated kernels to, bit for bit; nothing in the package calls it.

``ew_flat`` reads whole quads of four elements where every full-size
operand and the output allow it: a 4-byte type at a 16-byte boundary (one
16-byte load), a 2-byte type (bfloat16) at an 8-byte one (one 8-byte load,
widened in registers, and the result packed into one 8-byte store); else
every element on its own.  A program of one instruction (every eager op)
runs the compiled ``ew_flat``, its opcode chosen once per thread; any
other program a kernel generated for it (ops/codegen.py, kind ``"flat"``),
which takes the quads, the ``n % 4`` tail and the unaligned operands alike,
so that no launch interprets a program but ``interpret``'s.  ``flat_path``
decides, on the host, from the program, the shape and the operands'
layouts.

``elementwise`` looks at the operands' device.  CPU tensors take the
kernel's plain version, ``program.run_plain``.  CUDA tensors launch the
kernel or raise: there is no fallback.  Two exceptions, both asked for by
the caller: inside ``utils.debug.interpret_kernels()``
(``dispatch.INTERPRET``) CUDA tensors take the plain version too,
counted as ``interpret:elementwise``; while a graph is traced
(``library.tracing``) a call the kernel takes goes through
``sm::ew_flat``/``sm::ew_strided`` (ops/library.py), whose CUDA
implementation is ``_launch``.  ``LAUNCHES`` counts kernel
launches by entry point, ``PATHS`` the launches of ``ew_strided``'s two
kernels, ``"generated"`` and ``"interp"``, and ``FLAT_PATHS`` those of
``ew_flat`` by ``flat_path``: ``"wide"`` and ``"element"`` (the compiled
kernel, one instruction) and ``"generated"``; only a launch adds to them.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Tuple

import numpy as np
import torch

from .. import dtypes as _dtypes
from ..broadcast import broadcast_shapes
from ..config import config
from ..viewspec import row_major_strides
from . import codegen, dispatch, library, program

# Kernel launches by entry point since the last reset, the launches of
# ew_strided's generated kernels and of its interpreter, and ew_flat's by
# path (flat_path).
LAUNCHES = {"ew_flat": 0, "ew_strided": 0}
PATHS = {"interp": 0, "generated": 0}
FLAT_PATHS = {"wide": 0, "element": 0, "generated": 0}

_MAX_RANK = 8
# enum SmDtype (csrc/tiles.cuh).  This kernel's operands are float32,
# bfloat16, int32, uint32 and bool (dtypes.KERNEL_DTYPES); int8 and uint8
# are the matmul kernel's (ops/matmul.py), float16 the reductions'.
_DTYPE_CODE = {torch.float32: 0, torch.int32: 1, torch.bool: 2,
               torch.bfloat16: 3, torch.int8: 4, torch.uint8: 5, torch.uint32: 7,
               torch.float16: 8}


def reset_launches() -> None:
    for counts in (LAUNCHES, PATHS, FLAT_PATHS):
        for k in counts:
            counts[k] = 0


@dataclasses.dataclass(frozen=True)
class View:
    """An operand read in place: ``base`` (a contiguous tensor), the element
    ``offset`` of the view's first element, its ``shape`` and its signed
    element ``strides``."""

    base: torch.Tensor
    offset: int
    shape: Tuple[int, ...]
    strides: Tuple[int, ...]

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def device(self):
        return self.base.device


def read(x) -> torch.Tensor:
    """An operand as a tensor (the plain path's view of it)."""
    if not isinstance(x, View):
        return x
    off, strides, flip = x.offset, list(x.strides), []
    for d, (n, s) in enumerate(zip(x.shape, x.strides)):
        if s < 0 and n > 0:
            off += s * (n - 1)
            strides[d] = -s
            flip.append(d)
    t = torch.as_strided(x.base, x.shape, strides, x.base.storage_offset() + off)
    return torch.flip(t, flip) if flip else t


def supported(out_shape, dtypes_in, out_dtype) -> bool:
    """Whether the kernel takes this signature."""
    if len(out_shape) == 0 or math.prod(out_shape) == 0:
        return False
    return all(dt in _dtypes.KERNEL_DTYPES for dt in list(dtypes_in) + [out_dtype])


# ------------------------------------------------------------ C interface
class _Inst(ctypes.Structure):
    _fields_ = [(f, ctypes.c_uint8) for f in
                ("op", "dst", "a", "b", "c", "rnd", "pad1", "pad2")]


class _Operand(ctypes.Structure):
    _fields_ = [
        ("ptr", ctypes.c_void_p),
        ("strides", ctypes.c_int64 * _MAX_RANK),
        ("dtype", ctypes.c_int32),
        ("scalar", ctypes.c_int32),
    ]


class _Params(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64),
        ("shape", ctypes.c_int64 * _MAX_RANK),
        ("rank", ctypes.c_int32),
        ("n_ops", ctypes.c_int32),
        ("n_consts", ctypes.c_int32),
        ("n_insts", ctypes.c_int32),
        ("out_dtype", ctypes.c_int32),
        ("result", ctypes.c_int32),
        ("iterations", ctypes.c_int32),
        ("carry", ctypes.c_int32),
        ("vec", ctypes.c_int32),
        ("pad", ctypes.c_int32),
        ("consts", ctypes.c_uint32 * program.MAX_CONSTS),
        ("insts", _Inst * program.MAX_INSTS),
        ("ops", _Operand * program.MAX_OPERANDS),
    ]


def _const_bits(value, dtype) -> int:
    """A constant's register bits: a float32 value's, a bfloat16 or float16
    one's widened to float32 (rounded as torch rounds a Python float to
    the type), an integer's mod 2**32.  Host arithmetic alone: a traced
    call records nothing for it and reads no tensor's value."""
    if not dtype.is_floating_point:
        return int(value) & 0xFFFFFFFF
    with np.errstate(over="ignore"):
        x = np.float32(value)
        if dtype == torch.float16:
            x = x.astype(np.float16).astype(np.float32)
    bits = int(x.view(np.uint32))
    if dtype == torch.bfloat16:  # to nearest even, a NaN to the quiet one
        bits = 0x7FC00000 if np.isnan(x) else (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16 << 16
    return bits


def _is_full(shape, strides, out_shape) -> bool:
    if tuple(shape) != tuple(out_shape):
        return False
    want = row_major_strides(out_shape)
    return all(n == 1 or s == w for n, s, w in zip(shape, strides, want))


def _describe(x):
    """(base tensor, element offset, shape, strides) of an operand."""
    if isinstance(x, View):
        return x.base, x.offset, tuple(x.shape), tuple(x.strides)
    return x, 0, tuple(x.shape), tuple(x.stride())


def layout(operands) -> tuple:
    """Each operand's (shape, element strides, dtype, address of its first
    element): what ``flat_path`` and ``reduction.path`` look at."""
    out = []
    for o in operands:
        buf, off, shape, strides = _describe(o)
        out.append((shape, strides, buf.dtype, buf.data_ptr() + off * buf.element_size()))
    return tuple(out)


def quad_aligned(dtype, address) -> bool:
    """Whether the kernels can read quads of four ``dtype`` elements from
    ``address`` with one load each: a 4-byte type at a 16-byte boundary, a
    2-byte type at an 8-byte one."""
    return dtype.itemsize in (2, 4) and address % (4 * dtype.itemsize) == 0


def _flat(shape, strides, out_shape) -> bool:
    return math.prod(shape) == 1 or _is_full(shape, strides, out_shape)


def single(prog, iterations=1) -> bool:
    """Whether ``prog`` is one instruction whose result is the program's,
    run once: what the compiled ``ew_flat`` takes (csrc/elementwise.cu,
    ``flat_is_single``)."""
    return (len(prog.insts) == 1 and iterations == 1
            and prog.result == len(prog.leaf_dtypes) + len(prog.consts))


def quads(prog, operand_layout) -> bool:
    """Whether a flat call reads whole quads, each operand at its own
    width: every full-size operand and the result 4 or 2 bytes wide and
    quad-aligned (``quad_aligned``; the result, new, always is)."""
    return quad_aligned(prog.dtype, 0) and all(
        math.prod(s) == 1 or quad_aligned(dt, address) for s, _, dt, address in operand_layout)


def flat_path(prog, out_shape, operand_layout, iterations=1):
    """How ``ew_flat`` evaluates a call, a pure function of the program, the
    shape, ``layout(operands)`` and the iterations: for a program of one
    instruction (``single``) the compiled kernel, ``"wide"`` (whole quads,
    ``quads``) or ``"element"`` (every element on its own: an unaligned
    operand, a bool one or a bool result); for any other program
    ``"generated"``, the kernel generated for it, on quads where ``quads``
    allows them; None where the call is not flat (an operand neither
    full-size nor one element: ``ew_strided``)."""
    out_shape = tuple(out_shape)
    if not all(_flat(s, st, out_shape) for s, st, _, _ in operand_layout):
        return None
    if not single(prog, iterations):
        return "generated"
    return "wide" if quads(prog, operand_layout) else "element"


@functools.lru_cache(maxsize=256)
def _template(prog, codes, out_shape, layout, iterations, carry):
    """(parameter block without pointers, flat?) for one call signature;
    ``layout`` is each operand's (shape, strides, dtype)."""
    flat = all(_flat(s, st, out_shape) for s, st, _ in layout)
    rank = len(out_shape)
    if not flat and rank > _MAX_RANK:
        raise ValueError(f"the strided kernel takes rank <= {_MAX_RANK}, got {rank}")
    p = _Params()
    p.n = math.prod(out_shape)
    for d, s in enumerate(out_shape):
        p.shape[d] = s
    p.rank = rank
    p.n_ops = len(layout)
    p.n_consts = len(prog.consts)
    p.n_insts = len(prog.insts)
    p.out_dtype = _DTYPE_CODE[prog.dtype]
    p.result = prog.result
    p.iterations = iterations
    p.carry = carry if iterations > 1 else -1
    for j, (v, dt) in enumerate(prog.consts):
        p.consts[j] = _const_bits(v, dt)
    base = len(layout) + len(prog.consts)
    for k, (code, rnd, inst) in enumerate(zip(codes, prog.kernel_rounds, prog.insts)):
        a, b, c = (max(r, 0) for r in inst[3:])
        p.insts[k].op, p.insts[k].dst, p.insts[k].rnd = code, base + k, rnd
        p.insts[k].a, p.insts[k].b, p.insts[k].c = a, b, c
    for o, (shape, strides, dtype) in enumerate(layout):
        p.ops[o].dtype = _DTYPE_CODE[dtype]
        p.ops[o].scalar = int(math.prod(shape) == 1)
        pad = rank - len(shape)
        for d in range(rank):
            if d >= pad and shape[d - pad] != 1:
                p.ops[o].strides[d] = strides[d - pad]
    return bytes(p), flat


@functools.lru_cache(maxsize=None)
def _library():
    """The built kernel library, its parameter layout checked once."""
    from .. import _build

    lib = _build.library()
    if lib.sm_ew_params_size() != ctypes.sizeof(_Params):
        raise RuntimeError("kernel parameter layout does not match its binding")
    return lib


def params(prog, codes, out_shape, operands, iterations=1, carry=0):
    """The parameter block of one call, operand pointers set, and
    ``flat_path`` of the call (None: not flat).  ``params.vec`` says
    whether ``ew_flat`` reads whole quads (``quads``)."""
    where = layout(operands)
    raw, _ = _template(prog, codes, out_shape, tuple((s, st, dt) for s, st, dt, _ in where),
                       iterations, carry)
    p = _Params.from_buffer_copy(raw)
    for o, (_, _, _, address) in enumerate(where):
        p.ops[o].ptr = address
    taken = flat_path(prog, out_shape, where, iterations)
    p.vec = int(taken is not None and quads(prog, where))
    return p, taken


def check_program(prog, name, types=_dtypes.KERNEL_DTYPES):
    """The opcodes of ``prog``, or ValueError when the kernels do not take
    it: its operands and result must be of ``types`` (the elementwise
    kernel's by default; the reductions read float16 too)."""
    codes = prog.kernel_codes
    if codes is None or not set(prog.leaf_dtypes) | {prog.dtype} <= types:
        raise ValueError(
            f"the kernels do not take {name!r} with dtypes "
            f"{[_dtypes.name(d) for d in prog.leaf_dtypes]} -> {_dtypes.name(prog.dtype)}"
        )
    if not prog.within_limits():
        raise ValueError(
            f"program of {len(prog.leaf_dtypes)} operands, {len(prog.consts)} "
            f"constants and {len(prog.insts)} instructions exceeds the kernel's "
            f"limits ({program.MAX_OPERANDS}, {program.MAX_CONSTS}, {program.MAX_INSTS})"
        )
    return codes


def _launch(prog, codes, out_shape, operands, iterations, carry, device, interpreted=False):
    lib = _library()
    out = torch.empty(out_shape, dtype=prog.dtype, device=device)
    if out.numel() == 0:
        return out
    p, flat_taken = params(prog, codes, out_shape, operands, iterations, carry)
    flat = flat_taken is not None and not interpreted
    taken = None if flat else "interp" if interpreted else "generated"
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if flat and flat_taken == "generated":
            sig = signature(prog, codes, out_shape, operands, iterations, carry, flat=True)
            handle = codegen.kernel(lib, sig)
            rc = lib.sm_ew_launch_flat_kernel(handle, ctypes.byref(p), out.data_ptr(),
                                              codegen.resident(sig), stream)
        elif taken == "generated":
            sig = signature(prog, codes, out_shape, operands, iterations, carry)
            rc = lib.sm_ew_launch_kernel(codegen.kernel(lib, sig), ctypes.byref(p),
                                         out.data_ptr(), stream)
        else:
            rc = lib.sm_ew_launch(ctypes.byref(p), out.data_ptr(), int(not flat), stream)
    entry = "ew_flat" if flat else "ew_strided"
    if rc != 0:
        raise RuntimeError(f"{entry} ({taken or 'flat'}) launch failed: cudaError {rc}")
    LAUNCHES[entry] += 1
    if taken:
        PATHS[taken] += 1
    else:
        FLAT_PATHS[flat_taken] += 1
    return out


def signature(prog, codes, out_shape, operands, iterations=1, carry=0,
              flat=False) -> codegen.Signature:
    """The signature of the kernel generated for this call (``codes``:
    ``prog.kernel_codes``): the program, the operands' types, the rank, the
    carry; never the shape, the strides or the constants' values.  With
    ``flat``, ``ew_flat``'s (kind ``"flat"``): no rank, and which operands
    are one element."""
    return _signature(prog, codes, tuple(out_shape),
                      tuple((s, st, dt) for s, st, dt, _ in layout(operands)),
                      iterations, carry, flat)


@functools.lru_cache(maxsize=256)
def _signature(prog, codes, out_shape, where, iterations, carry, flat):
    """``signature`` of operands of (shape, strides, dtype) ``where``: a
    launch's host work, so kept as ``_template`` keeps its block."""
    return codegen.signature(
        prog, codes, [_DTYPE_CODE[dt] for _, _, dt in where], _DTYPE_CODE[prog.dtype],
        1 if flat else len(out_shape), iterations, carry,
        codegen.narrow(math.prod(out_shape), [(s, st) for s, st, _ in where]),
        kind="flat" if flat else "strided",
        scalars=[math.prod(s) == 1 for s, _, _ in where] if flat else ())


def operand_device(prog, out_shape, operands) -> torch.device:
    """The one device of ``operands`` (``config.device`` when there are
    none), after checking that they are what ``prog`` reads and broadcast
    to ``out_shape``."""
    if len(operands) != len(prog.leaf_dtypes):
        raise ValueError(
            f"program takes {len(prog.leaf_dtypes)} operands, got {len(operands)}"
        )
    for o, dt in zip(operands, prog.leaf_dtypes):
        if o.dtype != dt:
            raise ValueError(f"program reads {dt} where the operand is {o.dtype}")
        if broadcast_shapes(tuple(o.shape), out_shape).result_shape != out_shape:
            raise ValueError(
                f"operand of shape {tuple(o.shape)} does not broadcast to {out_shape}"
            )
    devices = {o.device for o in operands}
    if len(devices) > 1:
        raise ValueError(f"operands are on different devices: {sorted(map(str, devices))}")
    return devices.pop() if devices else torch.device(config.device)


def elementwise(prog: program.Program, out_shape, out_dtype, *operands,
                name="op", donate=None, iterations=1, carry=0) -> torch.Tensor:
    """Run ``prog`` over broadcast operands with the elementwise kernel.

    ``operands`` are tensors or ``View``s whose shapes broadcast to
    ``out_shape``.  ``iterations=L`` (with ``carry=i``) applies the program
    L times inside ONE launch, feeding each result back as operand ``i``,
    which must match the output's shape and dtype.  ``donate=i`` declares
    operand ``i`` (same shape and dtype as the output) dead after the call;
    the result is still a new tensor, so an operand is never written."""
    out_shape = tuple(int(s) for s in out_shape)
    if out_dtype != prog.dtype:
        raise ValueError(f"program writes {prog.dtype}, not {out_dtype}")
    device = operand_device(prog, out_shape, operands)
    for what, i in (("donated", donate), ("iterated elementwise carry", carry if iterations != 1 else None)):
        if i is None:
            continue
        o = operands[i]
        if tuple(o.shape) != out_shape or o.dtype != out_dtype:
            raise ValueError(
                f"{what} operand {i} must match the output shape/dtype; got "
                f"{tuple(o.shape)}/{o.dtype} vs {out_shape}/{out_dtype}"
            )
    dispatch.record("elementwise", name)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the elementwise kernel runs on CUDA tensors, not {device}")
    plain = device.type == "cpu" or dispatch.INTERPRET.get()
    if device.type == "cuda" and plain:
        dispatch.record("interpret", "elementwise")
    elif operands and library.tracing(operands) and (device.type == "cuda" or takes(prog, name)):
        check_program(prog, name)
        flat = all(_flat(s, st, out_shape) for _, _, s, st in map(_describe, operands))
        return library.call_elementwise(prog, out_shape, operands, flat, iterations, carry)
    if plain:
        return program.run_plain(
            prog, [read(o) for o in operands], out_shape, iterations, carry, device
        )
    codes = check_program(prog, name)
    return _launch(prog, codes, out_shape, operands, iterations, carry, device)


def takes(prog, name, types=_dtypes.KERNEL_DTYPES) -> bool:
    """Whether the kernels take ``prog`` (``check_program`` passes)."""
    try:
        check_program(prog, name, types)
    except ValueError:
        return False
    return True


def interpret(prog: program.Program, out_shape, *operands, iterations=1, carry=0) -> torch.Tensor:
    """``prog`` over ``operands`` as ``elementwise`` runs it, but on CUDA
    tensors through ``ew_strided``'s interpreter, whatever the operands'
    layout: the reference of the generated kernels.  CPU tensors take the
    plain version."""
    out_shape = tuple(int(s) for s in out_shape)
    device = operand_device(prog, out_shape, operands)
    if device.type == "cpu":
        return program.run_plain(
            prog, [read(o) for o in operands], out_shape, iterations, carry, device
        )
    if len(out_shape) > _MAX_RANK:
        raise ValueError(f"the interpreter takes rank <= {_MAX_RANK}, got {len(out_shape)}")
    codes = check_program(prog, "interpret")
    return _launch(prog, codes, out_shape, operands, iterations, carry, device, interpreted=True)
