"""Kernels generated per program and compiled at run time.

The compiled interpreters of the elementwise and map-reduce kernels
(csrc/elementwise.cu, csrc/reduction.cuh) run their program over a register
file in local memory, an instruction fetched and dispatched at a time (for
``ew_strided`` per element, the index decoded rank-deep).  That is most of
their time, for an iterated recurrence above all, and a few times the
bytes' time even for a short chain.  So every launch of a program that
they would interpret runs a kernel that this module writes for the
program, of one of three kinds (``Signature.kind``):

* ``"strided"``: ``ew_strided``, per element, through each operand's strides;
* ``"flat"``: ``ew_flat`` of a program of more than one instruction (or
  iterated): quads of four elements, each full-size operand read at its
  own width (one 16-byte load of a 4-byte type, one 8-byte load of bfloat16
  widened in registers), scalars and constants splatted once before the
  loop, a bfloat16 result rounded on each lane and packed into one 8-byte
  store; the ``n % 4`` tail and operands that allow no quad loads
  (``SmParams.vec`` 0) element by element in the same kernel;
* ``"reduce"``: ``rd_full``/``rd_axis``'s evaluator of a quad, with the
  interface of ``RdLanes4`` (csrc/reduction.cuh), handed to the same walk
  and first-pass kernel as the interpreter (``walk``), so the partials,
  their order and the second launch that combines them are the
  interpreter's, and so are the bits; each operand read at the constant
  width of its type, quads loaded whole or, ``gathered``, element by
  element through the strides;
* ``"matmul"``: a matmul kernel with its epilogue compiled in.  The
  epilogue is ``MmGenerated`` (csrc/matmul.cuh's interface: an extra that
  is one value a block loaded once, one a row once a row, one the same for
  every row once for each group of four columns, the others a quad a
  call), and the kernel is the compiled kernel's own body (``variant``:
  csrc/matmul_wgmma.cuh, matmul_wgmma_s8.cuh or matmul_fma.cuh, at the
  template arguments ``layout``), so the product, the store and the grid
  are the compiled kernel's and the accumulator stays in registers.

In each of them

* the registers are local variables (``r7``, or ``v7`` of four lanes), so
  they live in registers;
* every instruction is ``sm_exec(<OPCODE>, ...)`` of csrc/tiles.cuh with the
  opcode a literal (in ``sm_bf16r`` where its result is bfloat16), so the
  compiler keeps that opcode's code alone and the values are the
  interpreter's, bit for bit;
* the operands are loaded once per element or quad (for ``"strided"`` the
  index decoded once, the rank a constant), in 32-bit arithmetic where
  every offset fits;
* with ``iterations > 1`` the loop runs the instructions and puts the
  result in the carry register, and the compiler may hoist what does not
  depend on the carry;
* the result is stored once (or, ``"reduce"``, handed to the walk as four
  accumulator values).

It is what the TPU kernels do (``simplemath_tpu/ops/elementwise.py::
_build_call_1d`` and ``::_build_call``, ``ops/reduction.py::
_build_map_reduce_1d/_2d`` and ``::_build_reduce_axis``, ``ops/matmul.py::
_build_matmul`` and ``::_build_bmm`` compile a kernel per tile function or
epilogue and cache it on the function's id).  The kernel takes the
interpreter's parameter block (``SmParams``, or ``RdParams`` or
``MmParams`` around it) as a ``__grid_constant__``, so the shape, the strides, the pointers, the
constants' values and the count of iterations are read at run time and are
not part of the code: ``a + 2.0`` and ``a + 3.0`` share a kernel.  What the
code depends on is the ``Signature``.

NVRTC compiles the source (csrc/nvrtc.cu, in the kernel library that
``_build.py`` builds) with the options of the compiled kernels that bear on
the values (``--fmad=false``, no fast math) for ``sm_90a``, and ``-Xptxas
-v``, whose report of registers and spills is kept beside the CUBIN
(``ptxas``), and the runtime loads the CUBIN.  Kernels are cached in the process by signature
(at most ``CAP``; when full, all are unloaded and the cache starts again,
as the reference clears its cache, except the kernels that a live CUDA
graph launches: utils/graphs.py holds a pin of each) and on disk under
``build/kernels/generated/``, named by a hash of the source (which follows
from the signature), the headers it includes and the options.  A compile
or a load that fails raises with NVRTC's log or the runtime's error: the
interpreter is never taken instead.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import tempfile
import time
import weakref
from typing import Tuple

from . import program

KERNEL = "sm_generated"
OPTIONS = ("--gpu-architecture=sm_90a", "--fmad=false", "-std=c++17", "--ptxas-options=-v")
HEADERS = ("tiles.cuh", "program.cuh", "reduction.cuh", "matmul.cuh", "wgmma.cuh",
           "matmul_wgmma.cuh", "matmul_wgmma_s8.cuh", "matmul_fma.cuh")
CAP = 512  # as the reference's _TILE_FN_CAP
# enum SmDtype (csrc/tiles.cuh), by code.
DTYPE_NAMES = ("SM_F32", "SM_I32", "SM_BOOL", "SM_BF16", "SM_I8", "SM_U8", "SM_I64",
               "SM_U32", "SM_F16")
# The matmul kernels that take an epilogue (ops/matmul.py::VARIANTS): the
# header that holds each one's body, the body, and its template arguments
# before the ones ``Signature.layout`` gives.
MATMUL_BODIES = {
    "wgmma_bf16": ("matmul_wgmma.cuh", "mm_wgmma_body", ()),
    "wgmma_s8": ("matmul_wgmma_s8.cuh", "mm_wgmma_s8_body", ()),
    "fma_f32": ("matmul_fma.cuh", "mm_body", ("kF32",)),
    "imad_i32": ("matmul_fma.cuh", "mm_body", ("kI32",)),
}
# enum RdOp (csrc/reduction.cuh), by code.
REDUCE_NAMES = ("RD_SUM", "RD_MAX", "RD_MIN", "RD_SUM_I32")
# Quads a thread of a generated evaluator asks for before it combines them
# (RdLanes4 asks for one; the order of combination is the same).
REDUCE_BATCH = 2
# Largest element count and offset the 32-bit index arithmetic takes: an
# index plus a grid's stride stays below 2**31.
NARROW_LIMIT = (1 << 31) - (1 << 21)

# In this process: NVRTC compiles, CUBINs read from the disk cache, and
# calls served by a kernel already loaded; the milliseconds of each compile.
STATS = {"compiled": 0, "disk": 0, "memory": 0}
COMPILE_MS: list = []
# Every signature whose kernel this process has loaded.
SEEN: set = set()

_LOADED: dict = {}  # Signature -> (library handle, kernel handle, resident blocks)


class _Pin:
    """Held by each CUDA graph that launches a signature's kernel (see
    ``kernel``): while one lives, ``_evict`` leaves the module loaded."""

    __slots__ = ("__weakref__",)


_PINS: "weakref.WeakValueDictionary[Signature, _Pin]" = weakref.WeakValueDictionary()


@dataclasses.dataclass(frozen=True)
class Signature:
    """What a generated kernel's code depends on.  ``insts`` are
    ``(opcode, dst, a, b, c)`` with -1 for a source the instruction does not
    read; ``rounds`` says which instructions round their result to bfloat16;
    ``operands`` the operands' dtype codes; ``carry`` is -1 unless
    ``iterated``; ``narrow`` says every index and offset fits 32 bits.
    ``kind`` is ``"strided"``, ``"flat"``, ``"reduce"`` or ``"matmul"``
    (the module's docstring); for ``"flat"`` and ``"reduce"`` ``scalars``
    marks the one-element operands, loaded once; ``"reduce"`` adds the
    reduction (``reduce``, a code of ``REDUCE_NAMES``), the ``walk`` and
    whether the operands are ``gathered`` element by element; ``"matmul"``
    the kernel (``variant``, a key of ``MATMUL_BODIES``), its template
    arguments (``layout``: the operands' staging orders, signedness and
    ways in, or element path; bools and ints) and, for each operand, the dims of (m, n) along which it
    ``varies`` (``"mn"``, ``"m"``, ``"n"`` or ``""``; operand 0 is the
    accumulator); ``out_dtype`` is then the stored type."""

    insts: Tuple[Tuple[int, int, int, int, int], ...]
    rounds: Tuple[bool, ...]
    operands: Tuple[int, ...]
    n_consts: int
    result: int
    carry: int
    iterated: bool
    rank: int
    out_dtype: int
    narrow: bool
    kind: str = "strided"
    scalars: Tuple[bool, ...] = ()
    reduce: int = -1
    walk: str = ""
    gathered: bool = False
    variant: str = ""
    layout: Tuple[int, ...] = ()
    varies: Tuple[str, ...] = ()


def signature(prog, codes, operand_dtypes, out_dtype, rank, iterations, carry,
              narrow, kind="strided", scalars=(), reduce=-1, walk="",
              gathered=False, variant="", layout=(), varies=()) -> Signature:
    """The signature of ``prog`` (with its kernel ``codes``) over operands
    of dtype codes ``operand_dtypes``, writing ``out_dtype`` (a code) at
    ``rank``; the rest as ``Signature`` has them."""
    base = len(prog.leaf_dtypes) + len(prog.consts)
    insts = tuple((code, base + k, *inst[3:]) for k, (code, inst) in enumerate(zip(codes, prog.insts)))
    iterated = iterations > 1
    return Signature(
        insts=insts,
        rounds=prog.kernel_rounds,
        operands=tuple(operand_dtypes),
        n_consts=len(prog.consts),
        result=prog.result,
        carry=carry if iterated else -1,
        iterated=iterated,
        rank=rank,
        out_dtype=out_dtype,
        narrow=narrow,
        kind=kind,
        scalars=tuple(bool(x) for x in scalars),
        reduce=reduce,
        walk=walk,
        gathered=gathered,
        variant=variant,
        layout=tuple(layout),
        varies=tuple(varies),
    )


def narrow(n, layouts) -> bool:
    """Whether ``n`` elements and every operand's reach fit the 32-bit
    arithmetic; ``layouts`` are (shape, strides) of each operand."""
    reach = max((sum(abs(s) * (d - 1) for d, s in zip(shape, strides) if d > 1)
                 for shape, strides in layouts), default=0)
    return n < NARROW_LIMIT and reach < NARROW_LIMIT


def source(sig: Signature) -> str:
    """The CUDA source of the kernel for ``sig``."""
    if sig.kind == "flat":
        return _flat_source(sig)
    if sig.kind == "reduce":
        return _reduce_source(sig)
    if sig.kind == "matmul":
        return _matmul_source(sig)
    return _strided_source(sig)


def _dtype(code) -> str:
    return DTYPE_NAMES[code]


def _two_byte(code) -> bool:
    return DTYPE_NAMES[code] in ("SM_BF16", "SM_F16")


def _body(sig: Signature, reg: str, pad: str, zero: str, quads: bool) -> list:
    """The instructions of ``sig``, each ``sm_exec`` (of each lane with
    ``quads``) with its opcode a literal, a bfloat16 result rounded
    (``sm_bf16r``, on each lane ``sm_bf16r4``), into registers named
    ``reg`` + number; a source the instruction does not read is ``zero``."""
    out = []
    typ = "uint4" if quads else "uint32_t"
    for (op, dst, *srcs), rnd in zip(sig.insts, sig.rounds):
        args = ", ".join(f"{reg}{r}" if r >= 0 else zero for r in srcs)
        value = f"sm_exec{'_lanes' if quads else ''}({program.OPCODES[op]}, {args})"
        if rnd:
            value = f"sm_bf16r{'4' if quads else ''}({value})"
        out.append(f"{pad}const {typ} {reg}{dst} = {value};")
    return out


def _iterate(sig: Signature, reg: str, pad: str, zero: str, quads: bool) -> list:
    """The program once, or with ``iterated`` its loop over
    ``p.iterations`` that puts each result in the carry register; ``res``
    holds the result."""
    typ = "uint4" if quads else "uint32_t"
    if not sig.iterated:
        return _body(sig, reg, pad, zero, quads) + [f"{pad}const {typ} res = {reg}{sig.result};"]
    return ([f"{pad}{typ} res = {zero};", f"{pad}for (int it = 0; it < p.iterations; ++it) {{"]
            + _body(sig, reg, pad + "  ", zero, quads)
            + [f"{pad}  res = {reg}{sig.result};", f"{pad}  {reg}{sig.carry} = res;", f"{pad}}}"])


def _flat_source(sig: Signature) -> str:
    """``ew_flat``'s kernel for ``sig``: quads while ``p.vec``, then the
    elements left (the tail, or all of them)."""
    idx = "int" if sig.narrow else "long long"
    n_ops = len(sig.operands)
    out = [
        '#include "program.cuh"',
        "",
        f"// Generated for {sig}.",
        f'extern "C" __global__ void __launch_bounds__(256) {KERNEL}(',
        "    const __grid_constant__ SmParams p, void* __restrict__ out) {",
    ]
    for o, (dt, scalar) in enumerate(zip(sig.operands, sig.scalars)):
        if scalar:
            out.append(f"  const uint32_t s{o} = sm_load(p.ops[{o}].ptr, 0, {_dtype(dt)});")
    for j in range(sig.n_consts):
        out.append(f"  const uint32_t s{n_ops + j} = p.consts[{j}];")
    out += [
        f"  const {idx} n = ({idx})p.n, step = ({idx})gridDim.x * blockDim.x;",
        f"  const {idx} t = ({idx})blockIdx.x * blockDim.x + threadIdx.x;",
        f"  {idx} done = 0;",
    ]
    if quads_allowed(sig):
        out += ["  if (p.vec) {", "    const uint4 z = sm_splat(0u);"]
        for j in range(sig.n_consts):
            out.append(f"    const uint4 v{n_ops + j} = sm_splat(s{n_ops + j});")
        out += [f"    const {idx} n4 = n / 4;",
                f"    for ({idx} q = t; q < n4; q += step) {{"]
        for o, (dt, scalar) in enumerate(zip(sig.operands, sig.scalars)):
            if scalar:
                load = f"sm_splat(s{o})"
            elif _two_byte(dt):
                load = f"sm_load_quad2(p.ops[{o}].ptr, q, {_dtype(dt)})"
            else:
                load = f"__ldcs(static_cast<const uint4*>(p.ops[{o}].ptr) + q)"
            out.append(f"      uint4 v{o} = {load};")
        out += _iterate(sig, "v", "      ", "z", True)
        if _two_byte(sig.out_dtype):
            out.append(f"      sm_store_quad(out, q, {_dtype(sig.out_dtype)}, res);")
        else:
            out.append("      static_cast<uint4*>(out)[q] = res;")
        out += ["    }", "    done = n4 * 4;", "  }"]
    out.append(f"  for ({idx} i = done + t; i < n; i += step) {{")
    for o, (dt, scalar) in enumerate(zip(sig.operands, sig.scalars)):
        load = f"s{o}" if scalar else f"sm_load(p.ops[{o}].ptr, i, {_dtype(dt)})"
        out.append(f"    uint32_t r{o} = {load};")
    for j in range(sig.n_consts):
        out.append(f"    const uint32_t r{n_ops + j} = s{n_ops + j};")
    out += _iterate(sig, "r", "    ", "0u", False)
    out += [f"    sm_store(out, i, {_dtype(sig.out_dtype)}, res);", "  }", "}", ""]
    return "\n".join(out)


def quads_allowed(sig: Signature) -> bool:
    """Whether a flat launch of ``sig`` can read whole quads: every
    full-size operand and the result 4 or 2 bytes wide (``SmParams.vec``
    says whether this launch's addresses allow them)."""
    wide = ("SM_F32", "SM_I32", "SM_U32", "SM_BF16")
    return DTYPE_NAMES[sig.out_dtype] in wide and all(
        scalar or DTYPE_NAMES[dt] in wide for dt, scalar in zip(sig.operands, sig.scalars))


def _reduce_load(sig: Signature, o: int) -> list:
    """The body of ``load<o>``: operand o's quad at (i, jq), the first
    ``nvalid`` elements, at the constant width of its type."""
    dt = _dtype(sig.operands[o])
    narrow = "true" if _two_byte(sig.operands[o]) else "false"
    x = f"q.p.ops[{o}]"
    if sig.gathered:
        if sig.walk == "strided":
            return [f"return rd_gather_strided(q.p, {x}, jq, nvalid);"]
        flat = "true" if sig.walk == "flat" else "false"
        return [f"return rd_gather_as<{flat}>({x}, {dt}, i, jq, nvalid);"]
    if sig.walk == "flat":
        return [f"return rd_load_quad<{narrow}>({x}.ptr, 0, jq, nvalid, {dt});"]
    return [f"const int64_t off = i * {x}.strides[0];",
            f"if ({x}.strides[1] == 0) return sm_splat(sm_load({x}.ptr, off, {dt}));",
            f"return rd_load_quad<{narrow}>({x}.ptr, off, jq, nvalid, {dt});"]


def _reduce_source(sig: Signature) -> str:
    """The evaluator of ``sig``'s quads (``RdLanes4``'s interface) and the
    first-pass kernel that hands it to the walk ``sig.walk``."""
    n_ops = len(sig.operands)
    op = REDUCE_NAMES[sig.reduce]
    keeps = sig.walk == "axis0"
    out = [
        '#include "reduction.cuh"',
        "",
        f"// Generated for {sig}.",
        "namespace {",
        "",
        "struct RdGenerated {",
        f"  static constexpr int kBatch = {REDUCE_BATCH};",
        "  const RdParams& q;",
        "  uint32_t kept;",
    ]
    for o, scalar in enumerate(sig.scalars):
        if scalar:
            out.append(f"  uint4 s{o};")
        elif keeps:
            out.append(f"  uint4 k{o};")
    out.append("  __device__ __forceinline__ explicit RdGenerated(const RdParams& q_) : q(q_), kept(0u) {")
    for o, (dt, scalar) in enumerate(zip(sig.operands, sig.scalars)):
        if scalar:
            out.append(f"    s{o} = sm_splat(sm_load(q.p.ops[{o}].ptr, 0, {_dtype(dt)}));")
    out.append("  }")
    for o, scalar in enumerate(sig.scalars):
        if not scalar:
            out.append(f"  __device__ __forceinline__ uint4 load{o}(int64_t i, int64_t jq, int nvalid) const {{")
            out += [f"    {line}" for line in _reduce_load(sig, o)]
            out.append("  }")
    out.append("  __device__ __forceinline__ void keep_column(int64_t jq, int nvalid) {")
    if keeps:
        for o, scalar in enumerate(sig.scalars):
            if not scalar:
                out += [f"    if (q.p.ops[{o}].strides[0] == 0) {{",
                        f"      k{o} = load{o}(0, jq, nvalid);",
                        f"      kept |= 1u << {o};", "    }"]
    out.append("  }")
    out.append("  __device__ __forceinline__ uint4 operator()(int64_t i, int64_t jq, int nvalid) const {")
    out.append("    const uint4 z = sm_splat(0u);")
    for o, scalar in enumerate(sig.scalars):
        if scalar:
            value = f"s{o}"
        elif keeps:
            value = f"(kept >> {o} & 1u) ? k{o} : load{o}(i, jq, nvalid)"
        else:
            value = f"load{o}(i, jq, nvalid)"
        out.append(f"    const uint4 v{o} = {value};")
    for j in range(sig.n_consts):
        out.append(f"    const uint4 v{n_ops + j} = sm_splat(q.p.consts[{j}]);")
    out += _body(sig, "v", "    ", "z", True)
    out += [f"    return rd_value4<{op}>({_dtype(sig.out_dtype)}, v{sig.result});", "  }", "};",
            "", "}  // namespace", "",
            f'extern "C" __global__ void __launch_bounds__(kThreads) {KERNEL}(',
            "    const __grid_constant__ RdParams q, uint32_t* __restrict__ dst) {",
            "  RdGenerated eval(q);"]
    if sig.walk == "axis0":
        out += ["  __shared__ uint4 s[kWarps][32];", f"  RdColsWalk<{op}>{{q, dst, s}}(eval);"]
    elif sig.walk == "axis1":
        out.append(f"  RdRowsWalk<{op}>{{q, dst}}(eval);")
    elif sig.walk == "rows":
        out.append(f"  RdFullWalk<{op}>{{q, dst}}.rows(eval);")
    else:
        out.append(f"  RdFullWalk<{op}>{{q, dst}}(eval);")
    out += ["}", ""]
    return "\n".join(out)


def _matmul_source(sig: Signature) -> str:
    """The matmul kernel of ``sig.variant`` at ``sig.layout`` with
    ``sig``'s epilogue compiled in (``MmGenerated``, csrc/matmul.cuh's
    interface): the accumulator is operand 0, each extra is held in a
    register from where it stops varying (``sig.varies``), and the result
    is stored as ``sig.out_dtype``."""
    header, body, fixed = MATMUL_BODIES[sig.variant]
    n_ops = len(sig.operands)
    held = {"": "the constructor", "m": "row", "n": "columns"}
    out = [
        f'#include "{header}"',
        "",
        f"// Generated for {sig}.",
        "namespace {",
        "",
        "struct MmGenerated {",
        "  static constexpr bool kGenerated = true;",
        f"  static constexpr int32_t kOut = {_dtype(sig.out_dtype)};",
        "  const MmParams& q;",
        "  const int64_t bz;",
    ]
    for o in range(1, n_ops):
        if sig.varies[o] != "mn":
            out.append(f"  uint4 e{o};  // set by {held[sig.varies[o]]}")
    out.append("  __device__ __forceinline__ MmGenerated(const MmParams& q_, int64_t bz_) : q(q_), bz(bz_) {")
    for o in range(1, n_ops):
        if sig.varies[o] == "":
            x = f"q.p.ops[{o}]"
            out.append(f"    e{o} = sm_splat(sm_load({x}.ptr, bz * {x}.strides[0], "
                       f"{_dtype(sig.operands[o])}));")
    out += ["  }", "  __device__ __forceinline__ void columns(int64_t n, int count) {"]
    for o in range(1, n_ops):
        if sig.varies[o] == "n":
            out.append(f"    e{o} = mm_load4(q.p.ops[{o}], bz, 0, n, count, {_dtype(sig.operands[o])});")
    out += ["  }", "  __device__ __forceinline__ void row(int64_t m) {"]
    for o in range(1, n_ops):
        if sig.varies[o] == "m":
            x = f"q.p.ops[{o}]"
            out.append(f"    e{o} = sm_splat(sm_load({x}.ptr, bz * {x}.strides[0] + m * {x}.strides[1], "
                       f"{_dtype(sig.operands[o])}));")
    out += ["  }",
            "  __device__ __forceinline__ uint4 operator()(int64_t m, int64_t n, uint4 acc, int count) const {",
            "    const uint4 z = sm_splat(0u);",
            "    const uint4 v0 = acc;"]
    for o in range(1, n_ops):
        value = (f"mm_load4(q.p.ops[{o}], bz, m, n, count, {_dtype(sig.operands[o])})"
                 if sig.varies[o] == "mn" else f"e{o}")
        out.append(f"    const uint4 v{o} = {value};")
    for j in range(sig.n_consts):
        out.append(f"    const uint4 v{n_ops + j} = sm_splat(q.p.consts[{j}]);")
    out += _body(sig, "v", "    ", "z", True)
    args = ", ".join([*fixed, *(str(x).lower() for x in sig.layout), "MmGenerated"])
    out += [f"    return v{sig.result};", "  }", "};", "", "}  // namespace", "",
            f'extern "C" __global__ void __launch_bounds__(256, 1) {KERNEL}(',
            "    const __grid_constant__ MmParams q, void* __restrict__ out) {",
            f"  {body}<{args}>(q, out);", "}", ""]
    return "\n".join(out)


def _strided_source(sig: Signature) -> str:
    """``ew_strided``'s kernel for ``sig``: an element a thread a pass."""
    idx = "int" if sig.narrow else "long long"
    uidx = "unsigned" if sig.narrow else "unsigned long long"
    n_ops = len(sig.operands)
    out = [
        '#include "program.cuh"',
        "",
        f"// Generated for {sig}.",
        f'extern "C" __global__ void __launch_bounds__(256) {KERNEL}(',
        "    const __grid_constant__ SmParams p, void* __restrict__ out) {",
    ]
    for j in range(sig.n_consts):
        out.append(f"  const uint32_t r{n_ops + j} = p.consts[{j}];")
    out += [
        f"  const {idx} n = ({idx})p.n, step = ({idx})gridDim.x * blockDim.x;",
        f"  for ({idx} i = ({idx})blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {{",
        f"    {uidx} rest = ({uidx})i;",
    ]
    for d in range(sig.rank - 1, 0, -1):
        out.append(f"    const {uidx} c{d} = rest % ({uidx})p.shape[{d}];")
        out.append(f"    rest /= ({uidx})p.shape[{d}];")
    out.append(f"    const {uidx} c0 = rest;")
    for o, dt in enumerate(sig.operands):
        terms = " + ".join(f"({idx})c{d} * ({idx})p.ops[{o}].strides[{d}]" for d in range(sig.rank))
        out.append(f"    uint32_t r{o} = sm_load(p.ops[{o}].ptr, {terms}, {DTYPE_NAMES[dt]});")
    out += _iterate(sig, "r", "    ", "0u", False)
    out += [f"    sm_store(out, i, {DTYPE_NAMES[sig.out_dtype]}, res);", "  }", "}", ""]
    return "\n".join(out)


def _digest(src: str) -> str:
    from .. import _build

    h = hashlib.sha256(src.encode())
    h.update(" ".join(OPTIONS).encode())
    h.update(str(_build.NVRTC_VERSION).encode())
    for name in HEADERS:
        h.update(name.encode())
        h.update((_build.CSRC / name).read_bytes())
    return h.hexdigest()[:24]


def _compile(lib, src: str):
    """The CUBIN of ``src`` and NVRTC's log (ptxas' report in it);
    RuntimeError with the log if it fails."""
    from .. import _build

    opts = [*OPTIONS, f"-I{_build.CSRC}"]
    argv = (ctypes.c_char_p * len(opts))(*(o.encode() for o in opts))
    log = ctypes.create_string_buffer(1 << 16)
    image, size = ctypes.c_void_p(), ctypes.c_size_t()
    t0 = time.perf_counter()
    rc = lib.sm_rtc_compile(src.encode(), argv, len(opts), log, len(log),
                            ctypes.byref(image), ctypes.byref(size))
    if rc != 0:
        raise RuntimeError(
            f"NVRTC failed to compile a generated kernel (nvrtcResult {rc}):\n"
            f"{log.value.decode(errors='replace')}\n--- source ---\n{src}"
        )
    COMPILE_MS.append((time.perf_counter() - t0) * 1e3)
    STATS["compiled"] += 1
    try:
        return ctypes.string_at(image, size.value), log.value.decode(errors="replace")
    finally:
        lib.sm_rtc_free(image)


def _log_path(src: str):
    from .. import _build

    return _build.BUILD_DIR.parent / "logs" / "generated" / f"{_digest(src)}.log"


def _write(path, data: bytes) -> None:
    """``data`` into ``path`` by atomic rename: a concurrent process never
    reads half."""
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _cubin(lib, src: str) -> bytes:
    """The CUBIN of ``src`` from the disk cache, compiled into it if absent,
    its log (ptxas' report) under ``build/logs/generated/``."""
    from .. import _build

    path = _build.BUILD_DIR / "generated" / f"{_digest(src)}.cubin"
    if path.exists():
        STATS["disk"] += 1
        return path.read_bytes()
    image, log = _compile(lib, src)
    _write(_log_path(src), log.encode())
    _write(path, image)
    return image


def ptxas(sig: Signature):
    """ptxas' report on the kernel of ``sig`` (``registers``, ``stack``,
    ``spill_stores``, ``spill_loads``), from the log of the compile that
    made its CUBIN; None where that log is not on this disk."""
    from .. import _build

    path = _log_path(source(sig))
    if not path.exists():
        return None
    return _build.ptxas(path.read_text()).get(KERNEL)


def _evict(lib) -> None:
    import torch

    torch.cuda.synchronize()  # no launch of a kernel about to go is pending
    for sig in [s for s in _LOADED if s not in _PINS]:
        lib.sm_rtc_unload(_LOADED.pop(sig)[0])


def resident(sig: Signature) -> int:
    """The blocks of 256 threads of the loaded kernel of ``sig`` that the
    card runs at once (a flat launch of quads launches no more)."""
    return _LOADED[sig][2]


def kernel(lib, sig: Signature) -> int:
    """The handle of the loaded kernel for ``sig`` (``cudaKernel_t``); a
    CUDA graph being built holds the signature's pin."""
    from ..utils import graphs

    if graphs.building():
        graphs.hold(_PINS.setdefault(sig, _Pin()))
    hit = _LOADED.get(sig)
    if hit is not None:
        STATS["memory"] += 1
        return hit[1]
    if graphs.capturing():
        # A compile, a disk read and a module load cannot go into a CUDA
        # graph; the warm-up call before a capture loads every signature.
        raise graphs.CaptureError(
            f"the generated kernel for {sig} was first asked for while a CUDA "
            "graph was captured; the warm-up call should have compiled it")
    if len(_LOADED) >= CAP:
        _evict(lib)
    image = _cubin(lib, source(sig))
    library, handle, blocks = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_int64()
    rc = lib.sm_rtc_load(image, KERNEL.encode(), 256, ctypes.byref(library), ctypes.byref(handle),
                         ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"loading a generated kernel failed: cudaError {rc}")
    _LOADED[sig] = (library.value, handle.value, blocks.value)
    SEEN.add(sig)
    return handle.value
