"""Elementwise kernels generated per program and compiled at run time.

The compiled strided elementwise kernel (``ew_strided``'s interpreter,
csrc/elementwise.cu) interprets its program per element: a register file in
local memory, an instruction fetched and dispatched at a time, the index
decoded rank-deep.  That is most of its time, for an iterated recurrence
above all, and a few times the bytes' time even for one instruction.  So
``ew_strided`` runs a kernel that this module writes for the program, in
which

* the registers are local variables (``r7``), so they live in registers;
* every instruction is ``sm_exec(<OPCODE>, ...)`` of csrc/tiles.cuh with the
  opcode a literal (in ``sm_bf16r`` where its result is bfloat16), so the
  compiler keeps that opcode's code alone and the values are the
  interpreter's, bit for bit;
* the operands are loaded and the index decoded once per element, the rank
  a constant, in 32-bit arithmetic where every offset fits;
* with ``iterations > 1`` the loop runs the instructions and puts the
  result in the carry register, and the compiler may hoist what does not
  depend on the carry;
* the result is stored once, through ``sm_store``.

It is what the TPU kernel does (``simplemath_tpu/ops/elementwise.py::
_build_call`` compiles a kernel per tile function and caches it on the
function's id).  The kernel takes the interpreter's parameter block
(``SmParams``) as a ``__grid_constant__``, so the shape, the strides, the
pointers, the constants' values and the count of iterations are read at
run time and are not part of the code: ``a + 2.0`` and ``a + 3.0`` share a
kernel.  What the code depends on is the ``Signature``.

NVRTC compiles the source (csrc/nvrtc.cu, in the kernel library that
``_build.py`` builds) with the options of the compiled kernels that bear on
the values (``--fmad=false``, no fast math) for ``sm_90a``, and the
runtime loads the CUBIN.  Kernels are cached in the process by signature
(at most ``CAP``; when full, all are unloaded and the cache starts again,
as the reference clears its cache) and on disk under
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
from typing import Tuple

from . import program

KERNEL = "sm_generated"
OPTIONS = ("--gpu-architecture=sm_90a", "--fmad=false", "-std=c++17")
HEADERS = ("tiles.cuh", "program.cuh")
CAP = 512  # as the reference's _TILE_FN_CAP
# enum SmDtype (csrc/tiles.cuh), by code.
DTYPE_NAMES = ("SM_F32", "SM_I32", "SM_BOOL", "SM_BF16", "SM_I8", "SM_U8", "SM_I64",
               "SM_U32", "SM_F16")
# Largest element count and offset the 32-bit index arithmetic takes: an
# index plus a grid's stride stays below 2**31.
NARROW_LIMIT = (1 << 31) - (1 << 21)

# In this process: NVRTC compiles, CUBINs read from the disk cache, and
# calls served by a kernel already loaded; the milliseconds of each compile.
STATS = {"compiled": 0, "disk": 0, "memory": 0}
COMPILE_MS: list = []

_LOADED: dict = {}  # Signature -> (library handle, kernel handle)


@dataclasses.dataclass(frozen=True)
class Signature:
    """What a generated kernel's code depends on.  ``insts`` are
    ``(opcode, dst, a, b, c)`` with -1 for a source the instruction does not
    read; ``rounds`` says which instructions round their result to bfloat16;
    ``operands`` the operands' dtype codes; ``carry`` is -1 unless
    ``iterated``; ``narrow`` says every index and offset fits 32 bits."""

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


def signature(prog, codes, operand_dtypes, out_dtype, rank, iterations, carry,
              narrow) -> Signature:
    """The signature of ``prog`` (with its kernel ``codes``) over operands
    of dtype codes ``operand_dtypes``, writing ``out_dtype`` (a code) at
    ``rank``."""
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
    )


def narrow(n, layouts) -> bool:
    """Whether ``n`` elements and every operand's reach fit the 32-bit
    arithmetic; ``layouts`` are (shape, strides) of each operand."""
    reach = max((sum(abs(s) * (d - 1) for d, s in zip(shape, strides) if d > 1)
                 for shape, strides in layouts), default=0)
    return n < NARROW_LIMIT and reach < NARROW_LIMIT


def source(sig: Signature) -> str:
    """The CUDA source of the kernel for ``sig``."""
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
    pad = "    "
    if sig.iterated:
        out.append("    uint32_t res = 0u;")
        out.append("    for (int it = 0; it < p.iterations; ++it) {")
        pad = "      "
    for (op, dst, *srcs), rnd in zip(sig.insts, sig.rounds):
        args = ", ".join(f"r{r}" if r >= 0 else "0u" for r in srcs)
        value = f"sm_exec({program.OPCODES[op]}, {args})"
        if rnd:
            value = f"sm_bf16r({value})"
        out.append(f"{pad}const uint32_t r{dst} = {value};")
    if sig.iterated:
        out.append(f"      res = r{sig.result};")
        out.append(f"      r{sig.carry} = res;")
        out.append("    }")
    else:
        out.append(f"    const uint32_t res = r{sig.result};")
    out += [f"    sm_store(out, i, {DTYPE_NAMES[sig.out_dtype]}, res);", "  }", "}", ""]
    return "\n".join(out)


def _digest(src: str) -> str:
    from .. import _build

    h = hashlib.sha256(src.encode())
    h.update(" ".join(OPTIONS).encode())
    for name in HEADERS:
        h.update(name.encode())
        h.update((_build.CSRC / name).read_bytes())
    return h.hexdigest()[:24]


def _compile(lib, src: str) -> bytes:
    """The CUBIN of ``src``; RuntimeError with NVRTC's log if it fails."""
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
        return ctypes.string_at(image, size.value)
    finally:
        lib.sm_rtc_free(image)


def _cubin(lib, src: str) -> bytes:
    """The CUBIN of ``src`` from the disk cache, compiled into it if absent
    (written by atomic rename: a concurrent process never reads half)."""
    from .. import _build

    path = _build.BUILD_DIR / "generated" / f"{_digest(src)}.cubin"
    if path.exists():
        STATS["disk"] += 1
        return path.read_bytes()
    image = _compile(lib, src)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        f.write(image)
    os.replace(tmp, path)
    return image


def _evict(lib) -> None:
    import torch

    torch.cuda.synchronize()  # no launch of a kernel about to go is pending
    for library, _ in _LOADED.values():
        lib.sm_rtc_unload(library)
    _LOADED.clear()


def kernel(lib, sig: Signature) -> int:
    """The handle of the loaded kernel for ``sig`` (``cudaKernel_t``)."""
    hit = _LOADED.get(sig)
    if hit is not None:
        STATS["memory"] += 1
        return hit[1]
    if len(_LOADED) >= CAP:
        _evict(lib)
    image = _cubin(lib, source(sig))
    library, handle = ctypes.c_void_p(), ctypes.c_void_p()
    rc = lib.sm_rtc_load(image, KERNEL.encode(), ctypes.byref(library), ctypes.byref(handle))
    if rc != 0:
        raise RuntimeError(f"loading a generated kernel failed: cudaError {rc}")
    _LOADED[sig] = (library.value, handle.value)
    return handle.value
