"""The wrapper of the hand-written matmul kernel.

Counterpart of ``simplemath_tpu/ops/matmul.py`` and its two Pallas kernels,
``_build_matmul`` (rank 2) and ``_build_bmm`` (rank 3).  On the card the
batch is a grid dimension, so one kernel serves both ranks; ``LAUNCHES``
counts launches as ``mm`` (rank 2) and ``bmm`` (rank 3).  Which kernel a
product takes follows from its operands' types alone (``variant``), never
from a shape, a stride or a size, and ``VARIANTS`` counts launches by it:

- ``wgmma_bf16``: bfloat16 @ bfloat16, on the tensor cores
  (csrc/matmul_wgmma.cu: ``wgmma`` from a ring of shared-memory stages).
  A bf16 x bf16 product is exact in float32 and the accumulator is
  float32, as on the TPU's matrix unit.  Bound by the tensor cores' bf16
  rate and, beneath it, by the L2 traffic of the tiles (hence 128 x 256
  tiles).  Each operand is staged either 16 bytes at a time or element by
  element through its strides (``staging``), into one shared-memory
  layout, so a view and its contiguous clone give the same bits.
- ``wgmma_s8``: int8 or uint8 @ int8 or uint8, on the int8 tensor cores
  (csrc/matmul_wgmma_s8.cu: ``wgmma`` s32 += {s8, u8} x {s8, u8}, without
  saturation, so the int32 accumulator wraps mod 2**32, and uint8 is read
  as unsigned).  The same ring, tile and store as ``wgmma_bf16``.  The 8-bit
  ``wgmma`` reads both operands with the contraction dim contiguous in
  shared memory only, so an operand whose other dim is the contiguous one
  in memory (a row-major ``B``) is transposed byte-wise on its way in;
  ``staging`` says which of copy, transpose and byte-by-byte an operand
  takes.
- ``fma_f32``: float32 @ float32 and the mixed float32/bfloat16 pairs, in
  exact float32 multiply-adds on the CUDA cores (csrc/matmul.cu), which is
  what bounds it (a tensor-core route would truncate a float32 operand).
  Each operand reaches shared memory by 16-byte ``cp.async`` copies or
  element by element through its strides (``staging``), into one layout.
- ``imad_i32``: integer pairs with an int32 operand, 32-bit integer
  multiply-adds on the CUDA cores (csrc/matmul.cu), wrapping mod 2**32.
- ``imad_i64``: integer pairs with an int64 operand (``dot``/``matmul`` of
  int64 and uint64 results), 64-bit integer multiply-adds on the CUDA cores
  (csrc/matmul.cu), wrapping mod 2**64 as the JAX package's int64
  ``jnp.dot`` does; every operand read element by element and widened, no
  epilogue.

``matmul(a, b, out_dtype=None, precision="default", epilogue=None,
extras=())`` multiplies (M, K) @ (K, N) or (B, M, K) @ (B, K, N).  Operands
and extras are tensors or ``elementwise.View``s and are read in place
through their signed strides: a transposed, sliced or negative-step view
costs no copy, and nothing is padded (the kernel masks the ragged edge).
The accumulator is float32 for float32 and bfloat16 operands, int32,
wrapping mod 2**32, for int8, uint8 and int32 operands, and int64,
wrapping mod 2**64, when an operand is int64 or uint64.  ``epilogue`` is a
``program.Program`` (``program.lower_epilogue``) whose operand 0 is the
accumulator and whose other operands are ``extras``, each broadcastable to
the product as (1|M, 1|N) or (1|B, 1|M, 1|N) and read with stride 0 where
it broadcasts; the kernel runs it once per output element on the
accumulator, so the product itself is never stored.  The result is cast to
``out_dtype`` at the store.

Precision.  ``precision="default"`` and ``"highest"`` are the same on this
card.  Float32 operands get exact float32 multiply-adds with a float32
accumulator, which is also what ``torch.matmul`` does on the card with TF32
off (its default).  The JAX package's ``"default"`` truncates float32
operands to bfloat16 on a TPU; that is a property of the TPU's matrix unit
and is not carried over: a TF32 or bfloat16 tensor-core route for float32
operands would be a new, named precision.  Bfloat16 operands lose nothing
on the tensor cores (their products are exact in the float32 accumulator;
only the order of the sum differs from the CUDA cores'), so they need no
name.

An operand under a ``torch.func`` transform (or one that requires grad)
takes ``autodiff.Product``: the same kernel, with derivative and batching
rules.  ``matmul`` looks at the operands' device.  CPU tensors take the kernel's
plain version, ``matmul_plain``: ``torch.matmul`` in the accumulator's type
(integers in int64 on the CPU, wrapped to int32), the epilogue through
``program.run_plain``, then the cast.  CUDA tensors launch the kernel or
raise: there is no fallback.  Dispatch names are the JAX package's:
``matmul:mm``, ``matmul:bmm``, ``matmul:mm_epilogue``,
``matmul:bmm_epilogue`` and ``matmul:int8``; the port adds
``matmul:wgmma_bf16`` and ``matmul:wgmma_s8`` for a product routed to a
tensor-core kernel.

``int8_matmul``, ``quantize_int8`` and ``dequantize_int8`` are the
quantized-inference entry points.  Unlike the TPU's matrix unit the card's
tensor cores read uint8 as unsigned, so ``int8_matmul`` sends int8 and
uint8 alike to ``wgmma_s8``, and with ``scale=`` the dequantizing epilogue
runs inside that kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import dtypes as _dt
from ..utils.precision import exact_float32
from . import dispatch, elementwise, program

# Kernel launches by entry point since the last reset, and the same
# launches by the kernel they took.
LAUNCHES = {"mm": 0, "bmm": 0}
VARIANTS = {"wgmma_bf16": 0, "wgmma_s8": 0, "fma_f32": 0, "imad_i32": 0, "imad_i64": 0}
# The kernels that stage tiles for ``wgmma``, and the library function of each.
_TENSOR_CORE = {"wgmma_bf16": "sm_mm_wgmma_launch", "wgmma_s8": "sm_mm_wgmma_s8_launch"}

_FLOAT_OPERANDS = (torch.float32, torch.bfloat16)
INT_OPERANDS = (torch.int8, torch.uint8, torch.int32)
WIDE_OPERANDS = (torch.int64, torch.uint64)  # the 64-bit accumulator's own
_BYTE_OPERANDS = (torch.int8, torch.uint8)
# Extras the epilogue reads: the elementwise kernel's types, and bfloat16,
# which the load widens to float32.
# Register types of the epilogue program (the kernels' evaluator takes
# more; the epilogue's stores and its checks were built for these), and the
# extras it reads.
EPILOGUE_DTYPES = frozenset([torch.float32, torch.int32, torch.bool])
EXTRA_DTYPES = frozenset(EPILOGUE_DTYPES | {torch.bfloat16})
# enum SmDtype (csrc/tiles.cuh): int64 and uint64 are one code, the same
# bits mod 2**64.
_DTYPE_CODE = {**elementwise._DTYPE_CODE, torch.int64: 6, torch.uint64: 6}
_ACC_CODE = {torch.float32: 0, torch.int32: 1, torch.int64: 2}  # MmParams.int_acc
PRECISIONS = ("default", "highest")
_MAX_BATCH = 65535        # gridDim.z
_MAX_M = 65535 * 128      # gridDim.y tiles of 128 rows


def reset_launches() -> None:
    for counts in (LAUNCHES, VARIANTS):
        for k in counts:
            counts[k] = 0


def accumulator(a_dtype, b_dtype):
    """The accumulator type of the kernel for these operand types, or None
    when it does not take them."""
    if a_dtype in _FLOAT_OPERANDS and b_dtype in _FLOAT_OPERANDS:
        return torch.float32
    ints = INT_OPERANDS + WIDE_OPERANDS
    if a_dtype in ints and b_dtype in ints:
        return torch.int64 if a_dtype in WIDE_OPERANDS or b_dtype in WIDE_OPERANDS else torch.int32
    return None


def variant(a_dtype, b_dtype):
    """The kernel a product of these operand types takes (a key of
    ``VARIANTS``), or None when no kernel takes them."""
    if a_dtype == b_dtype == torch.bfloat16:
        return "wgmma_bf16"
    if a_dtype in _BYTE_OPERANDS and b_dtype in _BYTE_OPERANDS:
        return "wgmma_s8"
    acc = accumulator(a_dtype, b_dtype)
    if acc is None:
        return None
    return {torch.float32: "fma_f32", torch.int32: "imad_i32", torch.int64: "imad_i64"}[acc]


def staging(strides, contraction, address, itemsize=2):
    """How a matmul kernel stages one operand: ``(k_major, vec16)``.

    ``strides`` are the operand's signed element strides over (batch, row,
    column) as ``_strides3`` gives them (0 for a dim of size 1),
    ``contraction`` is its contraction dim (2 for A, 1 for B), ``address``
    the byte address of its first element and ``itemsize`` its element size
    (4: float32/int32, the CUDA-core kernel; 2: bfloat16; 1: int8/uint8).
    ``vec16``: the operand is read 16 bytes at a time, which needs stride 1
    along one matrix dim, every other stride a multiple of 16 bytes (4, 8
    or 16 elements; negative or 0 alike) and a 16-byte-aligned first
    element; otherwise it is read element by element.  ``k_major``: the
    contraction dim is the one of stride 1, or on the element path the one
    of the smaller step.  For 4- and 2-byte types that is the contiguous dim
    of the shared-memory tile (the CUDA-core kernel's inner loop and
    ``wgmma`` read either order); a 1-byte tile is always
    contraction-contiguous, so a ``vec16`` operand that is not ``k_major``
    is transposed on its way in.  Either way the same elements land in the
    same layout, so the choice never shows in a result."""
    other = 3 - contraction  # dims 1 and 2 are the matrix's own
    chunk = 16 // itemsize   # elements in 16 bytes
    s_k, s_mn = strides[contraction], strides[other]
    aligned = address % 16 == 0 and strides[0] % chunk == 0
    if s_k == 1 and s_mn % chunk == 0 and aligned:
        return True, True
    if s_mn == 1 and s_k % chunk == 0 and aligned:
        return False, True
    return abs(s_k) <= abs(s_mn), False


def stored_dtypes(result_dtype) -> tuple:
    """The types the kernel can store a result of ``result_dtype`` as."""
    if result_dtype == torch.float32:
        return (torch.float32, torch.bfloat16)
    if result_dtype == torch.int64:
        return (torch.int64,)
    return (result_dtype,) if result_dtype in EPILOGUE_DTYPES else ()


def product_shape(a_shape, b_shape) -> tuple:
    """(B, M, N, K) of (M, K) @ (K, N) or (B, M, K) @ (B, K, N); ValueError
    for anything else."""
    a_shape, b_shape = tuple(a_shape), tuple(b_shape)
    rank = len(a_shape)
    ok = (
        len(b_shape) == rank
        and rank in (2, 3)
        and a_shape[-1] == b_shape[-2]
        and (rank == 2 or a_shape[0] == b_shape[0])
    )
    if not ok:
        raise ValueError(
            "the matmul kernel takes (M, K) @ (K, N) or (B, M, K) @ (B, K, N); "
            f"got {a_shape} @ {b_shape}"
        )
    return (a_shape[0] if rank == 3 else 1, a_shape[-2], b_shape[-1], a_shape[-1])


# ------------------------------------------------------------ C interface
class _MmOperand(ctypes.Structure):
    _fields_ = [
        ("ptr", ctypes.c_void_p),
        ("strides", ctypes.c_int64 * 3),
        ("dtype", ctypes.c_int32),
        ("inner_fast", ctypes.c_int32),
        ("vec16", ctypes.c_int32),
        ("pad", ctypes.c_int32),
    ]


class _MmParams(ctypes.Structure):
    _fields_ = [
        ("p", elementwise._Params),
        ("a", _MmOperand),
        ("b", _MmOperand),
        ("B", ctypes.c_int64),
        ("M", ctypes.c_int64),
        ("N", ctypes.c_int64),
        ("K", ctypes.c_int64),
        ("int_acc", ctypes.c_int32),
        ("epilogue", ctypes.c_int32),
        ("out_dtype", ctypes.c_int32),
        ("pad", ctypes.c_int32),
    ]


@functools.lru_cache(maxsize=None)
def _library():
    """The built kernel library, its parameter layout checked once."""
    lib = elementwise._library()
    if lib.sm_mm_params_size() != ctypes.sizeof(_MmParams):
        raise RuntimeError("matmul kernel parameter layout does not match its binding")
    return lib


def _strides3(shape, strides, batched):
    """Strides over (batch, row, column); a size-1 dim gets stride 0."""
    s = [0 if n == 1 else st for n, st in zip(shape, strides)]
    return s if batched else [0] + s


def _set_operand(dst, x, batched, contraction, kernel):
    buf, off, shape, strides = elementwise._describe(x)
    dst.ptr = buf.data_ptr() + off * buf.element_size()
    s = _strides3(shape, strides, batched)
    for d in range(3):
        dst.strides[d] = s[d]
    dst.dtype = _DTYPE_CODE[buf.dtype]
    if kernel == "imad_i64":  # MN-major tiles, read element by element
        return
    k_major, vec16 = staging(s, contraction, dst.ptr, buf.element_size())
    # The CUDA-core kernel copies 4-byte operands alone; a narrower one of a
    # mixed pair is widened on the element path.
    vec16 = vec16 and (kernel in _TENSOR_CORE or buf.element_size() == 4)
    dst.inner_fast, dst.vec16 = int(k_major), int(vec16)


def _launch(a, b, dims, acc, out_dtype, epilogue, extras, device):
    lib = _library()
    kernel = variant(a.dtype, b.dtype)
    B, M, N, K = dims
    batched = len(a.shape) == 3
    out = torch.empty((B, M, N) if batched else (M, N), dtype=out_dtype, device=device)
    q = _MmParams()
    if epilogue is not None and (epilogue.insts or epilogue.result != 0):
        codes = elementwise.check_program(epilogue, "matmul epilogue")
        # Operand 0 stands for the accumulator: described, never loaded.
        stand_in = elementwise.View(out, 0, (1, 1, 1), (0, 0, 0))
        q.p, _ = elementwise.params(epilogue, codes, (B, M, N), [stand_in, *extras])
        q.epilogue = 1
    _set_operand(q.a, a, batched, 2, kernel)
    _set_operand(q.b, b, batched, 1, kernel)
    q.B, q.M, q.N, q.K = B, M, N, K
    q.int_acc = _ACC_CODE[acc]
    q.out_dtype = _DTYPE_CODE[out_dtype]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        launch = getattr(lib, _TENSOR_CORE.get(kernel, "sm_mm_launch"))
        rc = launch(ctypes.byref(q), out.data_ptr(), stream)
    entry = "bmm" if batched else "mm"
    if rc != 0:
        raise RuntimeError(f"{entry} ({kernel}) launch failed: cudaError {rc}")
    LAUNCHES[entry] += 1
    VARIANTS[kernel] += 1
    return out


# ------------------------------------------------------- the plain version
def _int64(x) -> torch.Tensor:
    """Operand ``x`` (a tensor or a view) as an int64 tensor with its value
    mod 2**64, a uint64 one by its bits (torch flips no uint64 tensor)."""
    if x.dtype == torch.uint64:
        x = (elementwise.View(x.base.view(torch.int64), x.offset, x.shape, x.strides)
             if isinstance(x, elementwise.View) else x.view(torch.int64))
    return elementwise.read(x).to(torch.int64)


def _wrap_int32(wide: torch.Tensor) -> torch.Tensor:
    """int64 values reduced mod 2**32 to int32."""
    low = wide & 0xFFFFFFFF
    return torch.where(low >= 1 << 31, low - (1 << 32), low).to(torch.int32)


def int_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The integer product of ``a`` and ``b`` wrapped to int32, exactly.
    torch has an integer matmul on the CPU (taken in int64) and none on
    CUDA, where the product is taken in float64: exact while
    K * max|a| * max|b| < 2**53, which is checked."""
    if a.device.type == "cpu":
        return _wrap_int32(torch.matmul(a.to(torch.int64), b.to(torch.int64)))
    bound = a.shape[-1] * int(a.abs().max()) * int(b.abs().max()) if a.numel() and b.numel() else 0
    if bound >= 1 << 53:
        raise ValueError(
            "the float64 product of these integers is not exact "
            f"(K * max|a| * max|b| = {bound} >= 2**53)"
        )
    return _wrap_int32(torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int64))


def matmul_plain(a, b, out_dtype, epilogue=None, extras=()) -> torch.Tensor:
    """The plain version of the kernel: the product in the accumulator's
    type, the epilogue on it through ``program.run_plain``, then the cast."""
    acc_dtype = accumulator(a.dtype, b.dtype)
    if acc_dtype == torch.int64:
        # torch has an int64 matmul on the CPU alone; it wraps mod 2**64.
        # (No epilogue: the wrapper refuses one.)
        at, bt = _int64(a), _int64(b)
        return torch.matmul(at.cpu(), bt.cpu()).to(at.device)
    at, bt = elementwise.read(a), elementwise.read(b)
    if acc_dtype == torch.int32:
        acc = int_product(at, bt)
    else:
        with exact_float32():
            acc = torch.matmul(at.to(torch.float32), bt.to(torch.float32))
    if epilogue is not None:
        ex = [elementwise.read(e) for e in extras]
        ex = [e.to(torch.float32) if e.dtype == torch.bfloat16 else e for e in ex]
        shape = tuple(acc.shape)
        acc3 = acc.reshape((1,) * (3 - acc.ndim) + shape)
        ex = [e.reshape((1,) * (3 - e.ndim) + tuple(e.shape)) for e in ex]
        acc = program.run_plain(epilogue, [acc3, *ex], tuple(acc3.shape),
                                device=acc.device).reshape(shape)
    return acc.to(out_dtype)


# ------------------------------------------------------------------ entry
def _extra3(x, dims, batched):
    """An extra as an operand of rank 2 or 3 broadcastable to the product."""
    B, M, N, _ = dims
    full = (B, M, N) if batched else (M, N)
    buf, off, shape, strides = elementwise._describe(x)
    if len(shape) > len(full):
        raise ValueError(f"epilogue operand of shape {shape} has more dims than the product {full}")
    pad = len(full) - len(shape)
    shape, strides = (1,) * pad + shape, (0,) * pad + strides
    if any(s not in (1, f) for s, f in zip(shape, full)):
        raise ValueError(
            f"epilogue operand shape {shape} is not broadcastable to {full} as "
            f"{'(1|B, 1|M, 1|N)' if batched else '(1|M, 1|N)'}"
        )
    if batched:
        return elementwise.View(buf, off, shape, strides)
    return elementwise.View(buf, off, (1,) + shape, (0,) + strides)


def matmul(a, b, out_dtype=None, precision: str = "default", epilogue=None,
           extras=()) -> torch.Tensor:
    """``a @ b`` through the matmul kernel (see the module docstring)."""
    from . import autodiff

    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    dims = product_shape(a.shape, b.shape)
    if math.prod(dims) == 0:
        raise ValueError(f"the matmul kernel takes non-empty operands, got {dims}")
    batched = len(a.shape) == 3
    acc = accumulator(a.dtype, b.dtype)
    if acc is None:
        raise TypeError(
            "the matmul kernel takes float32/bfloat16 or int8/uint8/int32 operands, "
            f"or integers with an int64/uint64 one, got {_dt.name(a.dtype)} @ "
            f"{_dt.name(b.dtype)}"
        )
    if acc == torch.int64 and epilogue is not None:
        raise TypeError("the 64-bit integer product takes no epilogue")
    devices = {x.device for x in (a, b, *extras)}
    if len(devices) > 1:
        raise ValueError(f"operands are on different devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if epilogue is None:
        if extras:
            raise ValueError("extras need an epilogue that reads them")
        result = acc
    else:
        want = (acc,) + tuple(torch.float32 if x.dtype == torch.bfloat16 else x.dtype
                              for x in extras)
        if tuple(epilogue.leaf_dtypes) != want:
            raise ValueError(
                f"the epilogue reads {epilogue.leaf_dtypes} where the accumulator and "
                f"the extras are {want}"
            )
        bad = [x.dtype for x in extras if x.dtype not in EXTRA_DTYPES]
        if bad:
            raise TypeError(f"the epilogue does not read {bad}")
        if not epilogue.dtypes <= EPILOGUE_DTYPES:
            raise TypeError(f"the epilogue does not compute in "
                            f"{sorted(map(_dt.name, epilogue.dtypes - EPILOGUE_DTYPES))}")
        result = epilogue.dtype
    if out_dtype is None:
        out_dtype = result
        if epilogue is None and a.dtype == b.dtype == torch.bfloat16:
            out_dtype = torch.bfloat16
    if out_dtype not in stored_dtypes(result):
        raise TypeError(
            f"a {_dt.name(result)} result cannot be stored as {_dt.name(out_dtype)}"
        )
    if any(map(autodiff.transformed, (a, b, *extras))):
        # The kernel's one route under a torch.func transform: the same
        # kernel, with derivative and batching rules.
        return autodiff.product(epilogue, out_dtype,
                                *(elementwise.read(x) for x in (a, b, *extras)))
    extras = [_extra3(x, dims, batched) for x in extras]
    dispatch.record("matmul", "bmm" if batched else "mm")
    if epilogue is not None:
        dispatch.record("matmul", "bmm_epilogue" if batched else "mm_epilogue")
    if variant(a.dtype, b.dtype) in _TENSOR_CORE:
        dispatch.record("matmul", variant(a.dtype, b.dtype))
    if device.type == "cpu":
        return matmul_plain(a, b, out_dtype, epilogue, extras)
    if device.type != "cuda":
        raise ValueError(f"the matmul kernel runs on CUDA tensors, not {device}")
    if dims[0] > _MAX_BATCH or dims[1] > _MAX_M:
        raise ValueError(f"the matmul kernel takes B <= {_MAX_BATCH} and M <= {_MAX_M}")
    return _launch(a, b, dims, acc, out_dtype, epilogue, extras, device)


# ---------------------------------------------------------------- int8
@functools.lru_cache(maxsize=None)
def _dequant_epilogue(rank: int) -> program.Program:
    """int32 accumulator -> float32, times the scale: the counterpart of the
    JAX package's ``_dequant_epi``."""
    acc = program.leaf((1,) * rank, torch.int32)
    scale = program.leaf((1,) * rank, torch.float32)
    return program.lower_epilogue(program.cast(acc, torch.float32) * scale, acc, [scale])


def int8_matmul(a, b, out_dtype=torch.int32, scale=None) -> torch.Tensor:
    """int8/uint8 (M, K) @ (K, N) or batched rank-3 product with exact int32
    accumulation; the result is the int32 product cast to ``out_dtype``.
    ``scale`` (a scalar or an array broadcastable to the product, typically
    ``scale_a * scale_b`` from ``quantize_int8``) fuses the dequantization
    into the kernel's epilogue: the accumulator is cast to float32 and
    scaled at the store, and the result is float32 whatever ``out_dtype``."""
    for x in (a, b):
        if x.dtype not in (torch.int8, torch.uint8):
            raise TypeError(f"int8_matmul requires int8/uint8 operands, got {_dt.name(x.dtype)}")
    dispatch.record("matmul", "int8")
    if scale is None:
        out = matmul(a, b, torch.int32)
        return out if out_dtype == torch.int32 else out.to(out_dtype)
    s = scale if isinstance(scale, (torch.Tensor, elementwise.View)) else \
        torch.as_tensor(scale, dtype=torch.float32)
    if s.dtype != torch.float32 or s.device != a.device:
        s = elementwise.read(s).to(device=a.device, dtype=torch.float32)
    return matmul(a, b, torch.float32, epilogue=_dequant_epilogue(len(a.shape)), extras=[s])


def quantize_int8(x: torch.Tensor, scale=None, axis=None):
    """Symmetric int8 quantization: ``q = clip(round(x / scale), -127,
    127)`` with ``scale = max|x| / 127`` by default; ``axis`` gives
    per-channel scales (reduced over ``axis``, dims kept).  A zero scale
    divides by 1.  Returns ``(q, scale)``, the scale in float32."""
    if scale is None:
        ax = x.abs()
        if axis is None:
            m = ax.amax()
        else:
            m = ax.amax(axis if isinstance(axis, int) else tuple(axis), keepdim=True)
        # Divide by a tensor, so CUDA divides and does not multiply by 1/127.
        scale = m / torch.full((), 127.0, dtype=m.dtype, device=m.device)
    scale = torch.as_tensor(scale, device=x.device).to(torch.float32)
    safe = torch.where(scale > 0, scale, torch.ones((), dtype=torch.float32, device=x.device))
    wide = x / safe if x.dtype == torch.float64 else x.to(torch.float32) / safe
    q = torch.clamp(torch.round(wide), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale) -> torch.Tensor:
    """Inverse of ``quantize_int8`` (also rescales int32 products: pass
    ``scale_a * scale_b``)."""
    scale = torch.as_tensor(scale, device=q.device).to(torch.float32)
    return q.to(torch.float32) * scale
