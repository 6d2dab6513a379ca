"""simplemath_tpu_torch — the PyTorch and CUDA port of simplemath_tpu.

The array core of ``simplemath_tpu`` on PyTorch, with its Pallas kernel
families written by hand in CUDA for NVIDIA Hopper (``csrc/``): the generic
elementwise kernel, the map-reduce kernel of the reductions and the 1-D
dot, and the matmul kernel with its fused epilogue.  The JAX package stays
the reference; the port keeps its module layout and names.  Arrays live on
the card (``config.device`` is ``"cuda"``) unless the caller asks for the
CPU with ``sm.configure(device="cpu")`` or ``SM_DEVICE=cpu``.

    import simplemath_tpu_torch as sm
    a = sm.Array([[1., 2.], [3., 4.]])
    b = sm.ones(2, 2)
    c = a + b                 # broadcast + the elementwise kernel
    d = sm.pow(a, 3)          # correct float/integer pow
    v = a[0, :]               # aliasing view; v[0] = 9 writes through
    s = sm.sum(sm.square(a - b))   # one map-reduce kernel call
    layer = sm.fuse(lambda x, w, bias: sm.maximum(x @ w + bias, 0.0))
    y = layer(x, w, bias)     # one matmul kernel call, epilogue included

Ported so far: ``Array`` with views, the op registry, the engine,
``sm.fuse`` and the deferred-eager queue, the reductions, ``dot`` and
``matmul`` of every rank, the fused matmul root and ``int8_matmul``, and
the solver stack as plain torch (``simplemath_tpu_torch.models``: the
dynamics families, batched iLQR/DDP, RTI, AL-SQP MPC; ``entry.entry()``,
the twin of ``__graft_entry__.entry()``).  What waits is listed in
ROADMAP.md.
"""

from .array import Array, asarray  # noqa: F401
from .slicing import SLICE, SLICE_ALL, SLICE_END, SLICE_START, Slice  # noqa: F401
from .broadcast import BroadcastResult, broadcast_shapes, total_size  # noqa: F401
from .config import Config, config, update as configure  # noqa: F401
from .api import (  # noqa: F401
    abs,
    add,
    allclose,
    arange,
    arccos,
    arcsin,
    arctan,
    arctan2,
    argmax,
    argmin,
    array,
    ceil,
    clip,
    concatenate,
    cos,
    cosh,
    cumsum,
    dequantize,
    divide,
    dot,
    empty,
    exp,
    exp2,
    expand_dims,
    expm1,
    eye,
    floor,
    full,
    full_like,
    fuse,
    int8_matmul,
    isfinite,
    isinf,
    isnan,
    linspace,
    log,
    log10,
    log1p,
    log2,
    matmul,
    max,
    maximum,
    mean,
    min,
    minimum,
    multiply,
    negative,
    ones,
    ones_like,
    pow,
    prod,
    quantize,
    repeat,
    reshape,
    round,
    sign,
    sin,
    sinh,
    sort,
    sqrt,
    square,
    squeeze,
    stack,
    std,
    subtract,
    sum,
    tan,
    tanh,
    transpose,
    var,
    where,
    zeros,
    zeros_like,
)
from .ops import apply_op, register_op, registered_ops  # noqa: F401
from .interop import from_reference  # noqa: F401

__version__ = "0.1.0"
