"""simplemath_tpu_torch — the PyTorch and CUDA port of simplemath_tpu.

The array core of ``simplemath_tpu`` on PyTorch, with two of its Pallas
kernel families written by hand in CUDA for NVIDIA Hopper (``csrc/``): the
generic elementwise kernel and the map-reduce kernel of the reductions and
the 1-D dot.  The JAX package stays the reference; the port keeps its
module layout and names.

    import simplemath_tpu_torch as sm
    sm.configure(device="cuda")
    a = sm.Array([[1., 2.], [3., 4.]])
    b = sm.ones(2, 2)
    c = a + b                 # broadcast + the elementwise kernel
    d = sm.pow(a, 3)          # correct float/integer pow
    v = a[0, :]               # aliasing view; v[0] = 9 writes through
    s = sm.sum(sm.square(a - b))   # one map-reduce kernel call

Ported so far: ``Array`` with views, the op registry, the engine,
``sm.fuse`` and the deferred-eager queue, the reductions and the 1-D dot.
What waits is listed in ROADMAP.md.
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
    argmax,
    argmin,
    array,
    clip,
    cos,
    cumsum,
    divide,
    dot,
    empty,
    exp,
    exp2,
    full,
    full_like,
    fuse,
    log,
    log2,
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
    sign,
    sin,
    sqrt,
    square,
    std,
    subtract,
    sum,
    tan,
    tanh,
    var,
    where,
    zeros,
    zeros_like,
)
from .ops import apply_op, register_op, registered_ops  # noqa: F401
from .interop import from_reference  # noqa: F401

__version__ = "0.1.0"
