"""Kernel layer: op registry, expression IR, the wrappers of the
hand-written elementwise, map-reduce and matmul kernels, crafted
transcendentals, fusion and the deferred-eager queue."""

from . import (  # noqa: F401
    elementwise,
    engine,
    fusion,
    lazy,
    matmul,
    program,
    reduction,
    registry,
    transcendental,
)
from .registry import Op, get_op, register_op, registered_ops  # noqa: F401
from .engine import apply_op, binary, unary  # noqa: F401
