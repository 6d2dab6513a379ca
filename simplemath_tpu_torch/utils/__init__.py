"""Utilities of the port.  Counterpart of ``simplemath_tpu/utils/``; for now
only the solvers' float32 matmul pin (``precision.f32_matmuls``)."""

from .precision import f32_matmuls  # noqa: F401
