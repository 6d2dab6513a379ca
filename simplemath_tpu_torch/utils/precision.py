"""Float32 matmul pinning for the solver layer.

Counterpart of ``simplemath_tpu/utils/precision.py``.  Inside the solvers
the matrices are tiny and chained through hundreds of Riccati steps, so a
product rounded to a narrower type compounds into failed convergence.  On
the card ``torch.matmul`` of float32 runs in full float32 unless a caller
turns TF32 on (``torch.backends.cuda.matmul.allow_tf32``).  Every solver
entry point pins TF32 off while it runs, and so does the engine's float
``dot``/``matmul`` (ops/engine.py, ops/matmul.py), through the one context
manager below.
"""

from __future__ import annotations

import contextlib
import functools

import torch


@contextlib.contextmanager
def exact_float32():
    """``torch.matmul`` of float32 in full float32 on the card, whatever
    the caller's global TF32 setting; the setting comes back on exit, on an
    exception too."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def f32_matmuls(fn):
    """Decorator: run ``fn`` with float32 matmuls in full float32."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with exact_float32():
            return fn(*args, **kwargs)

    # Marker for the test that keeps every solver entry point pinned
    # (tests/test_torch_numerical_parity.py).
    wrapped._pins_f32_matmuls = True
    return wrapped
