"""Debugging / numerical-safety helpers.

Counterpart of ``simplemath_tpu/utils/debug.py``.  The hazards they surface
are NaN/Inf propagation and kernel-level faults:

* ``nan_guard(fn)`` wraps a function so every floating output leaf is
  checked for NaN/Inf after the call (one host sync), raising
  ``FloatingPointError`` on the host (the JAX package's checkify guard);
* ``interpret_kernels()`` makes every kernel wrapper run its plain PyTorch
  version for the context's duration, on card tensors too (the counterpart
  of Pallas interpret mode: no kernel is launched, ``LAUNCHES`` does not
  move, and each such call is counted as ``interpret:<family>`` in
  ``ops.dispatch``);
* ``assert_tree_finite`` / ``tree_norm`` inspect a state pytree.

``config.debug_checks`` is a separate switch, as in the JAX package: it
guards the solvers' unrolled inverses (ops/linalg_small.py, ops/soa.py).
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.utils import _pytree

from ..ops import dispatch
from .elastic import state_is_finite


def assert_tree_finite(tree, name: str = "value") -> None:
    """Eager check that every leaf is finite; raises with the leaf path."""
    for path, leaf in _pytree.tree_flatten_with_path(tree)[0]:
        t = torch.as_tensor(leaf)
        if not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"non-finite values in {name}{_pytree.keystr(path)}")


def tree_norm(tree) -> float:
    """Global L2 norm over all leaves (host-side scalar)."""
    total = sum(
        torch.sum(torch.square(torch.as_tensor(leaf).to(torch.float32))).cpu()
        for leaf in _pytree.tree_leaves(tree)
    )
    return float(torch.sqrt(torch.as_tensor(total)))


def nan_guard(fn):
    """Wrap ``fn``: after each call, every floating output leaf is swept
    with ``torch.isfinite`` (one host sync for all of them), and a NaN or
    Inf raises ``FloatingPointError`` on the host."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        if not state_is_finite(out):
            raise FloatingPointError("non-finite output detected")
        return out

    return wrapped


@contextlib.contextmanager
def interpret_kernels():
    """Run every kernel wrapper's plain version within the context, on
    card tensors too: the kernel 'sanitizer' pass (plain PyTorch semantics,
    no launch).  The setting comes back on exit, on an exception too."""
    token = dispatch.INTERPRET.set(True)
    try:
        yield
    finally:
        dispatch.INTERPRET.reset(token)
