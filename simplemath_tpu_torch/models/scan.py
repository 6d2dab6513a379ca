"""Associative (parallel-prefix) scan over a tuple of tensors.

Stands in for ``jax.lax.associative_scan`` in the solvers (models/ilqr.py,
models/rti.py) with the same pairing as JAX's implementation: combine
adjacent pairs, scan the half-size sequence recursively (the odd
positions), then fill the even positions from it.  With the same tree,
float32 results agree with the JAX package's up to rounding inside the
combine, not up to a different order of composition.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch


def _interleave(a, b):
    """a[0], b[0], a[1], b[1], ... along dim 0; ``a`` is as long as ``b`` or
    one longer."""
    n = b.shape[0]
    pairs = torch.stack([a[:n], b], dim=1).reshape((2 * n,) + tuple(b.shape[1:]))
    return torch.cat([pairs, a[n:]]) if a.shape[0] > n else pairs


def associative_scan(fn: Callable, elems: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Inclusive scan of the associative ``fn`` along dim 0.

    ``elems`` is a tuple of tensors with one length along dim 0; ``fn(a,
    b)`` takes and returns such tuples and combines them elementwise along
    dim 0.  ``out[k] = fn(...fn(fn(e[0], e[1]), e[2])..., e[k])``."""
    elems = tuple(elems)
    n = elems[0].shape[0]
    if any(e.shape[0] != n for e in elems):
        raise ValueError(
            "associative_scan: every input needs the same length along dim 0, "
            f"got {[tuple(e.shape) for e in elems]}"
        )
    if n < 2:
        return elems
    reduced = fn(tuple(e[0:-1:2] for e in elems), tuple(e[1::2] for e in elems))
    odd = associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn(tuple(e[:-1] for e in odd), tuple(e[2::2] for e in elems))
    else:
        even = fn(odd, tuple(e[2::2] for e in elems))
    even = tuple(torch.cat([e[:1], r]) for e, r in zip(elems, even))
    return tuple(_interleave(a, b) for a, b in zip(even, odd))
