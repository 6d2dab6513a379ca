"""Small-matrix linear algebra, unrolled.

Counterpart of ``simplemath_tpu/ops/linalg_small.py``.  The associative-scan
Riccati combines (models/ilqr.py, models/rti.py) invert ``I + C J`` forms
(C, J PSD) of the state dimension.  A statically unrolled Gauss-Jordan
without pivoting is what the JAX package runs there, and the port keeps it:
the products pair as there, and it runs as plain tensor ops with no host
round trip (``torch.linalg.inv`` checks its input for singularity and waits
for the card to learn the answer).
"""

from __future__ import annotations

import torch

from ..config import config


def _debug_check_finite(out, where: str):
    """Debug-mode guard (``config.debug_checks``): the no-pivot elimination
    turns a singular or indefinite input into inf/nan; raise there instead
    of letting NaN propagate.  Off, it adds no work and no host sync; on,
    it waits for the card to read one flag."""
    if config.debug_checks and not bool(torch.isfinite(out).all()):
        raise FloatingPointError(
            f"{where}: non-finite inverse — input violates the "
            "diagonally-dominant/PD contract (no pivoting is performed)"
        )


def inv_unrolled(A):
    """Inverse of (..., n, n) via unrolled Gauss-Jordan, no pivoting.

    Suitable for small n and matrices with dominant diagonals (e.g. I +
    PSD·PSD products, whose spectrum is bounded away from 0).  Violating
    inputs produce inf/nan, which the solvers' NaN-robust accept rejects
    (models/ilqr.py solve); set ``config.debug_checks`` to raise at the
    source instead.
    """
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    M = torch.cat([A, eye], dim=-1)  # (..., n, 2n)
    for i in range(n):
        row = M[..., i, :] / M[..., i, i][..., None]  # (..., 2n)
        factor = M[..., :, i][..., None]  # (..., n, 1)
        M = M - factor * row[..., None, :]
        M = torch.cat([M[..., :i, :], row[..., None, :], M[..., i + 1:, :]], dim=-2)
    out = M[..., :, n:]
    _debug_check_finite(out, "inv_unrolled")
    return out


def solve_unrolled(A, B):
    """Solve A X = B for small static n via ``inv_unrolled``."""
    inv = inv_unrolled(A)
    if B.ndim == A.ndim - 1:
        return (inv @ B[..., None])[..., 0]
    return inv @ B
