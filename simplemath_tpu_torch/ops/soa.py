"""Structure-of-arrays (batch-minor) small-matrix algebra.

Counterpart of ``simplemath_tpu/ops/soa.py``.  The batched solvers carry
thousands of tiny (n <= 16) matrices.  Here a batch of them is ONE tensor of
shape ``(n, m, B)`` whose minor axis is the batch: every scalar entry
``A[i, j]`` is a ``(B,)`` vector, and the small-matrix algebra unrolls into
elementwise ops over whole batches (n, m are small static ints).  Products
accumulate in ascending k, as in the JAX package, so sums pair the same
way there and here; a product is one multiply-add over every (i, j) entry
per k, so a Riccati step is a few hundred torch ops (and as many nodes in
an exported graph, utils/export.py), not one per entry.

Conversion helpers move the batch axis at the boundary; everything between
stays batch-minor.
"""

from __future__ import annotations

import torch


def to_soa(x, n_minor: int):
    """Move a leading batch axis to the back: (B, d1..dk) -> (d1..dk, B).

    ``n_minor`` is the number of trailing non-batch dims the caller will
    treat as matrix/vector structure (kept for readability at call sites;
    the move itself is total)."""
    return torch.movedim(x, 0, -1)


def from_soa(x):
    """Inverse of :func:`to_soa`: (d1..dk, B) -> (B, d1..dk)."""
    return torch.movedim(x, -1, 0)


def transpose(A):
    """Matrix transpose of a (..., n, m, B) stack -> (..., m, n, B).

    All soa ops index the matrix axes from the RIGHT (batch last, matrix
    dims at -3/-2), so they are polymorphic over arbitrary LEADING axes,
    e.g. a time axis, which lets ``associative_scan`` map them over whole
    horizons."""
    return torch.swapaxes(A, -3, -2)


def matmul(A, C):
    """(..., n, k, B) @ (..., k, m, B) -> (..., n, m, B), unrolled over the
    contraction dim: each step multiplies a column of ``A`` by a row of
    ``C`` over all (i, j) at once, and k ascends, so every entry is summed
    in the JAX package's order."""
    k = A.shape[-2]
    acc = A[..., :, 0:1, :] * C[..., 0:1, :, :]
    for kk in range(1, k):
        acc = acc + A[..., :, kk:kk + 1, :] * C[..., kk:kk + 1, :, :]
    return acc


def matvec(A, v):
    """(..., n, k, B) @ (..., k, B) -> (..., n, B), k ascending as in
    ``matmul``."""
    k = A.shape[-2]
    acc = A[..., :, 0, :] * v[..., 0:1, :]
    for kk in range(1, k):
        acc = acc + A[..., :, kk, :] * v[..., kk:kk + 1, :]
    return acc


def outer(u, v):
    """(..., n, B), (..., m, B) -> (..., n, m, B)."""
    return u[..., :, None, :] * v[..., None, :, :]


def eye_like(n: int, template):
    """(n, n, 1) identity on ``template``'s dtype and device, broadcastable
    against a (..., n, n, B) stack."""
    return torch.eye(n, dtype=template.dtype, device=template.device)[..., None]


def inv(A):
    """Inverse of a (..., n, n, B) stack via unrolled Gauss-Jordan, no
    pivoting.

    Same contract as ops.linalg_small.inv_unrolled (diagonally-dominant /
    PD inputs), but in batch-minor layout.  n == 1 and n == 2 specialize to
    closed forms."""
    from .linalg_small import _debug_check_finite

    n = A.shape[-3]
    if n == 1:
        out = 1.0 / A
        _debug_check_finite(out, "soa.inv")
        return out
    if n == 2:
        det = A[..., 0, 0, :] * A[..., 1, 1, :] - A[..., 0, 1, :] * A[..., 1, 0, :]
        inv_det = 1.0 / det
        row0 = torch.stack(
            [A[..., 1, 1, :] * inv_det, -A[..., 0, 1, :] * inv_det], dim=-2
        )
        row1 = torch.stack(
            [-A[..., 1, 0, :] * inv_det, A[..., 0, 0, :] * inv_det], dim=-2
        )
        out = torch.stack([row0, row1], dim=-3)
        _debug_check_finite(out, "soa.inv")
        return out
    eye = eye_like(n, A).expand(A.shape)
    M = torch.cat([A, eye], dim=-2)  # (..., n, 2n, B)
    for i in range(n):
        row = M[..., i, :, :] / M[..., i, i, :][..., None, :]  # (..., 2n, B)
        factor = M[..., :, i, :]  # (..., n, B)
        M = M - factor[..., :, None, :] * row[..., None, :, :]
        M = torch.cat([M[..., :i, :, :], row[..., None, :, :], M[..., i + 1:, :, :]], dim=-3)
    out = M[..., :, n:, :]
    _debug_check_finite(out, "soa.inv")
    return out


def solve(A, b):
    """Solve A x = b for a (..., n, n, B) stack; b is (..., n, B) or
    (..., n, m, B)."""
    Ainv = inv(A)
    if b.ndim == A.ndim - 1:
        return matvec(Ainv, b)
    return matmul(Ainv, b)
