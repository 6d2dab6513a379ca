"""Small-matrix linear algebra, unrolled.

Counterpart of ``simplemath_tpu/ops/linalg_small.py``.  The associative-scan
Riccati combines (models/ilqr.py, models/rti.py) invert ``I + C J`` forms
(C, J PSD) of the state dimension.  A statically unrolled Gauss-Jordan
without pivoting is what the JAX package runs there, and the port keeps it:
the products pair as there, and it runs as plain tensor ops with no host
round trip (``torch.linalg.inv`` checks its input for singularity and waits
for the card to learn the answer).

``psd_project`` is the solvers' exact projection onto the PSD cone
(``ILQRConfig.psd="eigh"``), which the JAX package computes with
``jnp.linalg.eigh`` (``simplemath_tpu/models/ilqr.py::_eigh_project``).
``torch.linalg.eigh`` reads its ``info`` on the host, so a CUDA graph cannot
hold it; the port runs a parallel cyclic Jacobi eigen-solver instead: on the
card the hand-written kernel ``csrc/psd_project.cu`` (one launch a call),
on the CPU its plain version ``psd_project_plain``, the same algorithm in
torch ops.  Both take the symmetric part ``(H + Hᵀ)/2`` first, as
``jnp.linalg.eigh`` does (``symmetrize_input=True``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..config import config
from . import dispatch, library

# Kernel launches since the last reset.
LAUNCHES = {"psd_project": 0}
# The cap of Jacobi sweeps (PSD_MAX_SWEEPS in csrc/psd_project.cu).  A
# matrix stops at the first sweep that finds its largest off-diagonal
# magnitude at most the type's epsilon times its largest diagonal one;
# quadratic convergence gets there in 1-9 sweeps for n <= 64.
MAX_SWEEPS = 12
# The largest n the kernel takes: S and V of one matrix in one block's
# shared memory (227 KB on Hopper; PSD_MAX_N in csrc/psd_project.cu).
MAX_N = {torch.float32: 160, torch.float64: 112}
# The largest n of the kernel's thread path (one thread a matrix, S and V in
# registers; PSD_NREG_* in csrc/psd_project.cu): the largest n whose
# instantiation ptxas builds without spilling.  Above it, one block a matrix.
N_REG = {torch.float32: 10, torch.float64: 7}


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


# ------------------------------------------------------ the PSD projection
def reset_launches() -> None:
    LAUNCHES["psd_project"] = 0


@functools.lru_cache(maxsize=None)
def rounds(n: int):
    """The round-robin schedule of one parallel Jacobi sweep over an n x n
    matrix: n - 1 rounds (n for odd n, which plays a dummy index n), each
    a tuple of disjoint pairs (p, q), p < q; pairs with the dummy are left
    out.  Every pair of indices meets once a sweep."""
    m = n + (n & 1)
    out = []
    for r in range(m - 1):
        pairs = []
        for k in range(m // 2):
            a, b = (r, m - 1) if k == 0 else ((r + k) % (m - 1), (r - k) % (m - 1))
            if max(a, b) < n:
                pairs.append((min(a, b), max(a, b)))
        if pairs:
            out.append(tuple(pairs))
    return tuple(out)


def _rotate(X, c, s, p, q, rest, inv, dim):
    """X with the index pairs (p, q) along ``dim`` rotated by (c, s):
    ``x_p' = c x_p - s x_q``, ``x_q' = s x_p + c x_q``."""
    cc, ss = (c[..., None, :], s[..., None, :]) if dim == -1 else (c[..., None], s[..., None])
    xp, xq = X.index_select(dim, p), X.index_select(dim, q)
    new = torch.cat([cc * xp - ss * xq, ss * xp + cc * xq, X.index_select(dim, rest)], dim)
    return new.index_select(dim, inv)


def _plan(n, device):
    eye = torch.eye(n, dtype=torch.bool, device=device)
    plan = []
    for pairs in rounds(n):
        p = [a for a, _ in pairs]
        q = [b for _, b in pairs]
        rest = [i for i in range(n) if i not in p and i not in q]
        order = p + q + rest
        inv = sorted(range(n), key=order.__getitem__)
        zero = torch.zeros((n, n), dtype=torch.bool, device=device)
        zero[p, q] = zero[q, p] = True
        diag = torch.zeros((n, n), dtype=torch.bool, device=device)
        diag[p, p] = diag[q, q] = True
        idx = [torch.tensor(i, dtype=torch.long, device=device) for i in (p, q, rest, inv)]
        plan.append((*idx, zero, diag))
    return eye, plan


def jacobi_plain(S):
    """(w, V, sweeps) of symmetric ``S`` (..., n, n): the diagonal and the
    rotations' product after parallel cyclic Jacobi, and the sweeps each
    matrix took.  Each sweep starts with the convergence test (largest
    off-diagonal magnitude at most eps times the largest diagonal one);
    a matrix that passes it, or holds a non-finite value, is left as it is
    by a mask, so nothing is read on the host.  Each round computes the
    rotations of its pairs (Golub & Van Loan, Algorithm 8.5.1) from the
    matrix at its start, rotates the columns of S and V, then the rows of
    S, and sets each pair's diagonal to its closed form and its
    off-diagonal to 0: ``csrc/psd_project.cu``'s order, operation for
    operation."""
    n = S.shape[-1]
    eye, plan = _plan(n, S.device)
    tol = torch.finfo(S.dtype).eps
    V = torch.eye(n, dtype=S.dtype, device=S.device).expand(S.shape)
    live = torch.isfinite(S).flatten(-2).all(-1)
    sweeps = torch.zeros(S.shape[:-2], dtype=torch.int32, device=S.device)
    for _ in range(MAX_SWEEPS):
        off = torch.where(eye, 0.0, S.abs()).flatten(-2).amax(-1)
        dg = S.diagonal(dim1=-2, dim2=-1).abs().amax(-1)
        active = live & ~(off <= tol * dg)
        sweeps = sweeps + active.to(torch.int32)
        act = active[..., None, None]
        for p, q, rest, inv, zero, diag in plan:
            d = S.diagonal(dim1=-2, dim2=-1)
            app, aqq, apq = d[..., p], d[..., q], S[..., p, q]
            tau = (aqq - app) / (2.0 * apq)
            t = torch.reciprocal(tau.abs() + torch.sqrt(1.0 + tau * tau))
            t = torch.where(tau >= 0, t, -t)
            t = torch.where(apq == 0, 0.0, t)
            c = torch.reciprocal(torch.sqrt(1.0 + t * t))
            s = t * c
            S1 = _rotate(S, c, s, p, q, rest, inv, -1)
            V1 = _rotate(V, c, s, p, q, rest, inv, -1)
            S2 = _rotate(S1, c, s, p, q, rest, inv, -2)
            new_d = torch.cat([app - t * apq, aqq + t * apq, d[..., rest]], -1)[..., inv]
            S2 = torch.where(zero, 0.0, S2)
            S2 = torch.where(diag, torch.diag_embed(new_d), S2)
            S = torch.where(act, S2, S)
            V = torch.where(act, V1, V)
    return S.diagonal(dim1=-2, dim2=-1), V, sweeps


def psd_project_plain(H, eps):
    """The plain version of ``psd_project``: ``S = (H + Hᵀ)/2``, its
    eigenvalues clamped at ``eps`` by ``jacobi_plain``, then ``V diag(w)
    Vᵀ`` summed over k in ascending order; a matrix with a NaN or an inf is
    all NaN."""
    _check_dtype(H)
    S = (H + H.mT) * 0.5
    w, V, _ = jacobi_plain(S)
    w = torch.clamp_min(w, eps)
    VW = V * w[..., None, :]
    P = torch.zeros_like(S)
    for k in range(S.shape[-1]):
        P = P + VW[..., :, k, None] * V[..., None, :, k]
    bad = ~torch.isfinite(S).flatten(-2).all(-1)
    # Contiguous, as the kernel's result and the op's fake one are.
    return torch.where(bad[..., None, None], torch.nan, P).contiguous()


def _check_dtype(H):
    if H.dtype not in MAX_N:
        raise TypeError(f"psd_project takes float32 or float64 matrices, not {H.dtype}")
    if H.ndim < 2 or H.shape[-1] != H.shape[-2]:
        raise ValueError(f"psd_project takes (..., n, n) matrices, not {tuple(H.shape)}")


@functools.lru_cache(maxsize=None)
def _library():
    from .. import _build

    return _build.library()


def path(n: int, dtype) -> str:
    """The kernel's path for n x n matrices of ``dtype``: ``"thread"`` (one
    thread a matrix, in registers) or ``"block"`` (one block a matrix)."""
    return "thread" if n <= N_REG[dtype] else "block"


def _launch(H, eps):
    n = H.shape[-1]
    if n > MAX_N[H.dtype]:
        raise ValueError(
            f"psd_project's kernel takes n <= {MAX_N[H.dtype]} for {H.dtype} (one block's "
            f"shared memory holds S and V), not n = {n}; use psd=\"gershgorin\"")
    H = H.contiguous()
    out = torch.empty_like(H)
    batch = H.numel() // (n * n) if n else 0
    if batch:
        with torch.cuda.device(H.device):
            stream = torch.cuda.current_stream(H.device).cuda_stream
            rc = _library().sm_psd_project_launch(
                H.data_ptr(), out.data_ptr(), batch, n, int(H.dtype == torch.float64),
                ctypes.c_double(eps), stream)
        if rc != 0:
            raise RuntimeError(f"psd_project launch failed: cudaError {rc}")
        LAUNCHES["psd_project"] += 1
    return out


def psd_project(H, eps: float):
    """The projection of the symmetric part of each matrix of ``H``
    (..., n, n) onto the PSD cone with eigenvalues at least ``eps``:
    ``V diag(max(w, eps)) Vᵀ`` of ``(H + Hᵀ)/2 = V diag(w) Vᵀ``, float32 or
    float64 (other types raise ``TypeError``).  A CUDA tensor launches
    ``csrc/psd_project.cu`` once (n above ``MAX_N`` raises ``ValueError``)
    and a CPU tensor takes ``psd_project_plain``; inside
    ``debug.interpret_kernels()`` a CUDA tensor takes the plain version too
    (counted ``interpret:psd_project``).  While a graph is traced, and for
    a CUDA tensor under a ``torch.func`` transform such as ``vmap``, the
    call is the op ``sm::psd_project`` (ops/library.py), whose batching
    rule launches the kernel once on the whole batch."""
    _check_dtype(H)
    eps = float(eps)
    device = H.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"psd_project runs on CPU or CUDA tensors, not {device}")
    plain = device.type == "cpu" or dispatch.INTERPRET.get()
    if device.type == "cuda" and plain:
        dispatch.record("interpret", "psd_project")
    elif library.tracing([H]) or torch._C._functorch.is_functorch_wrapped_tensor(H):
        return library.psd_project(H, eps)
    if plain:
        return psd_project_plain(H, eps)
    return _launch(H, eps)
