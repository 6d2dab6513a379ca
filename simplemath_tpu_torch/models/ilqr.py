"""Batched iLQR/DDP trajectory optimizer (BASELINE.json configs 3-5).

Counterpart of ``simplemath_tpu/models/ilqr.py``, as plain torch:

* rollouts and line searches are Python loops over the horizon (the JAX
  package's ``lax.scan``), their outputs stacked;
* derivatives come from ``torch.func`` (``grad``, ``jacrev``, ``jvp``),
  mapped over the horizon with ``torch.func.vmap``;
* the Riccati backward pass comes in two interchangeable forms:
  ``backward="sequential"`` (a reverse loop, O(H) depth) and
  ``backward="associative"`` (an associative scan over affine-quadratic
  value-function elements, O(log H) depth; models/scan.py);
* the forward line search evaluates ALL step sizes at once and picks the
  best improvement;
* ``solve_batched`` runs thousands of scenarios in batch-minor layout
  (ops/soa.py).

Nothing in ``solve``/``solve_batched`` reads a value back to the host:
accepts, regularization and the line search's choice are tensor selects,
and the iteration count is static.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
from torch.func import grad, jacrev, jvp, vmap

from ..ops import soa
from ..ops.linalg_small import inv_unrolled
from ..utils.precision import f32_matmuls
from .dynamics import System, _constant
from .scan import associative_scan


@dataclasses.dataclass(frozen=True)
class ILQRConfig:
    iterations: int = 10
    # Parallel line search step sizes (all evaluated at once).
    alphas: tuple = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01)
    reg_init: float = 1e-6
    reg_scale_up: float = 10.0
    reg_scale_down: float = 0.5
    reg_max: float = 1e8
    backward: str = "sequential"  # or "associative"
    # PSD-ization of per-step cost Hessians (nonconvex costs make lxx
    # indefinite, which NaNs the Riccati Cholesky):
    #   "auto"       — "clamp_diag" for separable-cost systems, else "eigh";
    #   "clamp_diag" — clamp diagonal entries at eps (EXACT projection when
    #                  Hessians are diagonal, i.e. separable costs);
    #   "eigh"       — exact projection onto the PSD cone (batched eigh);
    #   "gershgorin" — Gershgorin lower-bound shift (cheap, conservative —
    #                  can over-damp);
    #   "none"       — disabled (convex costs only).
    psd: str = "auto"
    psd_eps: float = 1e-6


class ILQRResult(NamedTuple):
    xs: torch.Tensor  # (H+1, nx)
    us: torch.Tensor  # (H, nu)
    cost: torch.Tensor  # scalar final cost
    cost_trace: torch.Tensor  # (iterations,)
    grad_norm: torch.Tensor  # scalar, |k| of last backward pass


def _take(x, i):
    """``x[i]`` along dim 0 for a 0-d index tensor, on the device (indexing
    with a 0-d tensor would read it back to the host)."""
    return x.index_select(0, i.reshape(1))[0]


def _finite_norm(x):
    """``jnp.nan_to_num(x, nan=jnp.inf)``: NaN reads +inf, and +inf the
    type's largest finite value, so NaN reads ``finfo.max`` as +inf does
    (``torch.nan_to_num(nan=inf)`` would leave +inf)."""
    return torch.nan_to_num(x, nan=torch.finfo(x.dtype).max)


def rollout(step: Callable, x0, us):
    """Open-loop rollout: xs[0]=x0, xs[t+1]=step(xs[t], us[t])."""
    xs = [x0]
    for t in range(us.shape[0]):
        xs.append(step(xs[-1], us[t]))
    return torch.stack(xs)


def trajectory_cost(system: System, xs, us):
    stage = vmap(system.stage_cost)(xs[:-1], us)
    return torch.sum(stage) + system.final_cost(xs[-1])


@f32_matmuls
def linearize(system: System, xs, us):
    """Per-step Jacobians of dynamics and gradients/Hessians of cost,
    mapped over the horizon.

    Reverse mode throughout, where the JAX package takes ``jacfwd`` and
    ``hessian`` (forward over reverse): the values are the same
    derivatives, but ``torch.func.jvp`` gives a float64 tangent where a 0-d
    float32 tensor meets a Python float (``x[0] - math.pi`` on a state of
    shape (nx,)), and would run the dynamics' derivatives in float64."""
    A = vmap(jacrev(system.step, argnums=0))(xs[:-1], us)
    B = vmap(jacrev(system.step, argnums=1))(xs[:-1], us)
    lx = vmap(grad(system.stage_cost, argnums=0))(xs[:-1], us)
    lu = vmap(grad(system.stage_cost, argnums=1))(xs[:-1], us)
    lxx = vmap(jacrev(grad(system.stage_cost, argnums=0), argnums=0))(xs[:-1], us)
    luu = vmap(jacrev(grad(system.stage_cost, argnums=1), argnums=1))(xs[:-1], us)
    lux = vmap(jacrev(grad(system.stage_cost, argnums=1), argnums=0))(xs[:-1], us)
    Vx_T = grad(system.final_cost)(xs[-1])
    Vxx_T = jacrev(grad(system.final_cost))(xs[-1])
    return A, B, lx, lu, lxx, luu, lux, Vx_T, Vxx_T


@f32_matmuls
def linearize_soa(system: System, xs, us):
    """Batched linearization in batch-minor layout.

    Same outputs as ``vmap(linearize)``, batch-leading (Bb, H, ...) tensors,
    but computed with the (time x scenario) product as the minor axes:
    every point is independent, so Jacobian/Hessian columns come from nx+nu
    ``jvp`` seed directions evaluated over ALL (H, Bb) points at once
    (forward-over-reverse for the Hessians).  Requires
    ``system.batch_polymorphic``.
    """
    nx, nu = system.nx, system.nu
    # (Bb, H, n) -> (n, H, Bb)
    x_st = xs[:, :-1, :].permute(2, 1, 0)
    u_st = us.permute(2, 1, 0)
    xT = xs[:, -1, :].permute(1, 0)  # (nx, Bb)

    def seed(n, i, template):
        # One-hot direction i, built on the template's device.
        e = torch.eye(n, dtype=template.dtype, device=template.device)[i]
        return e.reshape((n,) + (1,) * (template.ndim - 1)).expand(template.shape)

    # Dynamics Jacobians: column i of A is d step / d x_i at every point.
    A_cols = [
        jvp(lambda x: system.step(x, u_st), (x_st,), (seed(nx, i, x_st),))[1]
        for i in range(nx)
    ]
    B_cols = [
        jvp(lambda u: system.step(x_st, u), (u_st,), (seed(nu, j, u_st),))[1]
        for j in range(nu)
    ]
    A = torch.stack(A_cols, dim=1)  # (nx, nx, H, Bb)
    B = torch.stack(B_cols, dim=1)  # (nx, nu, H, Bb)

    # Cost gradients: stage cost is separable across points, so the grad of
    # the summed cost IS the per-point gradient stack.
    def csum(x, u):
        return torch.sum(system.stage_cost(x, u))

    grad_c = grad(csum, argnums=(0, 1))
    lx, lu = grad_c(x_st, u_st)  # (nx, H, Bb), (nu, H, Bb)

    # Hessian columns: forward-over-reverse jvp of the gradient.
    lxx_cols, lux_cols = [], []
    for i in range(nx):
        _, (dgx, dgu) = jvp(lambda x: grad_c(x, u_st), (x_st,), (seed(nx, i, x_st),))
        lxx_cols.append(dgx)  # (nx, H, Bb) = lxx[:, i]
        lux_cols.append(dgu)  # (nu, H, Bb) = lux[:, i]
    luu_cols = [
        jvp(lambda u: grad_c(x_st, u), (u_st,), (seed(nu, j, u_st),))[1][1]
        for j in range(nu)
    ]
    lxx = torch.stack(lxx_cols, dim=1)  # (nx, nx, H, Bb)
    lux = torch.stack(lux_cols, dim=1)  # (nu, nx, H, Bb)
    luu = torch.stack(luu_cols, dim=1)  # (nu, nu, H, Bb)

    # Terminal value expansion at xs[:, -1].
    def fsum(x):
        return torch.sum(system.final_cost(x))

    Vx_T = grad(fsum)(xT)  # (nx, Bb)
    VxxT_cols = [jvp(grad(fsum), (xT,), (seed(nx, i, xT),))[1] for i in range(nx)]
    Vxx_T = torch.stack(VxxT_cols, dim=1)  # (nx, nx, Bb)

    # Back to the batch-leading interface shared with vmap(linearize).
    def m4(a):  # (n, m, H, Bb) -> (Bb, H, n, m)
        return a.permute(3, 2, 0, 1)

    def m3(a):  # (n, H, Bb) -> (Bb, H, n)
        return a.permute(2, 1, 0)

    return (
        m4(A), m4(B), m3(lx), m3(lu), m4(lxx), m4(luu), m4(lux),
        Vx_T.permute(1, 0), Vxx_T.permute(2, 0, 1),
    )


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _gershgorin_shift(H, eps):
    """Shift H by max(0, -Gershgorin lower bound) + eps so it is PD.

    lambda_min >= min_i (H_ii - sum_{j!=i} |H_ij|); one reduction per
    matrix, no factorization."""
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    offsum = torch.sum(torch.abs(H), dim=-1) - torch.abs(diag)
    lb = torch.amin(diag - offsum, dim=-1)
    shift = torch.clamp_min(-lb, 0.0) + eps
    return H + shift[..., None, None] * _eye(H.shape[-1], H)


def _eigh_project(H, eps):
    """Exact projection onto the PSD cone (eigenvalue clamping)."""
    w, V = torch.linalg.eigh(H)
    w = torch.clamp_min(w, eps)
    return (V * w[..., None, :]) @ V.mT


def _clamp_diag(H, eps):
    """Clamp diagonal entries at eps: exact PSD projection for diagonal
    Hessians (separable costs), an approximation otherwise."""
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    bump = torch.clamp_min(eps - diag, 0.0)
    return H + bump[..., None] * _eye(H.shape[-1], H)


def psd_cost_hessians(lxx, luu, lux, Vxx_T, mode: str, eps: float):
    """PSD-ize the per-step joint cost Hessian [[lxx, lux^T], [lux, luu]]
    and the terminal Hessian, preserving gradients (only curvature moves)."""
    if mode == "none":
        return lxx, luu, lux, Vxx_T
    if mode == "clamp_diag":
        return (
            _clamp_diag(lxx, eps),
            _clamp_diag(luu, eps),
            lux,
            _clamp_diag(Vxx_T, eps),
        )
    nx = lxx.shape[-1]
    top = torch.cat([lxx, lux.mT], dim=-1)
    bot = torch.cat([lux, luu], dim=-1)
    blk = torch.cat([top, bot], dim=-2)
    if mode == "eigh":
        blk = _eigh_project(blk, eps)
        Vxx_T = _eigh_project(Vxx_T, eps)
    else:
        blk = _gershgorin_shift(blk, eps)
        Vxx_T = _gershgorin_shift(Vxx_T, eps)
    lxx = blk[..., :nx, :nx]
    lux = blk[..., nx:, :nx]
    luu = blk[..., nx:, nx:]
    return lxx, luu, lux, Vxx_T


def _solve_psd(M, rhs):
    """Solve M X = rhs for symmetric positive-definite M via Cholesky.

    A factor that fails (M not PD) is all NaN, as ``jnp.linalg.cholesky``
    gives it: ``torch.linalg.cholesky`` would raise (and on the card wait
    for the answer), ``cholesky_ex`` returns a finite factor of garbage
    with ``info > 0``.  The NaN gains then make the step's rollout
    non-finite, the solve rejects it and raises ``reg``.  A vector ``rhs``
    is solved as a one-column matrix."""
    L, info = torch.linalg.cholesky_ex(M)
    L = torch.where((info != 0)[..., None, None], torch.nan, L)
    vec = rhs.ndim == M.ndim - 1
    B = rhs[..., None] if vec else rhs
    y = torch.linalg.solve_triangular(L, B, upper=False)
    X = torch.linalg.solve_triangular(L.mT, y, upper=True)
    return X[..., 0] if vec else X


@f32_matmuls
def backward_sequential(A, B, lx, lu, lxx, luu, lux, Vx_T, Vxx_T, reg):
    """Classic Riccati/DDP backward pass as a reverse loop."""
    nu = B.shape[-1]
    I_u = _eye(nu, B)
    H = A.shape[0]
    Vx, Vxx = Vx_T, Vxx_T
    ks, Ks = [None] * H, [None] * H
    for t in reversed(range(H)):
        A_t, B_t, lx_t, lu_t = A[t], B[t], lx[t], lu[t]
        lxx_t, luu_t, lux_t = lxx[t], luu[t], lux[t]
        Qx = lx_t + A_t.mT @ Vx
        Qu = lu_t + B_t.mT @ Vx
        Qxx = lxx_t + A_t.mT @ Vxx @ A_t
        Quu = luu_t + B_t.mT @ Vxx @ B_t + reg * I_u
        Qux = lux_t + B_t.mT @ Vxx @ A_t
        k_t = -_solve_psd(Quu, Qu)
        K_t = -_solve_psd(Quu, Qux)
        Vx = Qx + K_t.mT @ Quu @ k_t + K_t.mT @ Qu + Qux.mT @ k_t
        Vxx = Qxx + K_t.mT @ Quu @ K_t + K_t.mT @ Qux + Qux.mT @ K_t
        Vxx = 0.5 * (Vxx + Vxx.mT)
        ks[t], Ks[t] = k_t, K_t
    return torch.stack(ks), torch.stack(Ks)


@f32_matmuls
def backward_sequential_soa(A, B, lx, lu, lxx, luu, lux, Vx_T, Vxx_T, reg):
    """Batched Riccati backward pass in batch-minor (SoA) layout.

    Same recursion as :func:`backward_sequential`, but over a whole scenario
    batch at once: inputs are batch-LEADING ``(Bb, H, ...)`` tensors (as
    produced by a mapped linearize) and ``reg`` is per-scenario ``(Bb,)``.
    Internally every small matrix becomes an ``(n, m, Bb)`` stack (ops/soa.py).

    The Cholesky solve of the single-scenario path becomes an unrolled
    Gauss-Jordan inverse (closed-form for nu <= 2); Quu is PD by
    construction here (psd_cost_hessians + reg), where pivoting would
    matter it returns inf/nan and the NaN-robust accept in
    :func:`solve_batched` rejects the step.
    """
    nu = B.shape[-1]

    def tr(x):  # (Bb, H, n, m) -> (H, n, m, Bb)
        return torch.movedim(x, 0, -1)

    A_, B_, lxx_, luu_, lux_, lx_, lu_ = map(tr, (A, B, lxx, luu, lux, lx, lu))
    eye_u = soa.eye_like(nu, B_)
    H = A_.shape[0]
    Vx, Vxx = tr(Vx_T), tr(Vxx_T)
    ks, Ks = [None] * H, [None] * H
    for t in reversed(range(H)):
        A_t, B_t, lx_t, lu_t = A_[t], B_[t], lx_[t], lu_[t]
        lxx_t, luu_t, lux_t = lxx_[t], luu_[t], lux_[t]
        At, Bt = soa.transpose(A_t), soa.transpose(B_t)
        VxxA = soa.matmul(Vxx, A_t)
        VxxB = soa.matmul(Vxx, B_t)
        Qx = lx_t + soa.matvec(At, Vx)
        Qu = lu_t + soa.matvec(Bt, Vx)
        Qxx = lxx_t + soa.matmul(At, VxxA)
        Quu = luu_t + soa.matmul(Bt, VxxB) + reg * eye_u
        Qux = lux_t + soa.matmul(Bt, VxxA)
        Quu_inv = soa.inv(Quu)
        k_t = -soa.matvec(Quu_inv, Qu)
        K_t = -soa.matmul(Quu_inv, Qux)
        Kt = soa.transpose(K_t)
        Quxt = soa.transpose(Qux)
        Vx = (
            Qx
            + soa.matvec(Kt, soa.matvec(Quu, k_t))
            + soa.matvec(Kt, Qu)
            + soa.matvec(Quxt, k_t)
        )
        Vxx = (
            Qxx
            + soa.matmul(Kt, soa.matmul(Quu, K_t))
            + soa.matmul(Kt, Qux)
            + soa.matmul(Quxt, K_t)
        )
        Vxx = 0.5 * (Vxx + soa.transpose(Vxx))
        ks[t], Ks[t] = k_t, K_t

    def back(x):  # (H, n[, m], Bb) -> (Bb, H, n[, m])
        return torch.movedim(x, -1, 0)

    return back(torch.stack(ks)), back(torch.stack(Ks))


def riccati_make_elem(inp, reg, I_u):
    """Per-step conditional-value element (F, c, C, eta, J): step k's
    quadratic with u eliminated against its own stage quadratic
    (temporal-parallelization-of-LQT formulation)."""
    A_t, B_t, lx_t, lu_t, lxx_t, luu_t, lux_t = inp
    Ru = luu_t + reg * I_u
    Ru_inv_lux = _solve_psd(Ru, lux_t)
    Ru_inv_lu = _solve_psd(Ru, lu_t)
    Ru_inv_Bt = _solve_psd(Ru, B_t.mT)
    F = A_t - B_t @ Ru_inv_lux
    c = -B_t @ Ru_inv_lu
    C = B_t @ Ru_inv_Bt
    J = lxx_t - lux_t.mT @ Ru_inv_lux
    eta = -(lx_t - lux_t.mT @ Ru_inv_lu)
    return F, c, C, eta, J


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def riccati_combine(elem_i, elem_j, I_x):
    """Associative composition: ``elem_i`` is earlier in time; ``elem_j``
    aggregates the later suffix.  Applied with a leading batch axis, so all
    products are batched matmuls and vectors use explicit [..., None].

    The identity element (F=I, c=0, C=0, eta=0, J=0) is a two-sided unit,
    :func:`riccati_identity`."""
    Fi, ci, Ci, etai, Ji = elem_i
    Fj, cj, Cj, etaj, Jj = elem_j
    # M = (I + Ci Jj)^{-1}; N = (I + Jj Ci)^{-1}: unrolled inverses
    # (ops/linalg_small.py).
    M = inv_unrolled(I_x + Ci @ Jj)
    N = inv_unrolled(I_x + Jj @ Ci)
    F = Fj @ M @ Fi
    c = _mv(Fj @ M, ci + _mv(Ci, etaj)) + cj
    C = Fj @ M @ Ci @ Fj.mT + Cj
    eta = _mv(Fi.mT @ N, etaj - _mv(Jj, ci)) + etai
    J = Fi.mT @ N @ Jj @ Fi + Ji
    return F, c, C, eta, J


def riccati_identity(nx, dtype, device=None):
    """Two-sided unit of :func:`riccati_combine`."""
    return (
        torch.eye(nx, dtype=dtype, device=device),
        torch.zeros((nx,), dtype=dtype, device=device),
        torch.zeros((nx, nx), dtype=dtype, device=device),
        torch.zeros((nx,), dtype=dtype, device=device),
        torch.zeros((nx, nx), dtype=dtype, device=device),
    )


def riccati_gains(inp, Vx, Vxx, reg, I_u):
    """Per-step feedback gains from the step-(k+1) value function —
    identical to the sequential pass's stage equations."""
    A_t, B_t, lx_t, lu_t, lxx_t, luu_t, lux_t = inp
    Qu = lu_t + B_t.mT @ Vx
    Quu = luu_t + B_t.mT @ Vxx @ B_t + reg * I_u
    Qux = lux_t + B_t.mT @ Vxx @ A_t
    k_t = -_solve_psd(Quu, Qu)
    K_t = -_solve_psd(Quu, Qux)
    return k_t, K_t


def _flip(elems):
    return tuple(torch.flip(x, [0]) for x in elems)


def riccati_suffix_scan(full, I_x):
    """Suffix-composition scan over a time-leading element tuple:
    ``out[k] = elem_k ⊕ elem_{k+1} ⊕ … ⊕ elem_last``."""
    # Reverse the time axis so the scan accumulates suffixes k..T.  In the
    # reversed order, scan-"left" operands are LATER in time, so flip the
    # operator's arguments: prefix_rev[j] = elem_{T-j} ⊕ (later suffix).
    scanned = associative_scan(lambda a, b: riccati_combine(b, a, I_x), _flip(full))
    return _flip(scanned)


@f32_matmuls
def backward_associative(
    A, B, lx, lu, lxx, luu, lux, Vx_T, Vxx_T, reg, return_values=False
):
    """Riccati backward pass as an associative scan over value elements.

    Each step k contributes a conditional-value element ``(F, c, C, eta,
    J)`` encoding ``V_k(x) = min_u [cost + V_{k+1}(f(x,u))]`` after
    eliminating ``u`` against its own stage quadratic; elements compose
    associatively, so the whole horizon reduces in O(log H) depth.  The
    suffix composed from k carries ``J_k = Vxx_k`` and ``eta_k = -Vx_k``,
    from which the per-step gains are recovered as in the sequential pass.
    """
    nu = B.shape[-1]
    nx = A.shape[-1]
    I_u = _eye(nu, B)
    I_x = _eye(nx, A)

    # Per-step elimination of u against the stage quadratic (luu + reg):
    #   F = A - B luu^{-1} lux,  c = -B luu^{-1} lu,  C = B luu^{-1} B^T,
    #   J = lxx - lux^T luu^{-1} lux,  eta = -(lx - lux^T luu^{-1} lu)
    elems = vmap(lambda inp: riccati_make_elem(inp, reg, I_u))(
        (A, B, lx, lu, lxx, luu, lux)
    )

    # Terminal element: pure quadratic terminal cost.
    zmat = torch.zeros((nx, nx), dtype=A.dtype, device=A.device)
    zvec = torch.zeros((nx,), dtype=A.dtype, device=A.device)
    term = (zmat, zvec, zmat, -Vx_T, Vxx_T)
    full = tuple(torch.cat([e, t[None]]) for e, t in zip(elems, term))

    suffix = riccati_suffix_scan(full, I_x)

    # suffix[k+1] carries (eta, J) of the value function at step k+1.
    Vx_all = -suffix[3]  # (H+1, nx)
    Vxx_all = suffix[4]  # (H+1, nx, nx)

    ks, Ks = vmap(lambda inp, Vx, Vxx: riccati_gains(inp, Vx, Vxx, reg, I_u))(
        (A, B, lx, lu, lxx, luu, lux), Vx_all[1:], Vxx_all[1:]
    )
    if return_values:
        return ks, Ks, Vx_all, Vxx_all
    return ks, Ks


@f32_matmuls
def backward_associative_soa(
    A, B, lx, lu, lxx, luu, lux, Vx_T, Vxx_T, reg, return_values=False
):
    """Batched O(log H) Riccati backward pass in batch-minor (SoA) layout.

    Same value-element formulation as :func:`backward_associative`, but over
    a whole scenario batch at once: inputs are batch-leading ``(Bb, H, ...)``
    tensors and ``reg`` is per-scenario ``(Bb,)``.  Elements are built as
    ``(H+1, n, m, Bb)`` stacks; the soa ops index matrix dims from the
    right, so the combine maps over the time axis as it stands.
    """
    nu = B.shape[-1]
    nx = A.shape[-1]

    def tr0(x):  # batch-leading -> batch-minor
        return torch.movedim(x, 0, -1)

    A_, B_, lxx_, luu_, lux_, lx_, lu_ = map(tr0, (A, B, lxx, luu, lux, lx, lu))
    VxT_ = tr0(Vx_T)  # (nx, Bb)
    VxxT_ = tr0(Vxx_T)  # (nx, nx, Bb)
    eye_u = soa.eye_like(nu, B_)
    eye_x = soa.eye_like(nx, A_)
    Bb = A_.shape[-1]

    # Per-step elements over the whole horizon at once (leading H axis).
    Ru = luu_ + reg * eye_u
    Ru_inv = soa.inv(Ru)
    Ru_inv_lux = soa.matmul(Ru_inv, lux_)
    Ru_inv_lu = soa.matvec(Ru_inv, lu_)
    Ru_inv_Bt = soa.matmul(Ru_inv, soa.transpose(B_))
    luxT = soa.transpose(lux_)
    F = A_ - soa.matmul(B_, Ru_inv_lux)  # (H, nx, nx, Bb)
    c = -soa.matvec(B_, Ru_inv_lu)  # (H, nx, Bb)
    C = soa.matmul(B_, Ru_inv_Bt)  # (H, nx, nx, Bb)
    J = lxx_ - soa.matmul(luxT, Ru_inv_lux)
    eta = -(lx_ - soa.matvec(luxT, Ru_inv_lu))

    zmat = torch.zeros((1, nx, nx, Bb), dtype=A.dtype, device=A.device)
    zvec = torch.zeros((1, nx, Bb), dtype=A.dtype, device=A.device)
    full = (
        torch.cat([F, zmat]),
        torch.cat([c, zvec]),
        torch.cat([C, zmat]),
        torch.cat([eta, -VxT_[None]]),
        torch.cat([J, VxxT_[None]]),
    )

    def combine(elem_i, elem_j):
        # elem_i earlier in time, elem_j the later suffix; tensors carry a
        # leading scan axis which the right-indexed soa ops pass through.
        Fi, ci, Ci, etai, Ji = elem_i
        Fj, cj, Cj, etaj, Jj = elem_j
        M = soa.inv(eye_x + soa.matmul(Ci, Jj))
        N = soa.inv(eye_x + soa.matmul(Jj, Ci))
        FjM = soa.matmul(Fj, M)
        FiTN = soa.matmul(soa.transpose(Fi), N)
        F = soa.matmul(FjM, Fi)
        c = soa.matvec(FjM, ci + soa.matvec(Ci, etaj)) + cj
        C = soa.matmul(FjM, soa.matmul(Ci, soa.transpose(Fj))) + Cj
        eta = soa.matvec(FiTN, etaj - soa.matvec(Jj, ci)) + etai
        J = soa.matmul(FiTN, soa.matmul(Jj, Fi)) + Ji
        return F, c, C, eta, J

    suffix = _flip(associative_scan(lambda a, b: combine(b, a), _flip(full)))

    Vx_all = -suffix[3]  # (H+1, nx, Bb)
    Vxx_all = suffix[4]  # (H+1, nx, nx, Bb)

    # Per-step gains from the step-(k+1) value, over the whole horizon.
    Vx1, Vxx1 = Vx_all[1:], Vxx_all[1:]
    Bt = soa.transpose(B_)
    Qu = lu_ + soa.matvec(Bt, Vx1)
    Quu = luu_ + soa.matmul(Bt, soa.matmul(Vxx1, B_)) + reg * eye_u
    Qux = lux_ + soa.matmul(Bt, soa.matmul(Vxx1, A_))
    Quu_inv = soa.inv(Quu)
    ks = -soa.matvec(Quu_inv, Qu)
    Ks = -soa.matmul(Quu_inv, Qux)

    def back(x):  # batch-minor -> batch-leading
        return torch.movedim(x, -1, 0)

    if return_values:
        return back(ks), back(Ks), back(Vx_all), back(Vxx_all)
    return back(ks), back(Ks)


def feedback_rollout(system: System, xs, us, ks, Ks, alpha):
    """Closed-loop rollout around the nominal (xs, us) with step ``alpha``:
    u_t = us_t + alpha k_t + K_t (x_t - xs_t).  Returns (xs_new, us_new)."""
    x = xs[0]
    xs_new, us_new = [x], []
    for t in range(us.shape[0]):
        u = us[t] + alpha * ks[t] + Ks[t] @ (x - xs[t])
        x = system.step(x, u)
        xs_new.append(x)
        us_new.append(u)
    return torch.stack(xs_new), torch.stack(us_new)


@f32_matmuls
def forward_linesearch(system: System, xs, us, ks, Ks, alphas):
    """Closed-loop rollouts at every alpha at once; returns the best."""
    alphas = _constant(tuple(map(float, alphas)), us.dtype, us.device)

    def rollout_alpha(alpha):
        xs_new, us_new = feedback_rollout(system, xs, us, ks, Ks, alpha)
        return xs_new, us_new, trajectory_cost(system, xs_new, us_new)

    xs_c, us_c, costs = vmap(rollout_alpha)(alphas)
    best = torch.argmin(costs)
    return _take(xs_c, best), _take(us_c, best), _take(costs, best)


@f32_matmuls
def forward_linesearch_soa(system: System, xs, us, ks, Ks, alphas):
    """Batched closed-loop line search in batch-minor layout.

    Same semantics as ``vmap(forward_linesearch)`` over a scenario batch,
    but states are carried as ``(nx, n_alpha, Bb)`` stacks (requires
    ``system.batch_polymorphic``).  Inputs/outputs are batch-leading: xs
    (Bb, H+1, nx), us (Bb, H, nu), ks (Bb, H, nu), Ks (Bb, H, nu, nx).
    """
    nA = len(alphas)
    # (nA, 1) broadcasts against (nA, Bb)
    al = _constant(tuple(map(float, alphas)), us.dtype, us.device)[:, None]
    # (Bb, H, ...) -> (H, ..., Bb): one boundary move each.
    xs_, us_, ks_, Ks_ = (torch.movedim(a, 0, -1) for a in (xs, us, ks, Ks))
    nx, nu = xs_.shape[1], us_.shape[1]

    x = xs_[0][:, None, :].expand(nx, nA, xs_.shape[2])  # (nx, nA, Bb)
    cost = torch.zeros((nA, xs.shape[0]), dtype=xs.dtype, device=xs.device)
    xs_tail, us_new = [], []
    for t in range(us_.shape[0]):
        x_ref, u_ref, k_t, K_t = xs_[t], us_[t], ks_[t], Ks_[t]
        dx = x - x_ref[:, None, :]  # (nx, nA, Bb)
        # u = u_ref + alpha*k + K @ dx, all (nu, nA, Bb)
        u = torch.stack(
            [
                u_ref[i][None, :]
                + al * k_t[i][None, :]
                + sum(K_t[i, j][None, :] * dx[j] for j in range(nx))
                for i in range(nu)
            ]
        )
        cost = cost + system.stage_cost(x, u)  # (nA, Bb)
        x = system.step(x, u)
        xs_tail.append(x)
        us_new.append(u)
    costs = cost + system.final_cost(x)  # (nA, Bb)
    best = torch.argmin(costs, dim=0)  # (Bb,)

    def pick(stacked):  # (H, d, nA, Bb) -> (Bb, H, d)
        g = torch.take_along_dim(stacked, best[None, None, None, :], dim=2)
        return torch.movedim(g[:, :, 0, :], -1, 0)

    xs_best = pick(torch.stack(xs_tail))
    us_best = pick(torch.stack(us_new))
    xs_new = torch.cat([xs[:, :1], xs_best], dim=1)
    cost_best = torch.take_along_dim(costs, best[None, :], dim=0)[0]
    return xs_new, us_best, cost_best


def _psd_mode(config: ILQRConfig, system: System) -> str:
    if config.psd == "auto":
        return "clamp_diag" if system.separable_cost else "eigh"
    return config.psd


def _next_reg(improved, reg, config):
    return torch.where(
        improved,
        torch.clamp_min(reg * config.reg_scale_down, config.reg_init),
        torch.clamp_max(reg * config.reg_scale_up, config.reg_max),
    )


@f32_matmuls
def solve(
    system: System,
    x0,
    us_init,
    config: ILQRConfig = ILQRConfig(),
) -> ILQRResult:
    """Single-scenario iLQR solve (static iteration count, no host round
    trip)."""
    backward = (
        backward_associative
        if config.backward == "associative"
        else backward_sequential
    )
    psd_mode = _psd_mode(config, system)

    xs = rollout(system.step, x0, us_init)
    us = us_init
    cost = trajectory_cost(system, xs, us_init)
    reg = torch.full((), config.reg_init, dtype=xs.dtype, device=xs.device)
    cost_trace, grad_norm = [], None
    for _ in range(config.iterations):
        A, B, lx, lu, lxx, luu, lux, Vx_T, Vxx_T = linearize(system, xs, us)
        lxx, luu, lux, Vxx_T = psd_cost_hessians(
            lxx, luu, lux, Vxx_T, psd_mode, config.psd_eps
        )
        ks, Ks = backward(A, B, lx, lu, lxx, luu, lux, Vx_T, Vxx_T, reg)
        xs_new, us_new, cost_new = forward_linesearch(
            system, xs, us, ks, Ks, config.alphas
        )
        # NaN-robust accept: an indefinite Quu makes the Cholesky emit NaNs
        # and the candidate rollout non-finite; reject it and retry with a
        # larger regularizer next iteration (standard iLQR reg escalation).
        improved = torch.isfinite(cost_new) & (cost_new < cost)
        xs = torch.where(improved, xs_new, xs)
        us = torch.where(improved, us_new, us)
        reg = _next_reg(improved, reg, config)
        cost = torch.where(improved, cost_new, cost)
        grad_norm = _finite_norm(torch.amax(torch.abs(ks)))
        cost_trace.append(cost)
    return ILQRResult(
        xs=xs, us=us, cost=cost, cost_trace=torch.stack(cost_trace), grad_norm=grad_norm
    )


@f32_matmuls
def solve_batched(
    system: System, x0_batch, us_init_batch, config: ILQRConfig = ILQRConfig()
) -> ILQRResult:
    """Batched solve over the scenario axis (BASELINE.json configs 3-4).

    Rollout and cost map over scenarios.  For batch-polymorphic systems the
    linearization and the line search run batch-minor
    (:func:`linearize_soa`, :func:`forward_linesearch_soa`), else mapped
    over scenarios.  The Riccati backward pass runs in batch-minor layout
    (:func:`backward_sequential_soa`, or :func:`backward_associative_soa`
    for ``backward="associative"``).  Semantics match ``vmap(solve)`` up to
    float32 summation order.
    """
    backward_b = (
        backward_associative_soa
        if config.backward == "associative"
        else backward_sequential_soa
    )
    rollout_b = vmap(lambda x0, us: rollout(system.step, x0, us))
    cost_b = vmap(lambda xs, us: trajectory_cost(system, xs, us))
    if system.batch_polymorphic:
        def lin_b(xs, us):
            return linearize_soa(system, xs, us)

        def fwd_b(xs, us, ks, Ks):
            return forward_linesearch_soa(system, xs, us, ks, Ks, config.alphas)
    else:
        lin_b = vmap(lambda xs, us: linearize(system, xs, us))
        fwd_b = vmap(
            lambda xs, us, ks, Ks: forward_linesearch(
                system, xs, us, ks, Ks, config.alphas
            )
        )
    psd_mode = _psd_mode(config, system)

    xs = rollout_b(x0_batch, us_init_batch)
    us = us_init_batch
    cost = cost_b(xs, us)  # (Bb,)
    reg = torch.full(cost.shape, config.reg_init, dtype=xs.dtype, device=xs.device)
    cost_trace, grad_norm = [], None
    for _ in range(config.iterations):
        A, B, lx, lu, lxx, luu, lux, Vx_T, Vxx_T = lin_b(xs, us)
        lxx, luu, lux, Vxx_T = psd_cost_hessians(
            lxx, luu, lux, Vxx_T, psd_mode, config.psd_eps
        )
        ks, Ks = backward_b(A, B, lx, lu, lxx, luu, lux, Vx_T, Vxx_T, reg)
        xs_new, us_new, cost_new = fwd_b(xs, us, ks, Ks)
        improved = torch.isfinite(cost_new) & (cost_new < cost)
        xs = torch.where(improved[:, None, None], xs_new, xs)
        us = torch.where(improved[:, None, None], us_new, us)
        reg = _next_reg(improved, reg, config)
        cost = torch.where(improved, cost_new, cost)
        grad_norm = _finite_norm(torch.amax(torch.abs(ks), dim=(1, 2)))
        cost_trace.append(cost)
    # Batch-leading result fields; cost_trace comes out (Bb, iters).
    return ILQRResult(
        xs=xs, us=us, cost=cost, cost_trace=torch.stack(cost_trace, dim=1),
        grad_norm=grad_norm,
    )


# The JAX package's jitted alias; the port has no compiled variant.
solve_batched_jit = solve_batched
