"""Horizon (sequence) parallelism: the Riccati suffix scan sharded over a
mesh axis.

Counterpart of ``simplemath_tpu/parallel/horizon.py``.
``models.ilqr.backward_associative`` gives O(log H) depth on one device;
here the time axis itself is sharded over a mesh axis, and the associative
scan becomes the blocked formulation:

1. each rank suffix-scans its local block of value elements,
2. block totals are ``all_gather``-ed over the axis (one small collective:
   D elements of (nx² + nx)-sized tuples),
3. every rank composes the totals of all *later* blocks (exclusive suffix,
   identical on all ranks),
4. local results are corrected by one composition with that exclusive
   suffix.

The element algebra's two-sided identity (``riccati_identity``) pads H+1 to
a multiple of the axis size and serves as the "no later block" suffix, so
any horizon length works on any mesh.

``riccati_combine`` broadcasts over leading dimensions, so the batched
scan carries the scenario batch as a dimension behind time, where the JAX
package vmaps the per-device body.
"""

from __future__ import annotations

import torch

from ..models import ilqr as _ilqr
from ..utils.precision import f32_matmuls
from . import collectives
from .mesh import Mesh, PartitionSpec as P


def _pad_to_multiple(tree, n_have: int, multiple: int, ident, axis: int = 0):
    """Pad each leaf's ``axis`` from n_have to the next multiple with
    broadcast copies of the identity element."""
    pad = (-n_have) % multiple
    if pad == 0:
        return tree, 0

    def _pad_leaf(x, i):
        lead = tuple(x.shape[:axis])
        block = torch.broadcast_to(i, lead + (pad,) + tuple(i.shape))
        return torch.cat([x, block], dim=axis)

    return tuple(_pad_leaf(x, i) for x, i in zip(tree, ident)), pad


def _block_suffix(local, axis_name: str, ident, I_x):
    """Per-rank body of the blocked suffix scan: time-leading leaves, any
    dimensions behind time carried along by the combine's broadcasting."""
    # 1. local suffix scan
    local_suffix = _ilqr.riccati_suffix_scan(local, I_x)
    # 2. gather block totals (the only communication): leading (D, ...)
    totals = tuple(collectives.all_gather(x[0], axis_name, tiled=False)
                   for x in local_suffix)
    # 3. exclusive suffix of LATER blocks; identity for the last block
    sfx = _ilqr.riccati_suffix_scan(totals, I_x)
    sfx = tuple(torch.cat([s, torch.broadcast_to(i, s.shape[1:])[None]])
                for s, i in zip(sfx, ident))
    d = collectives.axis_index(axis_name).to(device=sfx[0].device, dtype=torch.long)
    S = tuple(torch.index_select(s, 0, (d + 1).reshape(1))[0] for s in sfx)
    # 4. one correction composition per local element
    return _ilqr.riccati_combine(local_suffix, S, I_x)


@f32_matmuls
def sharded_suffix_scan(mesh: Mesh, axis_name: str, full, nx: int, dtype):
    """Blocked associative suffix scan of a time-leading element tuple,
    sharded over ``axis_name``.  Returns the (unpadded) suffix tuple with
    the same global length as ``full``."""
    n = full[0].shape[0]
    D = mesh.shape[axis_name]
    device = full[0].device
    ident = _ilqr.riccati_identity(nx, dtype, device)
    padded, _ = _pad_to_multiple(full, n, D, ident)
    I_x = torch.eye(nx, dtype=dtype, device=device)

    out = collectives.shard_map(
        lambda *local: _block_suffix(local, axis_name, ident, I_x),
        mesh=mesh,
        in_specs=P(axis_name),
        out_specs=P(axis_name),
        check_vma=False,
    )(*padded)
    return tuple(x[:n] for x in out)


@f32_matmuls
def sharded_suffix_scan_batched(
    mesh: Mesh,
    time_axis: str,
    full,
    nx: int,
    dtype,
    scenario_axis: str | None = None,
):
    """Batched blocked suffix scan: leaves are (Bb, n, ...) with time on
    axis 1, sharded over ``time_axis``; the scenario batch is optionally
    sharded over ``scenario_axis``: the 2-D (scenario x horizon) mesh
    decomposition."""
    n = full[0].shape[1]
    D = mesh.shape[time_axis]
    device = full[0].device
    ident = _ilqr.riccati_identity(nx, dtype, device)
    padded, _ = _pad_to_multiple(full, n, D, ident, axis=1)
    I_x = torch.eye(nx, dtype=dtype, device=device)

    def body(*local):  # (Bb_local, n_local, ...) -> time-leading and back
        out = _block_suffix(tuple(torch.movedim(x, 1, 0) for x in local),
                            time_axis, ident, I_x)
        return tuple(torch.movedim(x, 0, 1) for x in out)

    out = collectives.shard_map(
        body,
        mesh=mesh,
        in_specs=P(scenario_axis, time_axis),
        out_specs=P(scenario_axis, time_axis),
        check_vma=False,
    )(*padded)
    return tuple(x[:, :n] for x in out)


def _elements(A, B, lx, lu, lxx, luu, lux, reg, batched: bool):
    """Per-step elements, and the gains' map, over time (and the batch)."""
    nu = B.shape[-1]
    I_u = torch.eye(nu, dtype=B.dtype, device=B.device)
    make = torch.func.vmap(lambda inp: _ilqr.riccati_make_elem(inp, reg, I_u))
    gains = torch.func.vmap(
        lambda inp, Vx, Vxx: _ilqr.riccati_gains(inp, Vx, Vxx, reg, I_u))
    if batched:
        make, gains = torch.func.vmap(make), torch.func.vmap(gains)
    return make((A, B, lx, lu, lxx, luu, lux)), gains


@f32_matmuls
def backward_associative_sharded_batched(
    mesh: Mesh,
    time_axis: str,
    A,
    B,
    lx,
    lu,
    lxx,
    luu,
    lux,
    Vx_T,
    Vxx_T,
    reg,
    scenario_axis: str | None = None,
    return_values: bool = False,
):
    """Batched Riccati backward with BOTH parallel dimensions sharded:
    scenario batch over ``scenario_axis`` and the horizon over
    ``time_axis`` on a 2-D mesh.  Inputs are batch-leading ``(Bb, H,
    ...)``; ``reg`` is a scalar shared across the batch (per-scenario reg
    belongs to ``models.ilqr.backward_associative_soa``)."""
    nx = A.shape[-1]
    elems, gains = _elements(A, B, lx, lu, lxx, luu, lux, reg, batched=True)
    Bb = A.shape[0]
    zmat = torch.zeros((Bb, nx, nx), dtype=A.dtype, device=A.device)
    zvec = torch.zeros((Bb, nx), dtype=A.dtype, device=A.device)
    term = (zmat, zvec, zmat, -Vx_T, Vxx_T)
    full = tuple(torch.cat([e, t[:, None]], dim=1) for e, t in zip(elems, term))
    suffix = sharded_suffix_scan_batched(
        mesh, time_axis, full, nx, A.dtype, scenario_axis=scenario_axis
    )
    Vx_all = -suffix[3]
    Vxx_all = suffix[4]
    ks, Ks = gains((A, B, lx, lu, lxx, luu, lux), Vx_all[:, 1:], Vxx_all[:, 1:])
    if return_values:
        return ks, Ks, Vx_all, Vxx_all
    return ks, Ks


@f32_matmuls
def backward_associative_sharded(
    mesh: Mesh,
    axis_name: str,
    A,
    B,
    lx,
    lu,
    lxx,
    luu,
    lux,
    Vx_T,
    Vxx_T,
    reg,
    return_values: bool = False,
):
    """Riccati backward pass with the HORIZON axis sharded over
    ``mesh[axis_name]``: drop-in equivalent of
    :func:`models.ilqr.backward_associative` (same inputs, same outputs,
    same numerics up to float32 reassociation).

    Element construction and gain recovery are independent over time and
    run on every rank over the whole horizon; only the suffix scan needs
    the blocked algorithm above.
    """
    nx = A.shape[-1]
    elems, gains = _elements(A, B, lx, lu, lxx, luu, lux, reg, batched=False)
    zmat = torch.zeros((nx, nx), dtype=A.dtype, device=A.device)
    zvec = torch.zeros((nx,), dtype=A.dtype, device=A.device)
    term = (zmat, zvec, zmat, -Vx_T, Vxx_T)
    full = tuple(torch.cat([e, t[None]]) for e, t in zip(elems, term))
    suffix = sharded_suffix_scan(mesh, axis_name, full, nx, A.dtype)
    Vx_all = -suffix[3]
    Vxx_all = suffix[4]
    ks, Ks = gains((A, B, lx, lu, lxx, luu, lux), Vx_all[1:], Vxx_all[1:])
    if return_values:
        return ks, Ks, Vx_all, Vxx_all
    return ks, Ks
