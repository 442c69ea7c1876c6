"""2D ("z", "y") decomposition for structured grid stencils, as in
tpufem.dist.stencil2d.

The grid is sharded over both leading axes and the halo exchange runs in
two phases:

  phase 1:  single z-planes from the "z"-ring neighbours;
  phase 2:  single y-rows of the z-extended block from the "y"-ring
            neighbours — the z-halo rows ride along, so corner values
            (offsets with dz != 0 and dy != 0) arrive without any
            diagonal-neighbour exchange.

Per matvec: 2 z-planes + 2 y-rows per shard; the CG dot products are
local dots + psum over both axes.
"""
from __future__ import annotations

import torch

from tpufem_torch.dist.mesh import (Mesh, P, Sharded, psum, ring_halos,
                                    shard, smap)
from tpufem_torch.solve.cg import CGResult

__all__ = ["halo_exchange_grid", "grid_stencil_matvec_2d",
           "grid_cg_sharded_2d", "solve_grid_cg_2d"]


def _axis_halo(x: Sharded, axis_name: str, axis: int):
    """(low, high) single-slab halos of ``x`` along array axis ``axis``
    from the ``axis_name`` ring; global-boundary shards receive zeros."""
    lo = x.map(lambda t: t.narrow(axis, 0, 1))
    hi = x.map(lambda t: t.narrow(axis, t.shape[axis] - 1, 1))
    return ring_halos(lo, hi, axis_name)


def halo_exchange_grid(x: Sharded, axis_z: str, axis_y: str) -> Sharded:
    """Local block [lz, ly, nx] -> haloed [lz+2, ly+2, nx+2].

    z and y halos come from the device mesh rings; the x axis is unsharded
    and zero-padded (grid edge).
    """
    lo_z, hi_z = _axis_halo(x, axis_z, 0)
    xz = smap(lambda lo, t, hi: torch.cat([lo, t, hi], dim=0), lo_z, x, hi_z)
    lo_y, hi_y = _axis_halo(xz, axis_y, 1)
    return smap(lambda lo, t, hi: torch.nn.functional.pad(
        torch.cat([lo, t, hi], dim=1), (1, 1)), lo_y, xz, hi_y)


def _matvec_local(d, x, xp, offsets_grid):
    lz, ly, nx = x.shape
    y = None
    for k, (dz, dy, dx) in enumerate(offsets_grid):
        sl = xp[1 + dz:1 + dz + lz, 1 + dy:1 + dy + ly, 1 + dx:1 + dx + nx]
        y = d[k] * sl if y is None else y + d[k] * sl
    return y


def grid_stencil_matvec_2d(data: Sharded, x: Sharded, offsets_grid,
                           axis_z: str, axis_y: str) -> Sharded:
    """Sharded y = A x on a ("z","y") device mesh.

    data [K, lz, ly, nx] local, x [lz, ly, nx] local; offsets_grid is a
    tuple of (dz, dy, dx) with |d| <= 1 (the structured P1 patterns).
    """
    xp = halo_exchange_grid(x, axis_z, axis_y)
    return smap(lambda d, xl, p: _matvec_local(d, xl, p, offsets_grid),
                data, x, xp, spec=x.spec)


def _pdot2(a, b, axes):
    return psum(smap(lambda u, v: torch.dot(u.reshape(-1), v.reshape(-1)),
                     a, b), axes)


def grid_cg_sharded_2d(data, offsets_grid, b, mesh: Mesh, *,
                       tol: float = 1e-8, maxiter: int = 500,
                       axis_z: str = "z", axis_y: str = "y") -> CGResult:
    """Jacobi-PCG with the whole Krylov loop on the mesh's shards.

    data [K, nz, ny, nx], b [nz, ny, nx] (global, or Sharded); nz/ny must
    divide by the mesh's ("z","y") extents.  Diagonal = offset (0,0,0).
    """
    diag_k = next(i for i, o in enumerate(offsets_grid)
                  if tuple(o) == (0, 0, 0))
    axes = (axis_z, axis_y)
    tol = float(tol)
    data_l = shard(data, mesh, P(None, axis_z, axis_y, None))
    b_l = shard(b, mesh, P(axis_z, axis_y, None))

    def matvec(v):
        return grid_stencil_matvec_2d(data_l, v, offsets_grid, axis_z,
                                      axis_y)

    inv_d = data_l.map(lambda d: torch.where(d[diag_k] != 0,
                                             1.0 / d[diag_k], 1.0),
                       spec=b_l.spec)
    b_norm2 = _pdot2(b_l, b_l, axes)
    safe_b = torch.where(b_norm2 > 0, torch.sqrt(b_norm2), 1.0)
    atol = tol * safe_b

    r = b_l
    z = inv_d * r
    rz = _pdot2(r, z, axes)
    x = b_l.map(torch.zeros_like)
    p = z
    bad = torch.zeros((), dtype=torch.bool, device=rz.device)
    k = 0
    while k < maxiter and bool(((torch.sqrt(_pdot2(r, r, axes)) > atol)
                                & ~bad).item()):
        Ap = matvec(p)
        pAp = _pdot2(p, Ap, axes)
        alpha = rz / pAp
        x = x + alpha * p
        r = r - alpha * Ap
        z = inv_d * r
        rz_new = _pdot2(r, z, axes)
        p = z + (rz_new / rz) * p
        bad = ~torch.isfinite(rz_new) | ~torch.isfinite(pAp) | (pAp <= 0)
        rz = rz_new
        k += 1
    rnorm = torch.sqrt(_pdot2(r, r, axes)) / safe_b
    bad_h = bool(bad.item())
    return CGResult(x=x, iterations=k, residual_norm=rnorm,
                    converged=bool((rnorm <= tol).item()) and not bad_h,
                    diverged=bad_h)


def solve_grid_cg_2d(data, offsets_grid, b, mesh: Mesh, **kw) -> CGResult:
    """Shard the global system over the ("z","y") mesh and solve."""
    return grid_cg_sharded_2d(torch.as_tensor(data), offsets_grid,
                              torch.as_tensor(b), mesh, **kw)
