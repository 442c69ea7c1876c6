"""Distributed conjugate gradients on the device mesh, as in
tpufem.dist.cg.

The matvec does ring halo exchanges (``dist.stencil``), every inner
product is a local dot plus ``psum`` in shard order, and the state (x, r,
z, p) stays sharded for the whole solve.  The stop rule is the
reference's: iterate while rr > tol^2 ||b||^2, k < maxiter and no
breakdown, one flag read back per iteration.
"""
from __future__ import annotations

from typing import Optional

import torch

from tpufem_torch.dist.mesh import Mesh, P, Sharded, psum, shard, smap, unshard
from tpufem_torch.dist.partition import pad_rows
from tpufem_torch.dist.stencil import sharded_stencil_matvec
from tpufem_torch.solve.cg import CGResult

__all__ = ["stencil_cg_sharded", "distributed_stencil_solve",
           "sharded_pcg_loop"]


def _pdot(a: Sharded, b: Sharded, axis_name):
    return psum(smap(lambda u, v: torch.dot(u.reshape(-1), v.reshape(-1)),
                     a, b), axis_name)


def sharded_pcg_loop(matvec, prec, b_l: Sharded, axis_name, tol: float,
                     maxiter: int):
    """Guarded PCG on sharded state.

    ``matvec``/``prec`` map a Sharded vector to one (halo exchange
    inside); dot products are local dots + psum.  Returns (x, iters,
    relres, converged, bad).  Shared by the stencil, ELL and BCSR solvers
    so the breakdown/convergence logic lives in exactly one place.
    """
    def pdot(a, c):
        return _pdot(a, c, axis_name)

    b_norm2 = pdot(b_l, b_l)
    safe_b = torch.where(b_norm2 > 0, b_norm2, 1.0)
    atol2 = (tol ** 2) * safe_b

    x = b_l.map(torch.zeros_like)
    r = b_l
    z = prec(r)
    rz = pdot(r, z)
    p = z
    rr = b_norm2
    bad = torch.zeros((), dtype=torch.bool, device=rr.device)
    k = 0
    while k < maxiter and bool(((rr > atol2) & ~bad).item()):
        Ap = matvec(p)
        pAp = pdot(p, Ap)
        alpha = rz / pAp
        x = x + alpha * p
        r = r - alpha * Ap
        z = prec(r)
        rz_new = pdot(r, z)
        rr = pdot(r, r)
        p = z + (rz_new / rz) * p
        bad = ~torch.isfinite(rz_new) | ~torch.isfinite(pAp) | (pAp <= 0)
        rz = rz_new
        k += 1
    relres = torch.sqrt(rr / safe_b)
    bad_h = bool(bad.item())
    converged = bool((rr <= atol2).item()) and not bad_h
    return x, k, relres, converged, bad_h


def stencil_cg_sharded(data, offsets, b, mesh: Mesh, *,
                       axis_name: str = "rows", tol: float = 1e-8,
                       maxiter: int = 1000, diag_precondition: bool = True,
                       diag_k: Optional[int] = None) -> CGResult:
    """Solve A x = b with CG, A in stencil form, sharded over ``mesh``.

    data [K, NN], b [NN] (global tensors, or already Sharded by row
    stripes) with NN divisible by the mesh axis size (use
    ``dist.partition.pad_rows`` first).  Returns a CGResult whose ``x`` is
    the Sharded solution (``x.unshard()`` gives the global array).
    """
    offsets = tuple(int(o) for o in offsets)
    num = mesh.shape[axis_name]
    n = b.local_shape[0] * num if isinstance(b, Sharded) else b.shape[0]
    if n % num:
        raise ValueError(f"rows {n} not divisible by mesh axis {num}; "
                         "pad with tpufem_torch.dist.partition.pad_rows")
    if diag_k is None:
        diag_k = offsets.index(0)
    halo = max(abs(o) for o in offsets)
    if n // num < halo:
        raise ValueError(
            f"local stripe ({n // num} rows) thinner than the stencil halo "
            f"({halo}): single-hop neighbor exchange cannot cover it — use "
            "fewer shards or a larger mesh")

    data_l = shard(data, mesh, P(None, axis_name))
    b_l = shard(b, mesh, P(axis_name))

    def matvec(v):
        return sharded_stencil_matvec(data_l, v, offsets, axis_name)

    if diag_precondition:
        inv_d = data_l.map(lambda d: torch.where(d[diag_k] != 0,
                                                 1.0 / d[diag_k], 1.0),
                           spec=P(axis_name))
        prec = lambda r: r * inv_d
    else:
        prec = lambda r: r

    return CGResult(*sharded_pcg_loop(matvec, prec, b_l, axis_name,
                                      float(tol), int(maxiter)))


def distributed_stencil_solve(A, b, mesh: Mesh, *, axis_name: str = "rows",
                              tol: float = 1e-8, maxiter: int = 1000,
                              diag_precondition: bool = True):
    """Convenience wrapper: pad a StencilMatrix system, shard it over the
    mesh, CG-solve, return (x [original rows], CGResult)."""
    num = mesh.shape[axis_name]
    diag_k = A.offsets.index(0)
    data_p, b_p, n = pad_rows(A.data, b, A.offsets, num, diag_k)
    res = stencil_cg_sharded(data_p, A.offsets, b_p, mesh,
                             axis_name=axis_name, tol=tol, maxiter=maxiter,
                             diag_precondition=diag_precondition,
                             diag_k=diag_k)
    return unshard(res.x)[:n], res
