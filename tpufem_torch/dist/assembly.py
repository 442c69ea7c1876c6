"""Distributed fused assembly: each shard builds its z-stripe of the
system, as in tpufem.dist.assembly.

Sharded node coordinates in -> one launch of kernel B8 per shard
(``ops.fused_system_cuda.build_poisson_stripe``) -> the sharded halo-CG
solve of ``dist.cg``, with nothing gathered to one device:

  * the embedded store grid is split into z-plane stripes, one per shard;
  * each shard takes one store plane of node coordinates from each ring
    neighbour (zeros at the global ends) and runs B8 over its stripe
    extended by those two planes: a row's cells reach one plane either
    way, so one plane of halo is all it needs (the TPU kernel took a whole
    z-block, its BlockSpec unit; the port has no z-block, so the stripe
    need not divide by one either);
  * the kernel's masks come from global node indices: the shard's first
    global store plane enters as ``zbase``.

The per-shard outputs ARE the row stripes that ``stencil_cg_sharded``
consumes, so assembly feeds the distributed solver with no relayout.
"""
from __future__ import annotations

import torch

from tpufem_torch.assemble.structured import StructuredPlan
from tpufem_torch.dist.cg import stencil_cg_sharded
from tpufem_torch.dist.mesh import (Mesh, P, Sharded, axis_index, ring_halos,
                                    shard, smap, unshard)
from tpufem_torch.ops.fused_system_cuda import build_poisson_stripe

__all__ = ["build_poisson_system_sharded", "solve_poisson_dist_general"]


def build_poisson_system_sharded(plan: StructuredPlan, C_emb, mesh: Mesh,
                                 f_planes, rule, *, axis_name: str = "z",
                                 rhs_mode: str = "quadrature"):
    """(data [K, NS], rhs [NS]) Sharded by row stripes over ``mesh``.

    C_emb: [3, E0, E1, E2] embedded node coordinates (a global tensor or
    numpy array, or already Sharded by the leading axis).  E0 must be
    divisible by the number of shards.
    """
    if not plan.embedded:
        raise ValueError("plan must be built with structured_plan(embed=True)")
    if len(plan.info.node_grid) != 3:
        raise NotImplementedError("sharded fused build is 3D")
    sg = plan.store_grid
    n_shards = mesh.shape[axis_name]
    if sg[0] % n_shards:
        raise ValueError(f"store z {sg[0]} not divisible by {n_shards}")
    local_e0 = sg[0] // n_shards

    C_l = shard(C_emb, mesh, P(None, axis_name, None, None))
    left, right = ring_halos(C_l[:, :1], C_l[:, -1:], axis_name)
    C_ext = smap(lambda lo, c, hi: torch.cat([lo, c, hi], dim=1), left, C_l,
                 right)
    zbase = [i * local_e0 for i in axis_index(mesh, axis_name)]
    data, rhs = [], []
    for i, c in enumerate(C_ext.shards):
        d, r = build_poisson_stripe(plan, c, zbase[i], f_planes, rule,
                                    rhs_mode=rhs_mode)
        data.append(d)
        rhs.append(r)
    return (Sharded(mesh, data, P(None, axis_name)),
            Sharded(mesh, rhs, P(axis_name)))


def solve_poisson_dist_general(plan: StructuredPlan, C_emb, mesh: Mesh,
                               f_planes, rule, *, axis_name: str = "z",
                               tol: float = 1e-6, maxiter: int = 2000):
    """General-geometry distributed pipeline: sharded fused assembly ->
    sharded Jacobi-preconditioned halo CG.  Returns (u [NN] host numpy,
    CGResult)."""
    data, b = build_poisson_system_sharded(plan, C_emb, mesh, f_planes, rule,
                                           axis_name=axis_name)
    res = stencil_cg_sharded(data, plan.offsets, b, mesh,
                             axis_name=axis_name, tol=tol, maxiter=maxiter)
    u = plan.extract_field(unshard(res.x)).cpu().numpy()
    return u, res
