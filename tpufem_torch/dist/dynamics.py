"""Distributed explicit dynamics: sharded leapfrog over the device mesh,
as in tpufem.dist.dynamics.

Each step's stiffness SpMV is the single-hop halo-exchange stencil matvec
(``dist.stencil.sharded_stencil_matvec``); the discrete-energy trace needs
two global dots per step (local dot + psum); everything else is
shard-local elementwise work.  The numerics are those of the one-device
leapfrog: Taylor start-up, K u_n carried so each step pays one SpMV.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from tpufem_torch.dist.cg import _pdot
from tpufem_torch.dist.mesh import Mesh, P, Sharded, shard, smap
from tpufem_torch.dist.stencil import sharded_stencil_matvec

__all__ = ["leapfrog_wave_sharded"]


class _ShardedWaveResult(NamedTuple):
    u: Sharded             # [NN] displacement at t = steps*dt
    v: Sharded             # [NN] midpoint velocity
    energy: torch.Tensor   # [steps-1] discrete energy trace


def leapfrog_wave_sharded(data, offsets, m_lumped, u0, v0, dt: float,
                          steps: int, mesh: Mesh, *,
                          axis_name: str = "rows",
                          bc_mask=None) -> _ShardedWaveResult:
    """Integrate M u'' + K u = 0 with central differences over ``mesh``.

    ``data`` [K, NN] stencil values / ``offsets``: the stiffness operator
    in stencil form (row count divisible by the mesh axis — use
    dist.partition.pad_rows; padding rows must carry zero stencil values
    and unit mass).  ``m_lumped``/``u0``/``v0``/``bc_mask``: [NN] (global
    tensors or Sharded).  Discrete energy E_{n+1/2} = 1/2 v^T M v + 1/2
    u_n^T K u_{n+1}, traced per step.
    """
    offsets = tuple(int(o) for o in offsets)
    num = mesh.shape[axis_name]
    m_l = shard(m_lumped, mesh, P(axis_name))
    n = sum(s.shape[0] for s in m_l.shards)
    if n % num:
        raise ValueError(f"rows {n} not divisible by mesh axis {num}; "
                         "pad with tpufem_torch.dist.partition.pad_rows")
    halo = max(abs(o) for o in offsets)
    if n // num < halo:
        raise ValueError(
            f"local stripe ({n // num} rows) thinner than the stencil "
            f"halo ({halo}) — use fewer shards or a larger mesh")
    dt = float(dt)
    steps = int(steps)
    dtype = m_l.dtype
    data_l = shard(data, mesh, P(None, axis_name))
    if bc_mask is None:
        bc_l = m_l.map(lambda m: torch.zeros(m.shape, dtype=torch.bool,
                                             device=m.device))
    else:
        bc_l = shard(bc_mask, mesh, P(axis_name))
    inv_m = 1.0 / m_l

    def matvec(u):
        return sharded_stencil_matvec(data_l, u, offsets, axis_name)

    def proj(x):
        return smap(lambda b, v: torch.where(b, 0.0, v), bc_l, x)

    u = proj(shard(u0, mesh, P(axis_name)).map(lambda t: t.to(dtype)))
    v = proj(shard(v0, mesh, P(axis_name)).map(lambda t: t.to(dtype)))
    a0 = proj(-inv_m * matvec(u))
    u1 = proj(u + dt * v + 0.5 * dt * dt * a0)
    Ku = matvec(u1)

    u_prev, u_c = u, u1
    energy = []
    for _ in range(steps - 1):
        u_next = proj(2.0 * u_c - u_prev - dt * dt * (inv_m * Ku))
        Ku_next = matvec(u_next)
        v_half = (u_next - u_c) / dt
        energy.append(0.5 * _pdot(v_half, m_l * v_half, axis_name)
                      + 0.5 * _pdot(u_c, Ku_next, axis_name))
        u_prev, u_c, Ku = u_c, u_next, Ku_next
    v_f = (u_c - u_prev) / dt
    energy = (torch.stack(energy) if energy
              else torch.zeros(0, dtype=dtype, device=mesh.home))
    return _ShardedWaveResult(u=u_c, v=v_f, energy=energy)
