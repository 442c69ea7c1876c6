"""Distributed stencil SpMV: halo exchange over the device mesh, as in
tpufem.dist.stencil.

Each shard owns a contiguous row stripe of the offset-diagonal matrix
``data [K, NN/P]`` and of the vector ``x [NN/P]``.  A matvec needs at most
``halo = max |offset|`` neighbour values on each side: one ``ppermute``
per direction moves exactly those rows between ring neighbours, then the
local matvec runs with static shifts in plain PyTorch (XLA in the
reference, not a Pallas kernel).
"""
from __future__ import annotations

import torch

from tpufem_torch.dist.mesh import Sharded, ring_halos, smap

__all__ = ["halo_exchange", "sharded_stencil_matvec"]


def halo_exchange(x_local: Sharded, halo: int, axis_name: str):
    """Return (left_halo [halo], right_halo [halo]) from ring neighbors.

    Global-boundary shards receive zeros (matching the zero padding of the
    single-chip matvec).
    """
    return ring_halos(x_local[:halo], x_local[-halo:], axis_name)


def _local_matvec(d, x, left, right, offsets, halo):
    nl = x.shape[0]
    xp = torch.cat([left, x, right])
    y = None
    for k, off in enumerate(offsets):
        term = d[k] * xp[halo + off: halo + off + nl]
        y = term if y is None else y + term
    return y


def sharded_stencil_matvec(data_local: Sharded, x_local: Sharded, offsets,
                           axis_name: str) -> Sharded:
    """Local stripe of y = A x. data_local [K, NL], x_local [NL]."""
    offsets = tuple(int(o) for o in offsets)
    halo = int(max(abs(o) for o in offsets))
    left, right = halo_exchange(x_local, halo, axis_name)
    return smap(lambda d, x, lo, hi: _local_matvec(d, x, lo, hi, offsets,
                                                   halo),
                data_local, x_local, left, right, spec=x_local.spec)
