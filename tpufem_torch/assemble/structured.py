"""Shift-invariant structured plan, as in tpufem.assemble.structured.

On a regular grid every local-matrix entry (element type t, local row a,
local col b) lands in the same stencil slot at the same grid shift for
every cell; the plan records that slot (``entry_k``) and shift
(``entry_shift``).  With ``embed=True`` all grid fields live on
``store_grid``: every axis carries a +1 halo border, the leading axis is
rounded up to a multiple of 8 and the minor axes to (8, 128) multiples,
node (i, j, k) living at (i+1, j+1, k+1).  The port keeps this layout so
that its store vectors compare one to one with the JAX package's; the
128-float x rows also suit coalesced loads on the GPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpufem_torch.mesh.core import StructuredInfo

__all__ = ["StructuredPlan", "structured_plan"]


@dataclasses.dataclass(frozen=True, eq=False)
class StructuredPlan:
    """For each (t, a, b): target stencil slot k and grid shift of the row
    node; plus the storage grid the flat offsets refer to."""

    info: StructuredInfo
    offsets: tuple                 # flat stencil offsets (sorted, includes 0)
    offsets_grid: tuple            # same offsets as grid tuples (dz, dy, dx)
    entry_k: np.ndarray            # [T, a, b] -> index into offsets
    entry_shift: np.ndarray        # [T, a, b, g] -> store position of row a
    store_grid: tuple
    embedded: bool = False

    @property
    def width(self) -> int:
        return len(self.offsets)

    @property
    def num_store_rows(self) -> int:
        return int(np.prod(self.store_grid))

    def embed_field(self, flat: torch.Tensor) -> torch.Tensor:
        """Node field [NN] -> storage field [num_store_rows], zero on the
        border and padding (same device and dtype as ``flat``)."""
        ng = self.info.node_grid
        if not self.embedded:
            return flat.reshape(-1)
        out = flat.new_zeros(self.store_grid)
        out[tuple(slice(1, 1 + n) for n in ng)] = flat.reshape(ng)
        return out.reshape(-1)

    def extract_field(self, flat_store: torch.Tensor) -> torch.Tensor:
        """Storage field -> node field [NN]."""
        ng = self.info.node_grid
        if not self.embedded:
            return flat_store.reshape(-1)
        arr = flat_store.reshape(self.store_grid)
        return arr[tuple(slice(1, 1 + n) for n in ng)].reshape(-1)


def _node_strides(node_grid):
    """Flat-index strides of a grid (slowest axis first)."""
    strides = [1]
    for s in node_grid[:0:-1]:
        strides.append(strides[-1] * s)
    return tuple(reversed(strides))


def _roundup(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def structured_plan(info: StructuredInfo, embed: bool = False
                    ) -> StructuredPlan:
    """Build the shift-invariant assembly plan of a structured grid."""
    if not isinstance(info, StructuredInfo):
        raise ValueError("structured_plan needs a StructuredInfo")
    off = info.type_node_offsets          # [T, npe, g]
    ng = info.node_grid
    g = len(ng)

    if embed:
        tile = [1] * g
        if g >= 2:
            tile[-1] = 128
        if g >= 3:
            tile[-2] = 8
        store_grid = tuple(
            _roundup(ng[d] + 2, 8) if d == 0 else _roundup(ng[d] + 2, tile[d])
            for d in range(g))
        origin = np.ones(g, dtype=np.int64)
    else:
        store_grid = tuple(ng)
        origin = np.zeros(g, dtype=np.int64)

    strides = np.array(_node_strides(store_grid), dtype=np.int64)
    flat = off @ strides                  # [T, npe] flat node offset
    ent = flat[:, None, :] - flat[:, :, None]     # [T, a, b] = col - row
    offsets = np.unique(ent)
    entry_k = np.searchsorted(offsets, ent)
    ent_grid = off[:, None, :, :] - off[:, :, None, :]   # [T, a, b, g]
    grid_of = {}
    for t in range(ent.shape[0]):
        for a in range(ent.shape[1]):
            for b in range(ent.shape[2]):
                grid_of[int(ent[t, a, b])] = tuple(
                    int(v) for v in ent_grid[t, a, b])
    offsets_grid = tuple(grid_of[int(o)] for o in offsets)
    t_, npe = flat.shape
    entry_shift = (np.broadcast_to(
        off[:, :, None, :], (t_, npe, npe, g)) + origin).copy()
    return StructuredPlan(info=info, offsets=tuple(int(o) for o in offsets),
                          offsets_grid=offsets_grid,
                          entry_k=entry_k, entry_shift=entry_shift,
                          store_grid=store_grid, embedded=embed)
