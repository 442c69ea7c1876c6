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

from tpufem_torch.mesh.core import Mesh, StructuredInfo
from tpufem_torch.sparse.stencil import StencilMatrix, StencilPattern

__all__ = ["StructuredPlan", "structured_plan", "assemble_stencil_structured",
           "assemble_vector_structured", "assemble_stencil_structured_bt",
           "assemble_vector_structured_bt", "stencil_pattern_structured"]


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

    def embed_field(self, flat: torch.Tensor, fill=0) -> torch.Tensor:
        """Node field [NN] -> storage field [num_store_rows], ``fill`` on
        the border and padding (same device and dtype as ``flat``)."""
        ng = self.info.node_grid
        if not self.embedded:
            return flat.reshape(-1)
        out = flat.new_full(self.store_grid, fill)
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


def structured_plan(mesh_or_info, embed: bool = False) -> StructuredPlan:
    """Build the shift-invariant assembly plan of a structured grid from a
    Mesh (with structured metadata) or its StructuredInfo directly, which
    lets large-grid callers skip the element connectivity."""
    info = getattr(mesh_or_info, "structured", mesh_or_info)
    if not isinstance(info, StructuredInfo):
        raise ValueError("mesh has no structured-grid metadata")
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


def _padded(plane, shift, cell_grid, store_grid):
    """Zero-pad a cell-grid plane into store-grid position ``shift``."""
    pads = []
    for d in reversed(range(len(store_grid))):   # F.pad: last axis first
        pads += [int(shift[d]), store_grid[d] - cell_grid[d] - int(shift[d])]
    return torch.nn.functional.pad(plane, pads)


def _sum_per_offset(plan: StructuredPlan, plane_of, like: torch.Tensor
                    ) -> StencilMatrix:
    """Stencil plane k = the sum of the shifted planes of its entries
    (t, a, b), added in the reference's order (t, then a, then b)."""
    info = plan.info
    npe = info.type_node_offsets.shape[1]
    planes = [None] * plan.width
    for t in range(info.num_types):
        for a in range(npe):
            for b in range(npe):
                k = int(plan.entry_k[t, a, b])
                p = _padded(plane_of(t, a, b), plan.entry_shift[t, a, b],
                            info.cell_grid, plan.store_grid)
                planes[k] = p if planes[k] is None else planes[k] + p
    zero = like.new_zeros(plan.store_grid)
    data = torch.stack([zero if p is None else p for p in planes])
    return StencilMatrix(data.reshape(plan.width, -1), plan.offsets)


def _sum_vector(plan: StructuredPlan, plane_of) -> torch.Tensor:
    info = plan.info
    origin = plan.entry_shift[0, 0, 0] - info.type_node_offsets[0, 0]
    b = None
    for t in range(info.num_types):
        for a in range(info.type_node_offsets.shape[1]):
            p = _padded(plane_of(t, a), info.type_node_offsets[t, a] + origin,
                        info.cell_grid, plan.store_grid)
            b = p if b is None else b + p
    return b.reshape(-1)


def assemble_stencil_structured(plan: StructuredPlan,
                                element_matrices: torch.Tensor
                                ) -> StencilMatrix:
    """Ke [NE, npe, npe] in generator order (cell-major, the T types
    interleaved) -> StencilMatrix [K, num_store_rows] by shifted
    slice-adds, no index arrays."""
    info = plan.info
    npe = info.type_node_offsets.shape[1]
    KeT = element_matrices.reshape(*info.cell_grid, info.num_types, npe, npe)
    return _sum_per_offset(plan, lambda t, a, b: KeT[..., t, a, b],
                           element_matrices)


def assemble_vector_structured(plan: StructuredPlan,
                               element_vectors: torch.Tensor) -> torch.Tensor:
    """be [NE, npe] in generator order -> RHS [num_store_rows]."""
    info = plan.info
    beT = element_vectors.reshape(*info.cell_grid, info.num_types,
                                  info.type_node_offsets.shape[1])
    return _sum_vector(plan, lambda t, a: beT[..., t, a])


def assemble_stencil_structured_bt(plan: StructuredPlan, Ke_bt
                                   ) -> StencilMatrix:
    """Batch-trailing element matrices Ke_bt [T, npe, npe, *cell_grid]
    (assemble.planar) -> StencilMatrix [K, num_store_rows]."""
    return _sum_per_offset(plan, lambda t, a, b: Ke_bt[t, a, b], Ke_bt)


def assemble_vector_structured_bt(plan: StructuredPlan, be_bt):
    """Batch-trailing element loads be_bt [T, npe, *cell_grid] ->
    RHS [num_store_rows]."""
    return _sum_vector(plan, lambda t, a: be_bt[t, a])


def stencil_pattern_structured(mesh: Mesh) -> StencilPattern:
    """StencilPattern whose offsets match ``structured_plan(mesh)`` (for
    boundary conditions and the diagonal); the offsets are derived from
    the plan, and the slot tables are not built (None)."""
    plan = structured_plan(mesh)
    offsets = np.asarray(plan.offsets, dtype=np.int64)
    return StencilPattern(offsets=offsets, slots=None, perm=None,
                          sorted_slots=None,
                          diag_k=int(np.searchsorted(offsets, 0)),
                          num_rows=int(np.prod(plan.info.node_grid)))
