"""Mesh data model (host numpy, structure of arrays), as in tpufem.mesh.core.

  * ``coords``      -- float64 [num_nodes, dim] node coordinates
  * ``conn``        -- int32   [num_elements, nodes_per_element] connectivity
  * ``node_flags``  -- int32   [num_nodes] boundary flag (1 = on boundary)

Adjacency and sparsity-pattern precomputation live in
:mod:`tpufem_torch.mesh.adjacency`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["Mesh", "StructuredInfo"]


@dataclasses.dataclass(frozen=True)
class StructuredInfo:
    """Regular-grid metadata of a structured mesh.

    Elements are enumerated cell-major with ``num_types`` elements per grid
    cell, and every element type's nodes sit at fixed grid offsets from the
    cell's base node.

    node_grid / cell_grid: grid shapes, slowest axis first.
    type_node_offsets: [T, npe, ndim_grid] int64 node offsets per type.
    """

    node_grid: tuple
    cell_grid: tuple
    type_node_offsets: np.ndarray

    @property
    def num_types(self) -> int:
        return self.type_node_offsets.shape[0]


_NODES_PER_CELL = {"triangle": 3, "tetrahedron": 4, "quad": 4,
                   "hexahedron": 8}


@dataclasses.dataclass
class Mesh:
    """An unstructured mesh in SoA layout.

    ``cell_type`` is "triangle" (3 nodes), "tetrahedron" (4 nodes), "quad"
    (4 nodes) or "hexahedron" (8 nodes).  ``structured`` carries optional
    regular-grid metadata (set by the rectangle generator).
    """

    coords: np.ndarray        # [NN, dim] float64
    conn: np.ndarray          # [NE, npe] int32
    node_flags: np.ndarray    # [NN] int32, 1 = boundary
    cell_type: str = "triangle"
    structured: Optional[StructuredInfo] = None

    def __post_init__(self):
        self.coords = np.ascontiguousarray(self.coords, dtype=np.float64)
        self.conn = np.ascontiguousarray(self.conn, dtype=np.int32)
        self.node_flags = np.ascontiguousarray(self.node_flags, dtype=np.int32)
        if self.coords.ndim != 2:
            raise ValueError(f"coords must be [NN, dim], got {self.coords.shape}")
        if self.conn.ndim != 2:
            raise ValueError(f"conn must be [NE, npe], got {self.conn.shape}")
        expected_npe = _NODES_PER_CELL[self.cell_type]
        if self.conn.shape[1] != expected_npe:
            raise ValueError(
                f"{self.cell_type} mesh needs {expected_npe} nodes/element, "
                f"got {self.conn.shape[1]}")
        if self.conn.size and (self.conn.min() < 0
                               or self.conn.max() >= self.num_nodes):
            raise ValueError("connectivity index out of range")

    @property
    def dim(self) -> int:
        return self.coords.shape[1]

    @property
    def num_nodes(self) -> int:
        return self.coords.shape[0]

    @property
    def num_elements(self) -> int:
        return self.conn.shape[0]

    @property
    def nodes_per_element(self) -> int:
        return self.conn.shape[1]

    def element_coords(self) -> np.ndarray:
        """[NE, npe, dim] coordinates gathered per element."""
        return self.coords[self.conn]

    def boundary_nodes(self) -> np.ndarray:
        """Indices of boundary-flagged nodes."""
        return np.nonzero(self.node_flags != 0)[0].astype(np.int32)
