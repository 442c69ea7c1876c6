"""Structured-grid metadata (host numpy), as in tpufem.mesh.core."""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["StructuredInfo"]


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
