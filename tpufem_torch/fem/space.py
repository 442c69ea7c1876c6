"""Function spaces: the DOF layout over a mesh, as in tpufem.fem.space.

DOF numbering, the reference's:
  * P1 scalar: DOF = node index;
  * P2 scalar: vertex DOFs first (node index), then one DOF per unique
    edge, in the order of the sorted edge keys lo * num_nodes + hi;
  * vector spaces: node-major, component-minor: the global DOF of (scalar
    dof d, component c) is ``d * num_components + c``, which keeps each
    node's block contiguous, as the BCSR format wants.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from tpufem_torch.fem.elements import ReferenceElement, element_for_cell
from tpufem_torch.fem.quadrature import QuadratureRule, rule_for_cell
from tpufem_torch.mesh.core import Mesh

__all__ = ["FunctionSpace", "VectorFunctionSpace"]

_EDGE_VERTICES = {
    # local edge -> local vertex pair; triangle edges ordered (1-2), (2-3),
    # (3-1) to match the P2Triangle DOF convention; tet edges match
    # P2Tetrahedron._EDGES
    "triangle": np.array([[0, 1], [1, 2], [2, 0]], dtype=np.int64),
    "tetrahedron": np.array([[0, 1], [1, 2], [2, 0], [0, 3], [1, 3], [2, 3]],
                            dtype=np.int64),
}

# local facet -> local vertex triple (the tet facet opposite each vertex)
_TET_FACETS = np.array([[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]],
                       dtype=np.int64)


def _boundary_edge_keys_3d(conn: np.ndarray, num_nodes: int) -> np.ndarray:
    """Sorted flat keys (lo*NN+hi) of the edges lying on boundary facets.

    In 3D an edge's element count says nothing about the boundary; the
    test is membership in a boundary facet, a triangle that occurs in
    exactly one tet.
    """
    tris = np.sort(conn[:, _TET_FACETS].astype(np.int64),
                   axis=2).reshape(-1, 3)
    # unique facet triples by rows: a cubic scalar key num_nodes**2 * v0
    # would overflow int64 beyond ~2.1M nodes
    uk, counts = np.unique(tris, axis=0, return_counts=True)
    bk = uk[counts == 1]
    v0, v1, v2 = bk[:, 0], bk[:, 1], bk[:, 2]
    pairs = np.concatenate([np.stack([v0, v1], 1), np.stack([v1, v2], 1),
                            np.stack([v0, v2], 1)])
    lo = pairs.min(1)
    hi = pairs.max(1)
    return np.unique(lo * num_nodes + hi)


def _unique_edges(conn: np.ndarray, cell_type: str, num_nodes: int):
    """Unique mesh edges, per-element edge ids and the boundary-edge
    mask."""
    ev = _EDGE_VERTICES[cell_type]
    pairs = conn[:, ev]                       # [NE, n_edges, 2]
    lo = np.minimum(pairs[..., 0], pairs[..., 1]).astype(np.int64)
    hi = np.maximum(pairs[..., 0], pairs[..., 1]).astype(np.int64)
    keys = lo * num_nodes + hi               # [NE, n_edges]
    unique_keys, inverse, counts = np.unique(
        keys.ravel(), return_inverse=True, return_counts=True)
    edge_ids = inverse.reshape(keys.shape)   # [NE, n_edges]
    if cell_type == "triangle":
        boundary_edge = counts == 1          # 2D: the edges are the facets
    else:
        bkeys = _boundary_edge_keys_3d(conn, num_nodes)
        boundary_edge = np.isin(unique_keys, bkeys, assume_unique=True)
    edge_nodes = np.stack(
        [unique_keys // num_nodes, unique_keys % num_nodes], axis=1)
    return edge_ids, edge_nodes, boundary_edge


@dataclasses.dataclass
class FunctionSpace:
    """Scalar (or, with ``num_components > 1``, vector) Lagrange space of
    degree 1 or 2 on a mesh."""

    mesh: Mesh
    family: str = "Lagrange"
    degree: int = 1
    num_components: int = 1

    def __post_init__(self):
        if self.family not in ("Lagrange", "P", "CG"):
            raise NotImplementedError(f"family {self.family!r}")
        self.element: ReferenceElement = element_for_cell(
            self.mesh.cell_type, self.degree)
        self._build_dofs()

    def _build_dofs(self):
        mesh = self.mesh
        if self.degree == 1:
            self.scalar_dof_conn = mesh.conn.copy()
            self.num_scalar_dofs = mesh.num_nodes
            self.scalar_dof_flags = mesh.node_flags != 0
            self.scalar_dof_coords = mesh.coords.copy()
        elif self.degree == 2:
            edge_ids, edge_nodes, boundary_edge = _unique_edges(
                mesh.conn, mesh.cell_type, mesh.num_nodes)
            self.scalar_dof_conn = np.concatenate(
                [mesh.conn, mesh.num_nodes + edge_ids], axis=1
            ).astype(np.int32)
            self.num_scalar_dofs = mesh.num_nodes + edge_nodes.shape[0]
            self.scalar_dof_flags = np.concatenate(
                [mesh.node_flags != 0, boundary_edge])
            mid = 0.5 * (mesh.coords[edge_nodes[:, 0]]
                         + mesh.coords[edge_nodes[:, 1]])
            self.scalar_dof_coords = np.concatenate([mesh.coords, mid],
                                                    axis=0)
        else:
            raise NotImplementedError(f"degree {self.degree}")

        nc = self.num_components
        if nc == 1:
            self.dof_conn = self.scalar_dof_conn
            self.num_dofs = self.num_scalar_dofs
            self.dof_flags = self.scalar_dof_flags
        else:
            # node-major, component-minor expansion
            base = self.scalar_dof_conn.astype(np.int64) * nc
            self.dof_conn = (
                base[:, :, None] + np.arange(nc, dtype=np.int64)
            ).reshape(base.shape[0], -1).astype(np.int32)
            self.num_dofs = self.num_scalar_dofs * nc
            self.dof_flags = np.repeat(self.scalar_dof_flags, nc)

    @property
    def local_dofs(self) -> int:
        return self.element.num_nodes * self.num_components

    def default_quadrature(self, extra_degree: int = 0) -> QuadratureRule:
        """Rule exact for the stiffness form of this space's degree (at
        least degree 2 on triangles, capped at 5 on triangles and 3 on the
        other cells)."""
        deg = max(1, 2 * self.degree + extra_degree)
        if self.mesh.cell_type == "triangle":
            return rule_for_cell("triangle", min(max(deg, 2), 5))
        return rule_for_cell(self.mesh.cell_type, min(deg, 3))

    def boundary_dofs(self) -> np.ndarray:
        return np.nonzero(self.dof_flags)[0].astype(np.int32)


def VectorFunctionSpace(mesh: Mesh, family: str = "Lagrange", degree: int = 1,
                        num_components: int | None = None) -> FunctionSpace:
    """Vector-valued Lagrange space (default: one component per space
    dimension)."""
    nc = mesh.dim if num_components is None else num_components
    return FunctionSpace(mesh, family=family, degree=degree,
                         num_components=nc)
