"""Boundary facets (host numpy): extraction, DOF connectivity, geometry and
normals, as in tpufem.fem.facets.

The infrastructure behind boundary integrals (Neumann / Robin terms,
tractions, flux functionals): facet lists, their DOF maps and their
geometry are host setup products; the facet quadrature is one batched
broadcast-evaluate-contract over [NF, Q] on the device (forms.weakform).

A facet is a boundary facet iff it occurs in exactly one element (the
edges of triangles and quads in 2D, the triangular faces of tets in 3D).
Each facet carries its owner element's opposite vertex, which orients the
outward normal without any global convention on vertex winding.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from tpufem_torch.fem.elements import element_for_cell

__all__ = ["BoundaryFacets", "boundary_facets", "facet_dof_conn",
           "facet_geometry"]


# local facet -> local vertices (the tables of fem.space)
_TRI_EDGES = np.array([[0, 1], [1, 2], [2, 0]], dtype=np.int64)
_TET_FACETS = np.array([[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]],
                       dtype=np.int64)
# Q1 quad edges, counterclockwise (fem.elements.Q1Quad node order)
_QUAD_EDGES = np.array([[0, 1], [1, 2], [2, 3], [3, 0]], dtype=np.int64)


class BoundaryFacets(NamedTuple):
    """conn [NF, nv] facet vertex node ids; opposite [NF] the owner
    element's remaining vertex (fixes the outward normal); cell_type the
    facet reference cell ("segment" in 2D, "triangle" in 3D)."""
    conn: np.ndarray
    opposite: np.ndarray
    cell_type: str

    @property
    def num_facets(self) -> int:
        return self.conn.shape[0]


def boundary_facets(mesh) -> BoundaryFacets:
    """The boundary facets of a triangle, tet or quad mesh (host,
    O(NE log NE)), in element order, each with its local vertex order."""
    conn = np.asarray(mesh.conn, np.int64)
    if mesh.cell_type == "triangle":
        local = _TRI_EDGES
        fcell = "segment"
    elif mesh.cell_type == "tetrahedron":
        local = _TET_FACETS
        fcell = "triangle"
    elif mesh.cell_type == "quad":
        local = _QUAD_EDGES
        fcell = "segment"
    else:
        raise NotImplementedError(
            f"boundary facets for {mesh.cell_type!r} (hex surface "
            "integrals need per-point surface Jacobians; apply Dirichlet "
            "BCs via node flags instead)")
    nv = local.shape[1]
    facets = conn[:, local].reshape(-1, nv)          # [NE*nlf, nv]
    # a vertex of the element not on the facet: for convex cells it lies
    # strictly on the interior side, all the outward orientation needs
    opp_local = np.array([sorted(set(range(conn.shape[1])) - set(f))[0]
                          for f in local])
    opposite = conn[:, opp_local].reshape(-1)        # [NE*nlf]
    keys = np.sort(facets, axis=1)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True,
                               return_counts=True)
    is_bnd = counts[inv.reshape(-1)] == 1
    return BoundaryFacets(conn=facets[is_bnd].astype(np.int32),
                          opposite=opposite[is_bnd].astype(np.int32),
                          cell_type=fcell)


def facet_dof_conn(space, facets: BoundaryFacets) -> np.ndarray:
    """[NF, nfd] scalar DOF ids of each facet, ordered as the facet
    reference element of the space's degree (the trace of the volume
    basis).

    Degree 1: the facet vertices.  Degree 2: the vertices, then the
    facet's edge-midpoint DOFs in the facet element's edge order ((0,1)
    for segments; (0,1), (1,2), (2,0) for triangle facets), in the global
    edge numbering fem.space built (np.unique of the sorted edge keys).
    """
    from tpufem_torch.fem.space import _EDGE_VERTICES

    fconn = facets.conn.astype(np.int64)
    if space.degree == 1:
        return fconn.astype(np.int32)
    if space.degree != 2:
        raise NotImplementedError(f"degree {space.degree}")
    mesh = space.mesh
    nn = mesh.num_nodes
    ev = _EDGE_VERTICES[mesh.cell_type]
    pairs = np.asarray(mesh.conn, np.int64)[:, ev]
    lo = np.minimum(pairs[..., 0], pairs[..., 1])
    hi = np.maximum(pairs[..., 0], pairs[..., 1])
    unique_keys = np.unique(lo * nn + hi)            # the space's edge ids

    if facets.cell_type == "segment":
        fedges = fconn[:, None, :]                   # [NF, 1, 2]
    else:
        fe = np.array([[0, 1], [1, 2], [2, 0]])
        fedges = fconn[:, fe]                        # [NF, 3, 2]
    flo = fedges.min(-1)
    fhi = fedges.max(-1)
    fkeys = flo * nn + fhi
    eid = np.searchsorted(unique_keys, fkeys)
    if not np.array_equal(unique_keys[np.minimum(eid, unique_keys.size - 1)],
                          fkeys):
        raise RuntimeError("facet edge missing from the mesh edge set")
    return np.concatenate([fconn, nn + eid], axis=1).astype(np.int32)


def facet_geometry(coords: np.ndarray, facets: BoundaryFacets, rule,
                   dtype=np.float64):
    """Batched facet quadrature geometry (host precompute).

    Returns (xq [NF, Q, d] physical quadrature points, detS [NF] surface
    Jacobian: with the reference-measure-normalized rules the quadrature
    of ``g * detS`` integrates over the facet; normal [NF, d] outward unit
    normals).
    """
    coords = np.asarray(coords, np.float64)
    fx = coords[facets.conn]                         # [NF, nv, d]
    geo = element_for_cell(facets.cell_type, 1)
    phi = geo.shape_values(rule.points)              # [Q, nv]
    xq = np.einsum("qn,fnd->fqd", phi, fx)

    if facets.cell_type == "segment":
        t = fx[:, 1] - fx[:, 0]                      # [NF, 2]
        detS = np.linalg.norm(t, axis=1)
        n = np.stack([t[:, 1], -t[:, 0]], axis=1)
    else:
        # P1 triangle map x = x0 r + x1 s + x2 (1-r-s)
        e1 = fx[:, 0] - fx[:, 2]
        e2 = fx[:, 1] - fx[:, 2]
        n = np.cross(e1, e2)
        detS = np.linalg.norm(n, axis=1)
    n = n / detS[:, None]
    # orient outward: away from the owner element's opposite vertex
    center = fx.mean(axis=1)
    flip = ((center - coords[facets.opposite]) * n).sum(1) < 0
    n = np.where(flip[:, None], -n, n)
    return (xq.astype(dtype), detS.astype(dtype), n.astype(dtype))
