"""Reference elements (host numpy): shape functions and their
reference-coordinate gradients, as in tpufem.fem.elements.

On the triangle phi = (r, s, 1-r-s), the affine map fx = x1*r + x2*s +
x3*(1-r-s); the tetrahedron extends this to phi = (r, s, t, 1-r-s-t).  The
tables are the reference's, value for value, so every table the port
evaluates equals the JAX package's bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ReferenceElement", "P1Segment", "P2Segment", "P1Triangle",
           "P1Tetrahedron", "P2Triangle", "P2Tetrahedron",
           "Q1Quad", "Q1Hex", "element_for_cell", "is_affine_cell"]


@dataclasses.dataclass(frozen=True)
class ReferenceElement:
    name: str
    cell_type: str
    dim: int
    num_nodes: int
    degree: int

    def shape_values(self, points: np.ndarray) -> np.ndarray:
        """phi_n(q) -> [Q, num_nodes]."""
        raise NotImplementedError

    def shape_grads(self, points: np.ndarray) -> np.ndarray:
        """d phi_n / d(ref coords) at q -> [Q, num_nodes, dim]."""
        raise NotImplementedError


class P1Segment(ReferenceElement):
    """Linear segment [0, 1], the facet element of 2D meshes (boundary
    integrals, Neumann/Robin terms).  DOF order: endpoints (0, 1)."""

    def __init__(self):
        super().__init__("P1", "segment", 1, 2, 1)

    def shape_values(self, points):
        x = points[:, 0]
        return np.stack([1.0 - x, x], axis=1)

    def shape_grads(self, points):
        q = points.shape[0]
        g = np.array([[-1.0], [1.0]])
        return np.broadcast_to(g, (q, 2, 1)).copy()


class P2Segment(ReferenceElement):
    """Quadratic segment: endpoints + midpoint (the trace of P2Triangle /
    P2Tetrahedron on a boundary edge).  DOF order: (0, 1, mid)."""

    def __init__(self):
        super().__init__("P2", "segment", 1, 3, 2)

    def shape_values(self, points):
        x = points[:, 0]
        return np.stack([(1 - x) * (1 - 2 * x), x * (2 * x - 1),
                         4 * x * (1 - x)], axis=1)

    def shape_grads(self, points):
        x = points[:, 0]
        return np.stack([4 * x - 3, 4 * x - 1, 4 - 8 * x],
                        axis=1)[:, :, None]


class P1Triangle(ReferenceElement):
    """Linear triangle; node order (r, s, 1 - r - s)."""

    def __init__(self):
        super().__init__("P1", "triangle", 2, 3, 1)

    def shape_values(self, points):
        r, s = points[:, 0], points[:, 1]
        return np.stack([r, s, 1.0 - r - s], axis=1)

    def shape_grads(self, points):
        q = points.shape[0]
        g = np.array([[1.0, 0.0], [0.0, 1.0], [-1.0, -1.0]])
        return np.broadcast_to(g, (q, 3, 2)).copy()


class P1Tetrahedron(ReferenceElement):
    """Linear tetrahedron; node order (r, s, t, 1 - r - s - t)."""

    def __init__(self):
        super().__init__("P1", "tetrahedron", 3, 4, 1)

    def shape_values(self, points):
        r, s, t = points[:, 0], points[:, 1], points[:, 2]
        return np.stack([r, s, t, 1.0 - r - s - t], axis=1)

    def shape_grads(self, points):
        q = points.shape[0]
        g = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0],
                      [-1.0, -1.0, -1.0]])
        return np.broadcast_to(g, (q, 4, 3)).copy()


class P2Triangle(ReferenceElement):
    """Quadratic triangle: 3 vertex DOFs + 3 edge-midpoint DOFs.

    DOF order: vertices (r, s, t directions as in P1), then midpoints of
    edges (1-2), (2-3), (3-1), i.e. opposite barycentrics (t, r, s).
    """

    def __init__(self):
        super().__init__("P2", "triangle", 2, 6, 2)

    def shape_values(self, points):
        r, s = points[:, 0], points[:, 1]
        t = 1.0 - r - s
        return np.stack([
            r * (2 * r - 1), s * (2 * s - 1), t * (2 * t - 1),
            4 * r * s, 4 * s * t, 4 * t * r,
        ], axis=1)

    def shape_grads(self, points):
        r, s = points[:, 0], points[:, 1]
        t = 1.0 - r - s
        zeros = np.zeros_like(r)
        # d/dr, d/ds with dt/dr = dt/ds = -1
        dr = np.stack([
            4 * r - 1, zeros, -(4 * t - 1),
            4 * s, -4 * s, 4 * (t - r),
        ], axis=1)
        ds = np.stack([
            zeros, 4 * s - 1, -(4 * t - 1),
            4 * r, 4 * (t - s), -4 * r,
        ], axis=1)
        return np.stack([dr, ds], axis=2)  # [Q, 6, 2]


class P2Tetrahedron(ReferenceElement):
    """Quadratic tetrahedron: 4 vertex DOFs + 6 edge-midpoint DOFs.

    DOF order: vertices with barycentrics lam = (r, s, t, 1-r-s-t), then
    midpoints of edges (0-1), (1-2), (2-0), (0-3), (1-3), (2-3), matching
    fem.space._EDGE_VERTICES["tetrahedron"].
    """

    _EDGES = ((0, 1), (1, 2), (2, 0), (0, 3), (1, 3), (2, 3))

    def __init__(self):
        super().__init__("P2", "tetrahedron", 3, 10, 2)

    @staticmethod
    def _lams(points):
        r, s, t = points[:, 0], points[:, 1], points[:, 2]
        return [r, s, t, 1.0 - r - s - t]

    # gradients of the barycentrics with respect to (r, s, t)
    _DLAM = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0],
                      [-1.0, -1.0, -1.0]])

    def shape_values(self, points):
        lam = self._lams(points)
        vals = [li * (2 * li - 1) for li in lam]
        vals += [4 * lam[a] * lam[b] for a, b in self._EDGES]
        return np.stack(vals, axis=1)

    def shape_grads(self, points):
        lam = self._lams(points)
        grads = []
        for i in range(4):
            grads.append((4 * lam[i] - 1)[:, None] * self._DLAM[i])
        for a, b in self._EDGES:
            grads.append(4 * (lam[a][:, None] * self._DLAM[b]
                              + lam[b][:, None] * self._DLAM[a]))
        return np.stack(grads, axis=1)          # [Q, 10, 3]


class _TensorProductQ1(ReferenceElement):
    """Multilinear Lagrange element on the unit d-cube [0, 1]^d.

    The shape function of the corner node with binary coordinates
    (a_1, ..., a_d) is the product of the 1-D hat factors f_0(x) = 1 - x,
    f_1(x) = x along each axis.  The coordinate map x(r) built from these
    is bilinear / trilinear: its Jacobian varies across the cell, so
    assembly evaluates the geometry at every quadrature point
    (forms.weakform._geometry).
    """

    _CORNERS: np.ndarray  # [num_nodes, dim] binary corner coordinates

    def shape_values(self, points):
        # phi[q, n] = prod_m f_{corner[n, m]}(points[q, m])
        p = points[:, None, :]                       # [Q, 1, dim]
        a = self._CORNERS[None, :, :]                # [1, n, dim]
        factors = np.where(a == 1, p, 1.0 - p)      # [Q, n, dim]
        return factors.prod(axis=2)

    def shape_grads(self, points):
        p = points[:, None, :]
        a = self._CORNERS[None, :, :]
        factors = np.where(a == 1, p, 1.0 - p)      # [Q, n, dim]
        dfactors = np.where(a == 1, 1.0, -1.0)      # [1, n, dim] signs
        grads = np.empty((points.shape[0], self.num_nodes, self.dim))
        for m in range(self.dim):
            others = [k for k in range(self.dim) if k != m]
            prod = np.ones_like(factors[..., 0])
            for k in others:
                prod = prod * factors[..., k]
            grads[..., m] = dfactors[..., m] * prod
        return grads


class Q1Quad(_TensorProductQ1):
    """Bilinear quadrilateral, nodes counterclockwise:
    (0,0), (1,0), (1,1), (0,1)."""

    _CORNERS = np.array([[0, 0], [1, 0], [1, 1], [0, 1]])

    def __init__(self):
        super().__init__("Q1", "quad", 2, 4, 1)


class Q1Hex(_TensorProductQ1):
    """Trilinear hexahedron, VTK node order: bottom face counterclockwise
    (0,0,0), (1,0,0), (1,1,0), (0,1,0), then the top face in the same
    order at t = 1."""

    _CORNERS = np.array([
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ])

    def __init__(self):
        super().__init__("Q1", "hexahedron", 3, 8, 1)


def is_affine_cell(cell_type: str) -> bool:
    """True for cells whose P1 coordinate map has a constant Jacobian
    (simplices); False for tensor-product cells (quad/hex), whose
    multilinear map needs per-quadrature-point geometry."""
    return cell_type in ("segment", "triangle", "tetrahedron")


def element_for_cell(cell_type: str, degree: int = 1) -> ReferenceElement:
    table = {
        ("segment", 1): P1Segment,
        ("segment", 2): P2Segment,
        ("triangle", 1): P1Triangle,
        ("triangle", 2): P2Triangle,
        ("tetrahedron", 1): P1Tetrahedron,
        ("tetrahedron", 2): P2Tetrahedron,
        ("quad", 1): Q1Quad,
        ("hexahedron", 1): Q1Hex,
    }
    try:
        return table[(cell_type, degree)]()
    except KeyError:
        raise NotImplementedError(
            f"element of degree {degree} on {cell_type}") from None
