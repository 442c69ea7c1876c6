"""Quadrature rules on the reference cells (host numpy), as in
tpufem.fem.quadrature.

Simplex coords (r, s[, t]), last barycentric 1 - r - s[ - t]; weights sum
to the reference cell's measure (1 for the segment [0, 1], 1/2 for the
triangle, 1/6 for the tetrahedron, 1 for the unit square and cube), so the
quadrature of ``f * |det J|`` needs no extra factor.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["QuadratureRule", "segment_rule", "triangle_rule",
           "tetrahedron_rule", "quad_rule", "hexahedron_rule",
           "rule_for_cell",
           "TRI7_FP32_W", "TRI7_FP32_R", "TRI7_FP32_S", "TRI7_FP32_T"]


@dataclasses.dataclass(frozen=True)
class QuadratureRule:
    """points [Q, dim] reference coordinates, weights [Q] (float64)."""

    points: np.ndarray
    weights: np.ndarray
    degree: int
    cell_type: str

    @property
    def num_points(self) -> int:
        return self.weights.shape[0]

    def barycentric(self) -> np.ndarray:
        """[Q, dim+1] full barycentric coordinates (last = 1 - sum)."""
        last = 1.0 - self.points.sum(axis=1, keepdims=True)
        return np.concatenate([self.points, last], axis=1)


# The reference's float32 tables of the 7-point triangle rule, verbatim:
# weights and the barycentric coordinates (r, s, t) of each point, in the
# exact rule's point order (``triangle_rule(5)`` reproduces them to fp32).
TRI7_FP32_W = np.array(
    [0.06296959, 0.06619708, 0.06296959, 0.06619708, 0.06296959, 0.06619708,
     0.11250000], dtype=np.float32)
TRI7_FP32_R = np.array(
    [0.10128651, 0.47014206, 0.79742699, 0.47014206, 0.10128651, 0.05971587,
     0.33333333], dtype=np.float32)
TRI7_FP32_S = np.array(
    [0.10128651, 0.05971587, 0.10128651, 0.47014206, 0.79742699, 0.47014206,
     0.33333333], dtype=np.float32)
TRI7_FP32_T = np.array(
    [0.79742698, 0.47014207, 0.1012865, 0.05971588, 0.1012865, 0.47014207,
     0.33333334], dtype=np.float32)


def _tri7_exact() -> QuadratureRule:
    """The exact degree-5 7-point rule, in the reference's point order."""
    s15 = math.sqrt(15.0)
    a1 = (6.0 - s15) / 21.0
    a2 = (6.0 + s15) / 21.0
    b1 = 1.0 - 2.0 * a1
    b2 = 1.0 - 2.0 * a2
    w1 = (155.0 - s15) / 2400.0
    w2 = (155.0 + s15) / 2400.0
    wc = 9.0 / 80.0                  # 3 w1 + 3 w2 + wc = 1/2
    pts = np.array(
        [[a1, a1], [a2, b2], [b1, a1], [a2, a2], [a1, b1], [b2, a2],
         [1.0 / 3.0, 1.0 / 3.0]], dtype=np.float64)
    w = np.array([w1, w2, w1, w2, w1, w2, wc], dtype=np.float64)
    return QuadratureRule(pts, w, 5, "triangle")


def segment_rule(degree: int) -> QuadratureRule:
    """Gauss-Legendre on [0, 1] (weights sum to 1): the facet rule of 2D
    meshes (boundary / Neumann integrals)."""
    n1 = max(1, (degree + 2) // 2)           # exact to 2*n1 - 1 >= degree
    x, w = np.polynomial.legendre.leggauss(n1)
    pts = (0.5 * (x + 1.0))[:, None]
    return QuadratureRule(points=pts, weights=0.5 * w, degree=2 * n1 - 1,
                          cell_type="segment")


def triangle_rule(degree: int) -> QuadratureRule:
    """Symmetric Gauss rules on the reference triangle of degree 1-3, and
    the 7-point rule for degrees 4-5."""
    if degree <= 1:
        pts = np.array([[1 / 3, 1 / 3]], dtype=np.float64)
        w = np.array([0.5], dtype=np.float64)
        return QuadratureRule(pts, w, 1, "triangle")
    if degree == 2:
        pts = np.array([[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]],
                       dtype=np.float64)
        w = np.full(3, 1 / 6, dtype=np.float64)
        return QuadratureRule(pts, w, 2, "triangle")
    if degree == 3:
        # centroid (negative weight) + 3 points
        pts = np.array([[1 / 3, 1 / 3], [0.6, 0.2], [0.2, 0.6], [0.2, 0.2]],
                       dtype=np.float64)
        w = np.array([-27 / 96, 25 / 96, 25 / 96, 25 / 96], dtype=np.float64)
        return QuadratureRule(pts, w, 3, "triangle")
    if degree <= 5:
        return _tri7_exact()
    raise NotImplementedError(f"triangle rule of degree {degree}")


def tetrahedron_rule(degree: int) -> QuadratureRule:
    """Rules on the reference tetrahedron (weights sum to 1/6)."""
    if degree <= 1:
        pts = np.array([[0.25, 0.25, 0.25]], dtype=np.float64)
        w = np.array([1 / 6], dtype=np.float64)
        return QuadratureRule(pts, w, 1, "tetrahedron")
    if degree == 2:
        a = (5.0 - math.sqrt(5.0)) / 20.0
        b = (5.0 + 3.0 * math.sqrt(5.0)) / 20.0
        pts = np.array(
            [[a, a, a], [b, a, a], [a, b, a], [a, a, b]], dtype=np.float64)
        w = np.full(4, 1 / 24, dtype=np.float64)
        return QuadratureRule(pts, w, 2, "tetrahedron")
    if degree == 3:
        # centroid (negative weight) + 4 points
        a, b = 1 / 6, 1 / 2
        pts = np.array(
            [[0.25, 0.25, 0.25],
             [b, a, a], [a, b, a], [a, a, b], [a, a, a]], dtype=np.float64)
        w = np.array([-2 / 15, 3 / 40, 3 / 40, 3 / 40, 3 / 40],
                     dtype=np.float64)
        return QuadratureRule(pts, w, 3, "tetrahedron")
    # degree >= 4: Duffy-collapsed tensor Gauss-Legendre, exact by
    # construction for any degree.  The map r = X, s = Y(1-X),
    # t = Z(1-X)(1-Y) sends [0,1]^3 to the reference tet with Jacobian
    # (1-X)^2 (1-Y); GL with n points is exact to 2n-1 >= degree+2 (the
    # Jacobian's extra polynomial degree).  n^3 points: 64 at degree 4.
    n1 = (degree + 4) // 2
    x, wx = np.polynomial.legendre.leggauss(n1)
    x = 0.5 * (x + 1.0)
    wx = 0.5 * wx
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    W = (wx[:, None, None] * wx[None, :, None] * wx[None, None, :])
    r = X
    s = Y * (1.0 - X)
    t = Z * (1.0 - X) * (1.0 - Y)
    w = (W * (1.0 - X) ** 2 * (1.0 - Y)).reshape(-1)
    pts = np.stack([r.reshape(-1), s.reshape(-1), t.reshape(-1)], axis=1)
    return QuadratureRule(pts, w, degree, "tetrahedron")


def _tensor_rule(degree: int, dim: int, cell_type: str) -> QuadratureRule:
    """Tensor-product Gauss-Legendre on [0, 1]^dim (weights sum to 1),
    exact for polynomials of degree <= 2*n1 - 1 per axis: the exactness
    that tensor-product (Q1) bases need."""
    n1 = max(1, (degree + 2) // 2)
    x, w = np.polynomial.legendre.leggauss(n1)
    x = 0.5 * (x + 1.0)
    w = 0.5 * w
    grids = np.meshgrid(*([x] * dim), indexing="ij")
    pts = np.stack([g.reshape(-1) for g in grids], axis=1)
    wgrids = np.meshgrid(*([w] * dim), indexing="ij")
    weights = np.ones(pts.shape[0], dtype=np.float64)
    for wg in wgrids:
        weights = weights * wg.reshape(-1)
    return QuadratureRule(pts, weights, 2 * n1 - 1, cell_type)


def quad_rule(degree: int) -> QuadratureRule:
    """Gauss rule on the reference square [0, 1]^2 (weights sum to 1)."""
    return _tensor_rule(degree, 2, "quad")


def hexahedron_rule(degree: int) -> QuadratureRule:
    """Gauss rule on the reference cube [0, 1]^3 (weights sum to 1)."""
    return _tensor_rule(degree, 3, "hexahedron")


def rule_for_cell(cell_type: str, degree: int) -> QuadratureRule:
    if cell_type == "segment":
        return segment_rule(degree)
    if cell_type == "triangle":
        return triangle_rule(degree)
    if cell_type == "tetrahedron":
        return tetrahedron_rule(degree)
    if cell_type == "quad":
        return quad_rule(degree)
    if cell_type == "hexahedron":
        return hexahedron_rule(degree)
    raise ValueError(f"unknown cell type {cell_type!r}")
