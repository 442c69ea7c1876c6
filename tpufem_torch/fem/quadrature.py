"""Quadrature rules on the reference triangle and tetrahedron (host numpy),
as in tpufem.fem.quadrature.

Reference coords (r, s[, t]), last barycentric 1 - r - s[ - t]; weights
sum to the reference cell's measure (1/2 for the triangle, 1/6 for the
tetrahedron), so the quadrature of ``f * |det J|`` needs no extra factor.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["QuadratureRule", "triangle_rule", "tetrahedron_rule",
           "rule_for_cell"]


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
    raise NotImplementedError(f"triangle rule of degree {degree} "
                              "(the port has degrees 1-5)")


def tetrahedron_rule(degree: int) -> QuadratureRule:
    """Rules on the reference tetrahedron of degree 1-3."""
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
    raise NotImplementedError(f"tetrahedron rule of degree {degree} "
                              "(the port has degrees 1-3)")


def rule_for_cell(cell_type: str, degree: int) -> QuadratureRule:
    """The rule of ``degree`` on a simplex cell."""
    if cell_type == "triangle":
        return triangle_rule(degree)
    if cell_type == "tetrahedron":
        return tetrahedron_rule(degree)
    raise NotImplementedError(f"quadrature on {cell_type!r} cells (the port "
                              "has triangles and tetrahedra)")
