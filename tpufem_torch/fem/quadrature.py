"""Quadrature rules on the reference tetrahedron (host numpy), as in
tpufem.fem.quadrature.

Reference coords (r, s, t), fourth barycentric u = 1 - r - s - t; weights
sum to the reference-tet volume 1/6, so the quadrature of ``f * |det J|``
needs no extra volume factor.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["QuadratureRule", "tetrahedron_rule"]


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
