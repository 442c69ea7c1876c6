"""Reference elements (host numpy): the P1 triangle and tetrahedron, as in
tpufem.fem.elements."""
from __future__ import annotations

import numpy as np

__all__ = ["P1Triangle", "P1Tetrahedron", "element_for_cell",
           "is_affine_cell"]


class P1Triangle:
    """Linear triangle; node order (r, s, 1 - r - s)."""

    name, cell_type, dim, num_nodes, degree = "P1", "triangle", 2, 3, 1

    def shape_values(self, points: np.ndarray) -> np.ndarray:
        """phi_n(q) -> [Q, 3]."""
        r, s = points[:, 0], points[:, 1]
        return np.stack([r, s, 1.0 - r - s], axis=1)

    def shape_grads(self, points: np.ndarray) -> np.ndarray:
        """d phi_n / d(r, s) at q -> [Q, 3, 2]."""
        g = np.array([[1.0, 0.0], [0.0, 1.0], [-1.0, -1.0]])
        return np.broadcast_to(g, (points.shape[0], 3, 2)).copy()


class P1Tetrahedron:
    """Linear tetrahedron; node order (r, s, t, 1 - r - s - t)."""

    name, cell_type, dim, num_nodes, degree = "P1", "tetrahedron", 3, 4, 1

    def shape_values(self, points: np.ndarray) -> np.ndarray:
        """phi_n(q) -> [Q, 4]."""
        r, s, t = points[:, 0], points[:, 1], points[:, 2]
        return np.stack([r, s, t, 1.0 - r - s - t], axis=1)

    def shape_grads(self, points: np.ndarray) -> np.ndarray:
        """d phi_n / d(r, s, t) at q -> [Q, 4, 3]."""
        g = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0],
                      [-1.0, -1.0, -1.0]])
        return np.broadcast_to(g, (points.shape[0], 4, 3)).copy()


def is_affine_cell(cell_type: str) -> bool:
    """True for cells whose P1 coordinate map has a constant Jacobian
    (simplices); False for tensor-product cells (quad/hex)."""
    return cell_type in ("segment", "triangle", "tetrahedron")


def element_for_cell(cell_type: str, degree: int = 1):
    """The port's P1 simplices; other elements are not ported yet."""
    table = {("triangle", 1): P1Triangle, ("tetrahedron", 1): P1Tetrahedron}
    try:
        return table[(cell_type, degree)]()
    except KeyError:
        raise NotImplementedError(
            f"element of degree {degree} on {cell_type} (the port has the "
            "P1 triangle and tetrahedron)") from None
