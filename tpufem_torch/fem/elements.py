"""Reference elements (host numpy): the P1 triangle and tetrahedron."""
from __future__ import annotations

import numpy as np

__all__ = ["P1Triangle", "P1Tetrahedron"]


class P1Triangle:
    """Linear triangle; node order (r, s, 1 - r - s)."""

    def shape_values(self, points: np.ndarray) -> np.ndarray:
        """phi_n(q) -> [Q, 3]."""
        r, s = points[:, 0], points[:, 1]
        return np.stack([r, s, 1.0 - r - s], axis=1)


class P1Tetrahedron:
    """Linear tetrahedron; node order (r, s, t, 1 - r - s - t)."""

    def shape_values(self, points: np.ndarray) -> np.ndarray:
        """phi_n(q) -> [Q, 4]."""
        r, s, t = points[:, 0], points[:, 1], points[:, 2]
        return np.stack([r, s, t, 1.0 - r - s - t], axis=1)
