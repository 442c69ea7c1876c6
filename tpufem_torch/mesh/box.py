"""Kuhn (Freudenthal) split of the unit cube, as in tpufem.mesh.box.

Each cube cell is split into the 6 tetrahedra sharing the main diagonal
(v000, v111); every tet is a path v000 -> v111 along axis-aligned edges, so
the triangulation is conforming and shift-invariant (a fixed 15-point
stencil in the interior).
"""
from __future__ import annotations

import itertools

import numpy as np

__all__ = ["_KUHN_TETS"]


def _kuhn_tets() -> np.ndarray:
    tets = []
    for perm in itertools.permutations(range(3)):  # axis order (z=0, y=1, x=2)
        c = np.zeros(3, dtype=np.int64)
        verts = [c.copy()]
        for ax in perm:
            c = c.copy()
            c[ax] = 1
            verts.append(c)
        tets.append(np.stack(verts))
    return np.stack(tets)


# [6, 4, 3] corner offsets (dz, dy, dx) per vertex of each Kuhn tet
_KUHN_TETS = _kuhn_tets()
