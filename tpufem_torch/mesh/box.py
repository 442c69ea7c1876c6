"""Structured 3D tetrahedral meshes (Kuhn / Freudenthal split), as in
tpufem.mesh.box.

Node numbering extends the rectangle's row-major convention to 3D:

  node (i, j, k) -> index  i*(ny+1)*(nx+1) + j*(nx+1) + k   (z-major, then y,
  then x fastest), coordinate (x0 + k*dx, y0 + j*dy, z0 + i*dz);
  boundary flag 1 on any face of the box.

Each cube cell is split into the 6 tetrahedra sharing the main diagonal
(v000, v111); every tet is a path v000 -> v111 along axis-aligned edges, so
the triangulation is conforming and shift-invariant (a fixed 15-point
stencil in the interior).  The arithmetic is the reference's, so the
coordinates, connectivity and flags are bit-identical to the JAX package's.
``box_hex_mesh`` waits for the quad/hex cells (ROADMAP A3).
"""
from __future__ import annotations

import itertools

import numpy as np

from tpufem_torch.mesh.core import Mesh, StructuredInfo

__all__ = ["box_mesh", "unit_cube_mesh", "BoxMesh", "UnitCubeMesh",
           "_KUHN_TETS"]


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


def box_mesh(x0: float, x1: float, y0: float, y1: float, z0: float,
             z1: float, nx: int, ny: int, nz: int) -> Mesh:
    """Structured tet mesh of the box with nx*ny*nz cube cells (6 tets
    each)."""
    if min(nx, ny, nz) < 1:
        raise ValueError("nx, ny, nz must be >= 1")
    nx1, ny1, nz1 = nx + 1, ny + 1, nz + 1
    xs = x0 + (x1 - x0) / nx * np.arange(nx1, dtype=np.float64)
    ys = y0 + (y1 - y0) / ny * np.arange(ny1, dtype=np.float64)
    zs = z0 + (z1 - z0) / nz * np.arange(nz1, dtype=np.float64)
    Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")  # [nz1, ny1, nx1]
    coords = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    flags = np.zeros((nz1, ny1, nx1), dtype=np.int32)
    flags[0, :, :] = 1
    flags[-1, :, :] = 1
    flags[:, 0, :] = 1
    flags[:, -1, :] = 1
    flags[:, :, 0] = 1
    flags[:, :, -1] = 1

    ii, jj, kk = np.meshgrid(
        np.arange(nz, dtype=np.int64), np.arange(ny, dtype=np.int64),
        np.arange(nx, dtype=np.int64), indexing="ij")
    origins = np.stack([ii.ravel(), jj.ravel(), kk.ravel()], axis=1)  # [NC, 3]
    # conn[c, t, v] = node index of vertex v of Kuhn tet t in cube c
    pos = origins[:, None, None, :] + _KUHN_TETS[None]  # [NC, 6, 4, 3]
    idx = (pos[..., 0] * ny1 + pos[..., 1]) * nx1 + pos[..., 2]
    conn = idx.reshape(-1, 4).astype(np.int32)          # [NC*6, 4]

    info = StructuredInfo(node_grid=(nz1, ny1, nx1), cell_grid=(nz, ny, nx),
                          type_node_offsets=np.asarray(_KUHN_TETS,
                                                       dtype=np.int64))
    return Mesh(coords=coords, conn=conn, node_flags=flags.ravel(),
                cell_type="tetrahedron", structured=info)


def unit_cube_mesh(nx: int, ny: int, nz: int) -> Mesh:
    return box_mesh(0.0, 1.0, 0.0, 1.0, 0.0, 1.0, nx, ny, nz)


def BoxMesh(x0, x1, y0, y1, z0, z1, nx, ny, nz) -> Mesh:  # noqa: N802
    return box_mesh(x0, x1, y0, y1, z0, z1, nx, ny, nz)


def UnitCubeMesh(nx, ny, nz) -> Mesh:  # noqa: N802
    return unit_cube_mesh(nx, ny, nz)
