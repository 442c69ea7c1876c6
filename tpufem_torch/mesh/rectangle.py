"""Structured 2D triangle and quad meshes (host numpy), as in
tpufem.mesh.rectangle.

  * nodes: (n_row+1) x (n_col+1), row-major, node (i, j) has index
    ``i*(n_col+1)+j``, coordinates (x0 + j*stepx, y0 + i*stepy);
  * boundary flag 1 iff i in {0, n_row} or j in {0, n_col};
  * each cell (i, j) emits two triangles, lower (n, n+1, n+nc1) then upper
    (n+1, n+nc1+1, n+nc1), with n = i*nc1+j, nc1 = n_col+1.  The lower one
    is clockwise; assembly uses |det J|, so both orientations are right.

``rectangle_quad_mesh`` keeps the node numbering and flags with one
bilinear Q1 cell per grid cell.  ``perturbed_rectangle_mesh`` and
``perturbed_quad_mesh`` draw from ``np.random.default_rng(seed)`` in
the reference's order, so their meshes are bit-identical to the JAX
package's.
"""
from __future__ import annotations

import numpy as np

from tpufem_torch.mesh.core import Mesh, StructuredInfo

__all__ = ["rectangle_mesh", "unit_square_mesh", "RectangleMesh",
           "UnitSquareMesh", "perturbed_rectangle_mesh",
           "rectangle_quad_mesh", "perturbed_quad_mesh"]


def rectangle_mesh(x0: float, x1: float, y0: float, y1: float, n_row: int,
                   n_col: int) -> Mesh:
    """Structured triangle mesh of [x0,x1] x [y0,y1] with n_row x n_col
    cells."""
    if n_row < 1 or n_col < 1:
        raise ValueError("n_row and n_col must be >= 1")
    nc1 = n_col + 1
    nr1 = n_row + 1

    xs = x0 + (x1 - x0) / n_col * np.arange(nc1, dtype=np.float64)
    ys = y0 + (y1 - y0) / n_row * np.arange(nr1, dtype=np.float64)
    X, Y = np.meshgrid(xs, ys)  # [nr1, nc1]
    coords = np.stack([X.ravel(), Y.ravel()], axis=1)

    flags = np.zeros((nr1, nc1), dtype=np.int32)
    flags[0, :] = 1
    flags[-1, :] = 1
    flags[:, 0] = 1
    flags[:, -1] = 1

    ii, jj = np.meshgrid(np.arange(n_row, dtype=np.int32),
                         np.arange(n_col, dtype=np.int32), indexing="ij")
    n = (ii * nc1 + jj).ravel()
    lower = np.stack([n, n + 1, n + nc1], axis=1)
    upper = np.stack([n + 1, n + nc1 + 1, n + nc1], axis=1)
    conn = np.empty((2 * n.size, 3), dtype=np.int32)
    conn[0::2] = lower
    conn[1::2] = upper

    info = StructuredInfo(
        node_grid=(nr1, nc1),
        cell_grid=(n_row, n_col),
        type_node_offsets=np.array(
            [[[0, 0], [0, 1], [1, 0]],        # lower (n, n+1, n+nc1)
             [[0, 1], [1, 1], [1, 0]]],       # upper (n+1, n+nc1+1, n+nc1)
            dtype=np.int64),
    )
    return Mesh(coords=coords, conn=conn, node_flags=flags.ravel(),
                cell_type="triangle", structured=info)


def unit_square_mesh(n_row: int, n_col: int) -> Mesh:
    return rectangle_mesh(0.0, 1.0, 0.0, 1.0, n_row, n_col)


def perturbed_rectangle_mesh(x0, x1, y0, y1, n_row, n_col, *,
                             jitter: float = 0.2, seed: int = 0,
                             renumber: bool = True) -> Mesh:
    """An unstructured triangle mesh: the structured topology with randomly
    renumbered nodes and jittered interior coordinates.  ``jitter`` is the
    perturbation in units of the cell size (< 0.5 keeps every triangle
    valid)."""
    base = rectangle_mesh(x0, x1, y0, y1, n_row, n_col)
    rng = np.random.default_rng(seed)
    if renumber:
        perm = rng.permutation(base.num_nodes).astype(np.int32)
    else:
        perm = np.arange(base.num_nodes, dtype=np.int32)
    coords = np.empty_like(base.coords)
    coords[perm] = base.coords
    flags = np.empty_like(base.node_flags)
    flags[perm] = base.node_flags
    conn = perm[base.conn]
    if jitter:
        h = min((x1 - x0) / n_col, (y1 - y0) / n_row)
        interior = flags == 0
        coords[interior] += rng.uniform(-jitter * h, jitter * h,
                                        (int(interior.sum()), 2))
    return Mesh(coords=coords, conn=conn, node_flags=flags,
                cell_type="triangle")


def rectangle_quad_mesh(x0: float, x1: float, y0: float, y1: float,
                        n_row: int, n_col: int) -> Mesh:
    """Structured quadrilateral mesh: the node numbering and boundary
    flags of :func:`rectangle_mesh`, one bilinear Q1 cell per grid cell.
    Node order per cell is counterclockwise (n, n+1, n+nc1+1, n+nc1),
    matching ``fem.elements.Q1Quad``."""
    if n_row < 1 or n_col < 1:
        raise ValueError("n_row and n_col must be >= 1")
    nc1 = n_col + 1
    nr1 = n_row + 1

    xs = x0 + (x1 - x0) / n_col * np.arange(nc1, dtype=np.float64)
    ys = y0 + (y1 - y0) / n_row * np.arange(nr1, dtype=np.float64)
    X, Y = np.meshgrid(xs, ys)
    coords = np.stack([X.ravel(), Y.ravel()], axis=1)

    flags = np.zeros((nr1, nc1), dtype=np.int32)
    flags[0, :] = 1
    flags[-1, :] = 1
    flags[:, 0] = 1
    flags[:, -1] = 1

    ii, jj = np.meshgrid(
        np.arange(n_row, dtype=np.int32), np.arange(n_col, dtype=np.int32),
        indexing="ij")
    n = (ii * nc1 + jj).ravel()
    conn = np.stack([n, n + 1, n + nc1 + 1, n + nc1], axis=1)

    info = StructuredInfo(
        node_grid=(nr1, nc1), cell_grid=(n_row, n_col),
        type_node_offsets=np.array(
            [[[0, 0], [0, 1], [1, 1], [1, 0]]], dtype=np.int64))
    return Mesh(coords=coords, conn=conn, node_flags=flags.ravel(),
                cell_type="quad", structured=info)


def perturbed_quad_mesh(x0, x1, y0, y1, n_row, n_col, *,
                        jitter: float = 0.2, seed: int = 0,
                        renumber: bool = True) -> Mesh:
    """An unstructured quad mesh: jittered interior nodes (general
    non-parallelogram cells, so the bilinear Jacobian varies within each
    element) and optional random node renumbering; ``jitter`` < 0.5 keeps
    all quads convex."""
    base = rectangle_quad_mesh(x0, x1, y0, y1, n_row, n_col)
    rng = np.random.default_rng(seed)
    if renumber:
        perm = rng.permutation(base.num_nodes).astype(np.int32)
    else:
        perm = np.arange(base.num_nodes, dtype=np.int32)
    coords = np.empty_like(base.coords)
    coords[perm] = base.coords
    flags = np.empty_like(base.node_flags)
    flags[perm] = base.node_flags
    conn = perm[base.conn]
    if jitter:
        h = min((x1 - x0) / n_col, (y1 - y0) / n_row)
        interior = flags == 0
        coords[interior] += rng.uniform(-jitter * h, jitter * h,
                                        (int(interior.sum()), 2))
    return Mesh(coords=coords, conn=conn, node_flags=flags,
                cell_type="quad")


def RectangleMesh(x0, x1, y0, y1, n_row, n_col) -> Mesh:  # noqa: N802
    return rectangle_mesh(x0, x1, y0, y1, n_row, n_col)


def UnitSquareMesh(n_row, n_col) -> Mesh:  # noqa: N802
    return unit_square_mesh(n_row, n_col)
