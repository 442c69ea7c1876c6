"""Batch-trailing P1 element kernels on triangles (2D) and tetrahedra (3D),
as in tpufem.assemble.planar.  Everything is stored batch-trailing:

    coords   X  [T, npe, dim, *grid]    (T = element types per cell)
    stiffness K [T, npe, npe, *grid]
    loads    b  [T, npe, *grid]

``element_coords_bt`` gathers X from a structured mesh on the host;
``p1_stiffness_bt`` and ``element_load_bt`` compute on X, and their
``*_views`` forms on nested lists Xviews[t][n][d] of [*cell_grid] planes,
so a structured grid passes zero-copy slices of its node-coordinate grid.
The planes may be numpy arrays (the one-cell stiffness of the analytic
multigrid hierarchy, float64) or torch tensors (the host build behind
``solve_poisson_fast(use_fused=False)``, the plain version of B13, and
``p1_gradients`` in the plain versions of the fused builds)."""
from __future__ import annotations

import numpy as np
import torch

from tpufem_torch.fem.elements import element_for_cell
from tpufem_torch.fem.quadrature import QuadratureRule

__all__ = ["element_coords_bt", "p1_stiffness_bt", "element_load_bt",
           "element_coord_views", "element_load_views", "p1_gradients",
           "p1_stiffness_views"]


def _stack(planes):
    if isinstance(planes[0], torch.Tensor):
        return torch.stack(planes)
    return np.stack(planes)


_REF_VOLUME = {"triangle": 0.5, "tetrahedron": 1.0 / 6.0}
_CELL = {2: "triangle", 3: "tetrahedron"}


def element_coords_bt(mesh, dtype=np.float32) -> np.ndarray:
    """[T, npe, dim, *cell_grid] element coordinates (host numpy), plane
    [t, n, d] holding coordinate d of node n of the type-t elements on the
    cell grid (the generators enumerate cell-major, T interleaved)."""
    info = mesh.structured
    if info is None:
        raise ValueError("mesh has no structured-grid metadata")
    ec = mesh.element_coords().reshape(*info.cell_grid, info.num_types,
                                       mesh.nodes_per_element, mesh.dim)
    g = len(info.cell_grid)
    perm = (g, g + 1, g + 2) + tuple(range(g))
    return np.ascontiguousarray(np.transpose(ec, perm), dtype=dtype)


def _views(X):
    T, npe, dim = X.shape[0], X.shape[1], X.shape[2]
    return [[[X[t, n, d] for d in range(dim)] for n in range(npe)]
            for t in range(T)]


def p1_stiffness_bt(X, cell_type: str):
    """X [T, npe, dim, *B] -> Ke [T, npe, npe, *B] (P1 Poisson stiffness)."""
    return p1_stiffness_views(_views(X), cell_type)


def element_load_bt(X, cell_type: str, rule: QuadratureRule, f_planes):
    """X [T, npe, dim, *B] -> be [T, npe, *B]:
    b_a = sum_q w_q phi_a(q) f(x_q) |det J|; ``f_planes(*coords)`` takes
    dim coordinate planes and returns one plane."""
    return element_load_views(_views(X), cell_type, rule, f_planes)


def _det_inv_2x2(J):
    det = J[0][0] * J[1][1] - J[0][1] * J[1][0]
    inv_det = 1.0 / det
    inv = [[J[1][1] * inv_det, -J[0][1] * inv_det],
           [-J[1][0] * inv_det, J[0][0] * inv_det]]
    return det, inv


def _det_inv_3x3(J):
    c00 = J[1][1] * J[2][2] - J[1][2] * J[2][1]
    c01 = J[1][2] * J[2][0] - J[1][0] * J[2][2]
    c02 = J[1][0] * J[2][1] - J[1][1] * J[2][0]
    det = J[0][0] * c00 + J[0][1] * c01 + J[0][2] * c02
    inv_det = 1.0 / det
    c10 = J[0][2] * J[2][1] - J[0][1] * J[2][2]
    c11 = J[0][0] * J[2][2] - J[0][2] * J[2][0]
    c12 = J[0][1] * J[2][0] - J[0][0] * J[2][1]
    c20 = J[0][1] * J[1][2] - J[0][2] * J[1][1]
    c21 = J[0][2] * J[1][0] - J[0][0] * J[1][2]
    c22 = J[0][0] * J[1][1] - J[0][1] * J[1][0]
    inv = [[c00 * inv_det, c10 * inv_det, c20 * inv_det],
           [c01 * inv_det, c11 * inv_det, c21 * inv_det],
           [c02 * inv_det, c12 * inv_det, c22 * inv_det]]
    return det, inv


def p1_gradients(Xt):
    """Xt [dim+1][dim] vertex coordinate planes (numpy arrays or torch
    tensors; dim 2 or 3) -> (G [dim+1][dim] planes of d phi_n / d x_d,
    signed det J plane)."""
    dim = len(Xt[0])
    if dim not in _CELL or len(Xt) != dim + 1:
        raise NotImplementedError("P1 kernels take triangles or tetrahedra")
    J = [[Xt[m][d] - Xt[dim][d] for m in range(dim)] for d in range(dim)]
    det, inv = (_det_inv_2x2 if dim == 2 else _det_inv_3x3)(J)
    G = [list(inv[n]) for n in range(dim)]
    G.append([-sum(inv[n][d] for n in range(dim)) for d in range(dim)])
    return G, det


def _check_cell(Xviews, cell_type: str) -> int:
    dim = len(Xviews[0][0])
    if _CELL.get(dim) != cell_type:
        raise ValueError(f"cell_type {cell_type!r} with {dim}D coordinates "
                         "(P1 triangles or tetrahedra)")
    return dim


def p1_stiffness_views(Xviews, cell_type: str):
    """Xviews[t][n][d] of [*B] planes -> Ke [T, npe, npe, *B] (P1 Poisson
    stiffness on triangles or tetrahedra)."""
    dim = _check_cell(Xviews, cell_type)
    out_t = []
    for Xt in Xviews:
        G, det = p1_gradients(Xt)
        vol = abs(det) * _REF_VOLUME[cell_type]
        npe = len(G)
        out_t.append(_stack([
            _stack([sum(G[a][d] * G[b][d] for d in range(dim)) * vol
                    for b in range(npe)]) for a in range(npe)]))
    return _stack(out_t)


def element_load_views(Xviews, cell_type: str, rule: QuadratureRule,
                       f_planes):
    """Xviews[t][n][d] of [*B] planes -> be [T, npe, *B]:
    b_a = sum_q w_q phi_a(q) f(x_q) |det J| (P1 triangles or tetrahedra)."""
    dim = _check_cell(Xviews, cell_type)
    phi = element_for_cell(cell_type, 1).shape_values(rule.points)
    w = rule.weights
    out_t = []
    for Xt in Xviews:
        npe = len(Xt)
        _, det = p1_gradients(Xt)
        adet = abs(det)
        acc = [0.0] * npe
        for q in range(rule.num_points):
            xq = [sum(float(phi[q, n]) * Xt[n][d] for n in range(npe))
                  for d in range(dim)]
            fq = f_planes(*xq)
            for a in range(npe):
                acc[a] = acc[a] + (float(w[q]) * float(phi[q, a])) * fq
        out_t.append(_stack([acc[a] * adet for a in range(npe)]))
    return _stack(out_t)


def element_coord_views(coords_grid: np.ndarray, info):
    """Zero-copy element-coordinate views from a node-coordinate grid
    [dim, *node_grid]: Xviews[t][n][d] of [*cell_grid] slices."""
    cg = info.cell_grid
    out = []
    for t in range(info.num_types):
        nodes = []
        for n in range(info.type_node_offsets.shape[1]):
            off = info.type_node_offsets[t, n]
            sl = tuple(slice(int(off[d]), int(off[d]) + cg[d])
                       for d in range(len(cg)))
            nodes.append([coords_grid[d][sl]
                          for d in range(coords_grid.shape[0])])
        out.append(nodes)
    return out
