"""Batch-trailing P1 element kernels, as in tpufem.assemble.planar:
coordinates are nested lists Xviews[t][n][d] of [*cell_grid] planes, so a
structured grid passes zero-copy slices of its node-coordinate grid.  The
planes may be numpy arrays (the one-cell stiffness of the analytic
multigrid hierarchy, float64) or torch tensors (the host build behind
``solve_poisson_fast(use_fused=False)``, and ``p1_gradients`` in the plain
version of the fused build)."""
from __future__ import annotations

import numpy as np
import torch

from tpufem_torch.fem.elements import P1Tetrahedron

__all__ = ["element_coord_views", "element_load_views", "p1_gradients",
           "p1_stiffness_views"]


def _stack(planes):
    if isinstance(planes[0], torch.Tensor):
        return torch.stack(planes)
    return np.stack(planes)


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
    """Xt [4][3] vertex coordinate planes (numpy arrays or torch tensors)
    -> (G [4][3] planes of d phi_n / d x_d, signed det J plane)."""
    if len(Xt[0]) != 3:
        raise NotImplementedError("the port's P1 kernels are 3D")
    J = [[Xt[m][d] - Xt[3][d] for m in range(3)] for d in range(3)]
    det, inv = _det_inv_3x3(J)
    G = [list(inv[n]) for n in range(3)]
    G.append([-(inv[0][d] + inv[1][d] + inv[2][d]) for d in range(3)])
    return G, det


def p1_stiffness_views(Xviews):
    """Xviews[t][n][d] of [*B] planes -> Ke [T, npe, npe, *B] (P1 Poisson
    stiffness on tetrahedra)."""
    out_t = []
    for Xt in Xviews:
        G, det = p1_gradients(Xt)
        vol = abs(det) * (1.0 / 6.0)
        npe = len(G)
        out_t.append(_stack([
            _stack([sum(G[a][d] * G[b][d] for d in range(3)) * vol
                    for b in range(npe)]) for a in range(npe)]))
    return _stack(out_t)


def element_load_views(Xviews, rule, f_planes):
    """Xviews[t][n][d] of [*B] planes -> be [T, npe, *B]:
    b_a = sum_q w_q phi_a(q) f(x_q) |det J| (P1 tetrahedra)."""
    phi = P1Tetrahedron().shape_values(rule.points)
    w = rule.weights
    out_t = []
    for Xt in Xviews:
        npe = len(Xt)
        _, det = p1_gradients(Xt)
        adet = abs(det)
        acc = [0.0] * npe
        for q in range(rule.num_points):
            xq = [sum(float(phi[q, n]) * Xt[n][d] for n in range(npe))
                  for d in range(3)]
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
