"""Batched element kernels: geometry, local stiffness, local load, as in
tpufem.assemble.local.

The whole element batch is a few broadcast-multiply-reduce passes in
plain PyTorch (the reference computes them in XLA, outside Pallas).  |det J|
is used explicitly and the quadrature weights carry the reference cell's
measure, so both element orientations come out right.
"""
from __future__ import annotations

import torch

__all__ = ["affine_geometry", "p1_stiffness", "element_mass",
           "element_load", "element_nonlinear_load", "map_points"]

_REF_VOLUME = {"triangle": 0.5, "tetrahedron": 1.0 / 6.0}


def _inv_and_det(J):
    """Adjugate-based inverse + determinant for [..., d, d], d in {2, 3}."""
    d = J.shape[-1]
    if d == 2:
        a, b = J[..., 0, 0], J[..., 0, 1]
        c, e = J[..., 1, 0], J[..., 1, 1]
        det = a * e - b * c
        inv = torch.stack([torch.stack([e, -b], dim=-1),
                           torch.stack([-c, a], dim=-1)],
                          dim=-2) / det[..., None, None]
        return inv, det
    if d == 3:
        m = J
        c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
        c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
        c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
        det = (m[..., 0, 0] * c00 + m[..., 0, 1] * c01 + m[..., 0, 2] * c02)
        c10 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
        c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
        c12 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
        c20 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
        c21 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
        c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
        adjT = torch.stack([torch.stack([c00, c10, c20], dim=-1),
                            torch.stack([c01, c11, c21], dim=-1),
                            torch.stack([c02, c12, c22], dim=-1)], dim=-2)
        return adjT / det[..., None, None], det
    raise NotImplementedError(f"dim {d}")


def affine_geometry(ecoords: torch.Tensor, element):
    """Affine geometry of P1 simplices: ecoords [NE, npe, dim] ->
    (physical shape gradients [NE, npe, dim], |det J| [NE])."""
    if element.cell_type not in _REF_VOLUME:
        raise NotImplementedError(
            f"affine geometry is undefined for {element.cell_type!r} "
            "(multilinear map, non-constant Jacobian)")
    # J[e, d, m] = x[e, m, d] - x[e, last, d]: coordinate differences
    last = ecoords[:, -1:, :]
    J = (ecoords[:, :-1, :] - last).transpose(1, 2)
    invJ, det = _inv_and_det(J)
    # the reference gradients are the identity rows and a row of -1
    G = torch.cat([invJ, -invJ.sum(dim=1, keepdim=True)], dim=1)
    return G, det.abs()


def p1_stiffness(ecoords: torch.Tensor, element) -> torch.Tensor:
    """Closed-form P1 Poisson local stiffness K_e = (G G^T) |det J| |ref|,
    [NE, npe, npe]."""
    G, adet = affine_geometry(ecoords, element)
    vol = adet * _REF_VOLUME[element.cell_type]
    K = (G[:, :, None, :] * G[:, None, :, :]).sum(-1)
    return K * vol[:, None, None]


def _table(a, like: torch.Tensor, dtype=None) -> torch.Tensor:
    return torch.as_tensor(a, dtype=dtype or like.dtype, device=like.device)


def element_mass(ecoords: torch.Tensor, element, rule, dtype=None):
    """Local mass matrices M_e[i,j] = sum_q w_q phi_i phi_j |det J|."""
    phi = _table(element.shape_values(rule.points), ecoords, dtype)
    w = _table(rule.weights, ecoords, dtype)
    _, adet = affine_geometry(ecoords, element)
    mref = ((w[:, None, None] * phi[:, :, None]) * phi[:, None, :]).sum(0)
    return mref[None] * adet[:, None, None]


def map_points(ecoords: torch.Tensor, element, rule) -> torch.Tensor:
    """Physical coordinates of the quadrature points, [NE, Q, dim]."""
    phi = _table(element.shape_values(rule.points), ecoords)
    return (phi[None, :, :, None] * ecoords[:, None, :, :]).sum(2)


def element_nonlinear_load(ecoords: torch.Tensor, element, rule, u_local,
                           g) -> torch.Tensor:
    """State-dependent load b_e[i] = sum_q w_q phi_i(q) g(u(x_q)) |det J|:
    the element vector of a semilinear term ``∫ g(u) v``, the local DOFs
    ``u_local [NE, n]`` interpolated to the quadrature points.  Plain
    tensor operations, so a forward-mode dual ``u_local`` carries the
    Gateaux derivative ∫ g'(u) w v (what Newton's Jacobian needs)."""
    phi = _table(element.shape_values(rule.points), ecoords)
    w = _table(rule.weights, ecoords)
    _, adet = affine_geometry(ecoords, element)
    uq = (phi[None, :, :] * u_local[:, None, :]).sum(-1)   # [NE, Q]
    gq = g(uq)
    wphi = w[:, None] * phi                                # [Q, n]
    be = (gq[:, :, None] * wphi[None, :, :]).sum(1)        # [NE, n]
    return be * adet[:, None]


def element_load(ecoords: torch.Tensor, element, rule, f) -> torch.Tensor:
    """Local load vectors b_e[i] = sum_q w_q phi_i(q) f(x_q) |det J|;
    ``f`` maps [..., dim] physical coordinates to [...] values."""
    phi = _table(element.shape_values(rule.points), ecoords)
    w = _table(rule.weights, ecoords)
    _, adet = affine_geometry(ecoords, element)
    fq = f(map_points(ecoords, element, rule))           # [NE, Q]
    wphi = w[:, None] * phi                              # [Q, n]
    be = (fq[:, :, None] * wphi[None, :, :]).sum(1)      # [NE, n]
    return be * adet[:, None]
