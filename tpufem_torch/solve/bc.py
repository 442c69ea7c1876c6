"""Dirichlet boundary conditions by symmetric elimination, as in
tpufem.solve.bc:

    b <- b - A g ;  b[bc] <- g[bc] ;  A[bc, :] <- 0 ; A[:, bc] <- 0 ;
    A[bc, bc] <- 1

which keeps A symmetric (so CG still applies) and enforces u[bc] = g[bc]
exactly.  Ported: the stencil-matrix form and the matrix-free wrappers.
The product A g runs through ``StencilMatrix.matvec`` (kernel K2 on a CUDA
tensor); the elimination itself is a few elementwise passes over the
planes, as in the reference.
"""
from __future__ import annotations

import torch

from tpufem_torch.sparse.stencil import StencilMatrix

__all__ = ["apply_dirichlet_stencil", "constrained_operator",
           "constrain_rhs"]


def _bc_arrays(b, bc_mask, bc_values):
    """(bool mask, g zero off the boundary) on b's device, in b's type."""
    mask = torch.as_tensor(bc_mask, dtype=torch.bool, device=b.device)
    if bc_values is None:
        g = torch.zeros_like(b)
    else:
        g = torch.as_tensor(bc_values, dtype=b.dtype,
                            device=b.device).broadcast_to(b.shape)
    return mask, torch.where(mask, g, 0.0)


def apply_dirichlet_stencil(A: StencilMatrix, b, bc_mask, bc_values=None):
    """Symmetric Dirichlet elimination on a StencilMatrix system.  Returns
    (A, b); the given A is not modified."""
    mask, g = _bc_arrays(b, bc_mask, bc_values)
    b = b - A.matvec(g)
    b = torch.where(mask, g, b)

    n = A.data.shape[1]
    halo = max(abs(o) for o in A.offsets) if A.offsets else 0
    mask_p = torch.nn.functional.pad(mask, (halo, halo))
    rows_keep = ~mask
    new_diags = []
    for k, off in enumerate(A.offsets):
        col_bc = mask_p[halo + off: halo + off + n]
        d = torch.where(rows_keep & ~col_bc, A.data[k], 0.0)
        if off == 0:
            d = torch.where(mask, 1.0, d)
        new_diags.append(d)
    return StencilMatrix(torch.stack(new_diags), A.offsets), b


def constrain_rhs(matvec, b, bc_mask, bc_values=None):
    """RHS for the matrix-free constrained system.  Returns (b_mod, g)."""
    mask, g = _bc_arrays(b, bc_mask, bc_values)
    b = b - matvec(g)
    b = torch.where(mask, g, b)
    return b, g


def constrained_operator(matvec, bc_mask):
    """Wrap a matvec so constrained DOFs act as identity rows/cols.

    y = P A P x + (I - P) x with P = diag(~mask): symmetric, and equal to
    the eliminated matrix when x[bc] carries the BC values.
    """
    mask = torch.as_tensor(bc_mask, dtype=torch.bool)

    def constrained(x):
        nonlocal mask
        if mask.device != x.device:
            mask = mask.to(x.device)     # moved once, on the first call
        y = matvec(torch.where(mask, 0.0, x))
        return torch.where(mask, x, y)

    return constrained
