"""Preconditioners: Jacobi, block-Jacobi and Chebyshev-Jacobi, as in
tpufem.solve.precond.

Block-Jacobi pairs with the BCSR vector-element format: the inverses of the
per-node b x b diagonal blocks, applied as a batched small product.

Chebyshev-Jacobi is the mesh-size-robust choice for unstructured systems,
where geometric multigrid's nested grids do not exist: a fixed degree-m
polynomial in D^-1 A per PCG iteration, m SpMVs (the banded kernel) traded
against about m-fold fewer CG iterations.
"""
from __future__ import annotations

import torch

from tpufem_torch.sparse.ell import ELLMatrix

__all__ = ["jacobi", "jacobi_from_diagonal", "block_jacobi", "chebyshev",
           "estimate_lambda_max", "lambda_max_bound"]


def _inverse(diag: torch.Tensor) -> torch.Tensor:
    """1 / diag, with 1 where the diagonal is 0."""
    return torch.where(diag != 0, 1.0 / diag, 1.0)


def jacobi_from_diagonal(diag: torch.Tensor):
    """Preconditioner r -> r / diag (guarding zero diagonal entries)."""
    inv = _inverse(diag)

    def apply(r):
        return r * inv

    return apply


def jacobi(A: ELLMatrix):
    """Jacobi preconditioner extracted from an ELL matrix."""
    return jacobi_from_diagonal(A.diagonal())


def block_jacobi(diag_blocks: torch.Tensor, *,
                 component_major: bool = False):
    """Block-Jacobi from [n_blocks, b, b] diagonal blocks (the 2x2 / 3x3
    per-node blocks of a vector-elasticity BCSR matrix): a batched inverse
    once, then r -> blockwise inv_blocks @ r.  ``r`` is node-major (any
    shape holding n_blocks * b values), or with ``component_major`` a
    [b, n_blocks] block (the banded elasticity solve's layout)."""
    inv_blocks = torch.linalg.inv(diag_blocks)   # [nb, b, b]
    bsize = diag_blocks.shape[-1]

    if component_major:
        inv_cm = inv_blocks.permute(1, 2, 0).contiguous()   # [b, b, nb]

        def apply_cm(r):
            return (inv_cm * r[None]).sum(1)

        return apply_cm

    def apply(r):
        rb = r.reshape(-1, bsize)
        out = (inv_blocks * rb[:, None, :]).sum(2)
        return out.reshape(r.shape)

    return apply


def estimate_lambda_max(matvec, diag: torch.Tensor, n: int, *,
                        iters: int = 25, seed: int = 0,
                        dtype=torch.float32, boost: float = 1.05) -> float:
    """Largest eigenvalue of D^-1 A by power iteration, times ``boost``.

    The start vector is drawn from a ``torch.Generator`` seeded with
    ``seed`` (on the CPU, then moved to diag's device), so its bits are
    not JAX's PRNG bits.  Power iteration can sit well below lmax on large
    meshes; for an ELL matrix prefer :func:`lambda_max_bound`.
    """
    inv_d = _inverse(diag).to(dtype)
    gen = torch.Generator().manual_seed(int(seed))
    v = torch.randn(n, generator=gen, dtype=dtype).to(diag.device)
    lam = torch.zeros((), dtype=dtype, device=diag.device)
    for _ in range(int(iters)):
        w = inv_d * matvec(v)
        lam = torch.dot(v, w) / torch.dot(v, v)
        v = w / torch.linalg.vector_norm(w)
    return float(lam) * boost


def lambda_max_bound(A: ELLMatrix) -> float:
    """Guaranteed upper bound on spec(D^-1 A) by Gershgorin row sums:
    ``max_i sum_j |a_ij| / d_i`` (padding slots hold 0)."""
    inv_d = _inverse(A.diagonal())
    return float(torch.max(torch.sum(torch.abs(A.data), dim=1) * inv_d))


def chebyshev(matvec, diag: torch.Tensor, *, degree: int = 10, lmax: float,
              lmin_ratio: float = 30.0):
    """Chebyshev-Jacobi polynomial preconditioner r -> p_m(D^-1 A) D^-1 r.

    ``degree`` steps of the preconditioned Chebyshev iteration for A z = r
    from z = 0 (Saad, Alg. 12.1) on [lmax / lmin_ratio, lmax]; linear in r
    with fixed coefficients and SPD, so a valid CG preconditioner.  ``lmax``
    must bound spec(D^-1 A) from above (:func:`lambda_max_bound`).  Takes
    r [n], or [n, q] with a multi-RHS ``matvec`` (ELLMatrix.matvec_multi).
    """
    lmax = float(lmax)
    lmin = lmax / float(lmin_ratio)
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta
    inv_d = _inverse(diag)
    m = int(degree)
    rhos = []
    rho = 1.0 / sigma1
    for _ in range(m):
        rhos.append(rho)
        rho = 1.0 / (2.0 * sigma1 - rho)

    def apply(r0):
        idv = inv_d if r0.dim() == 1 else inv_d[:, None]
        d = (idv * r0) / theta
        z = d
        r = r0
        for k in range(1, m):
            r = r - matvec(d)          # r_k (the final r_m is never needed)
            d = rhos[k] * rhos[k - 1] * d + (2.0 * rhos[k] / delta) * (
                idv * r)
            z = z + d
        return z

    return apply
