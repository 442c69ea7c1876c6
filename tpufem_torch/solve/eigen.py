"""Modal analysis: smallest eigenpairs of FEM operators, as in
tpufem.solve.eigen.

The k smallest generalized eigenpairs of

    A u = lambda M_L u        (A SPD stiffness, M_L lumped mass)

by block inverse subspace iteration with Rayleigh-Ritz: each outer step
solves A Y = M_L X column-wise with fixed-iteration preconditioned CG
(``cg_fixed``, or the lockstep ``cg_fixed_block`` over a multi-column
product such as ``ELLMatrix.matvec_multi``, B10 on the card), then rotates
the block onto the Ritz vectors of the small projected pencil.

Mixed precision (``matvec_hi_multi``, an fp64 product such as the
absolute-column B10 on fp64 values): the subspace, the Gram matrices and
the residuals live in fp64; each inverse application is ``refine_steps``
rounds of iterative refinement whose inner solves run in fp32, each column
rescaled to O(1) first.  The q x q Cholesky and ``eigh`` then run in fp32,
as the reference's do (their entries are O(lambda), no cancellation).

The reference's ``fori_loop`` over the outer steps is a Python loop; no
step reads back to the host.  Its ``jax.vmap`` of ``M`` over columns (the
default ``M_multi``) is ``M`` applied column by column and stacked: a
kernel launched through ctypes cannot be mapped.  The random start comes
from a ``torch.Generator`` seeded with ``seed`` (not the reference's
``jax.random`` stream).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from tpufem_torch.solve.cg import cg_fixed, cg_fixed_block

__all__ = ["EigenResult", "smallest_eigenpairs", "subspace_stepper"]


class EigenResult(NamedTuple):
    eigenvalues: torch.Tensor     # [k] ascending
    eigenvectors: torch.Tensor    # [n, k] M_L-orthonormal
    iterations: int               # outer subspace iterations run
    residual_norms: torch.Tensor  # [k] ||A u - lam M_L u|| / ||A u||


def smallest_eigenpairs(matvec: Callable, n: int, k: int, *,
                        lumped_mass=None, M: Optional[Callable] = None,
                        bc_mask=None, inner_iters: int = 40,
                        outer_iters: int = 30, buffer: int = 3,
                        dtype=torch.float64, seed: int = 0,
                        matvec_multi: Optional[Callable] = None,
                        M_multi: Optional[Callable] = None,
                        matvec_hi_multi: Optional[Callable] = None,
                        refine_steps: int = 3,
                        device="cuda") -> EigenResult:
    """k smallest eigenpairs of ``A u = lambda M_L u``.

    matvec:      x -> A x (SPD; BC rows identity-like).
    lumped_mass: [n] lumped mass diagonal (None = standard problem).
    M:           inner-CG preconditioner (AMG / Jacobi) for the A-solves.
    bc_mask:     constrained DOFs, projected out of the iteration.
    inner_iters: CG iterations per inverse application.
    buffer:      extra subspace vectors; eigenpair j contracts per outer
                 step like lambda_j / lambda_{k+buffer+1}.
    matvec_multi: optional X [n, q] -> A X; the q = k + buffer inner
                 solves then run as lockstep chains (``cg_fixed_block``),
                 preconditioned by ``M_multi`` (default: ``M`` column by
                 column).  Without it the solves run column by column.
    matvec_hi_multi: optional fp64 X [n, q] -> A X: mixed precision (see
                 the module docstring), ``refine_steps`` rounds per solve.
    device:      where the subspace lives (the card unless the caller
                 asks for the CPU).

    Exactly ``finish(step^outer_iters(X0))`` of :func:`subspace_stepper`.
    """
    X0, step, finish = subspace_stepper(
        matvec, n, k, lumped_mass=lumped_mass, M=M, bc_mask=bc_mask,
        inner_iters=inner_iters, outer_iters=outer_iters, buffer=buffer,
        dtype=dtype, seed=seed, matvec_multi=matvec_multi,
        M_multi=M_multi, matvec_hi_multi=matvec_hi_multi,
        refine_steps=refine_steps, device=device)
    X = X0
    for _ in range(int(outer_iters)):
        X = step(X)
    return finish(X)


def subspace_stepper(matvec: Callable, n: int, k: int, *,
                     lumped_mass=None, M: Optional[Callable] = None,
                     bc_mask=None, inner_iters: int = 40,
                     outer_iters: int = 30, buffer: int = 3,
                     dtype=torch.float64, seed: int = 0,
                     matvec_multi: Optional[Callable] = None,
                     M_multi: Optional[Callable] = None,
                     matvec_hi_multi: Optional[Callable] = None,
                     refine_steps: int = 3, device="cuda"):
    """The subspace iteration as an ``(X0, step, finish)`` triple, with the
    parameters and math of :func:`smallest_eigenpairs`; the caller runs
    the outer loop (``outer_iters`` only stamps ``EigenResult.iterations``).
    """
    q = k + buffer
    mixed = matvec_hi_multi is not None
    work = torch.float64 if mixed else dtype
    dec = torch.float32 if mixed else dtype     # q x q decompositions
    mL = (torch.ones(n, dtype=work, device=device) if lumped_mass is None
          else torch.as_tensor(lumped_mass, dtype=work, device=device))
    if bc_mask is not None:
        bcm = torch.as_tensor(bc_mask, device=device).bool()[:, None]
        projB = lambda V: torch.where(bcm, 0.0, V)
    else:
        projB = lambda V: V

    def columns(f, X):
        return torch.stack([f(X[:, j].contiguous())
                            for j in range(X.shape[1])], dim=1)

    if matvec_multi is not None:
        amv_block = matvec_multi
        Mm = M_multi
        if Mm is None and M is not None:
            Mm = lambda R: columns(M, R)

        def ainv_block(X):
            return cg_fixed_block(matvec_multi, X, inner_iters,
                                  M_multi=Mm)[0]
    else:
        def amv_block(X):
            return columns(matvec, X)

        def ainv_block(X):
            return columns(lambda b: cg_fixed(matvec, b, inner_iters,
                                              M=M)[0], X)

    if mixed:
        amv_work = matvec_hi_multi

        def ainv_work(B):
            """A^-1 B by iterative refinement: fp32 inner solves, fp64
            residuals and accumulation; each column rescaled to O(1)
            before the fp32 solve."""
            def solve32(R):
                s = R.abs().amax(dim=0)
                s = torch.where(s > 0, s, 1.0)
                D = ainv_block((R / s).to(torch.float32))
                return s * D.to(work)

            Y = solve32(B)
            for _ in range(refine_steps - 1):
                Y = Y + solve32(B - matvec_hi_multi(Y))
            return Y
    else:
        amv_work, ainv_work = amv_block, ainv_block

    eye = torch.eye(q, dtype=dec, device=device)

    def ritz(Y):
        """Rayleigh-Ritz on span(Y) for the pencil (A, diag(mL)): Gram
        matrices in the working dtype, the decompositions in ``dec``."""
        AY = amv_work(Y)
        Ah = (Y.T @ AY).to(dec)
        Mh = (Y.T @ (mL[:, None] * Y)).to(dec)
        eps = torch.finfo(dec).eps
        L = torch.linalg.cholesky(0.5 * (Mh + Mh.T)
                                  + 100.0 * eps * torch.trace(Mh) * eye)
        Li = torch.linalg.solve_triangular(L, eye, upper=False)
        w, V = torch.linalg.eigh(Li @ (0.5 * (Ah + Ah.T)) @ Li.T)
        return w.to(work), Y @ (Li.T @ V).to(work)

    gen = torch.Generator(device=device).manual_seed(seed)
    X0 = projB(torch.randn((n, q), generator=gen, dtype=work,
                           device=device))

    def step(X):
        Y = projB(ainv_work(mL[:, None] * X))
        return ritz(Y)[1]

    def finish(X):
        lam, U = ritz(X)
        lam, U = lam[:k], U[:, :k].contiguous()
        AU = amv_work(U)
        num = torch.linalg.vector_norm(AU - lam * mL[:, None] * U, dim=0)
        den = torch.linalg.vector_norm(AU, dim=0).clamp_min(
            torch.finfo(AU.dtype).tiny)
        return EigenResult(eigenvalues=lam, eigenvectors=U,
                           iterations=outer_iters, residual_norms=num / den)

    return X0, step, finish
