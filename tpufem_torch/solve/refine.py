"""Mixed-precision iterative refinement, as in tpufem.solve.refine:

    repeat:  r = b - A x          (fp64)
             solve A d ~= r       (fp32 MG-PCG)
             x <- x + d           (fp64 accumulate)

Each outer step multiplies the residual by the inner solve's reduction
factor, so two or three outer steps reach 1e-8.  The fp64 residual matvec
is the stencil kernel K2 built for double (Hopper has fp64; Mosaic had
none).  The outer loop reads the residual norm back once per outer step.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["RefinedResult", "iterative_refinement", "refined_stencil_solve"]


class RefinedResult(NamedTuple):
    x: torch.Tensor              # fp64 iterate
    residual_norm: float         # fp64 ||b - A x|| / ||b||
    outer_iterations: int
    converged: bool


def iterative_refinement(matvec_hi: Callable, inner_solve: Callable,
                         b: torch.Tensor, *, tol: float = 1e-8,
                         max_outer: int = 8) -> RefinedResult:
    """Solve A x = b to ``tol`` relative fp64 residual.

    matvec_hi:   x64 -> A x in fp64.
    inner_solve: r32 -> approximate A^-1 r32 in fp32.

    The residual is rescaled to O(1) before each inner solve so fp32 never
    under/overflows as r shrinks toward 1e-16 * ||b||.
    """
    b = b.to(torch.float64)
    bnorm = torch.linalg.vector_norm(b)
    safe = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))
    x = torch.zeros_like(b)
    r = b
    rn = float((bnorm / safe).item())
    k = 0
    while rn > tol and k < max_outer:
        s = r.abs().max()
        s = torch.where(s > 0, s, torch.ones_like(s))
        d32 = inner_solve((r / s).to(torch.float32))
        x = x + s * d32.to(torch.float64)
        r = b - matvec_hi(x)
        rn = float((torch.linalg.vector_norm(r) / safe).item())
        k += 1
    return RefinedResult(x=x, residual_norm=rn, outer_iterations=k,
                         converged=rn <= tol)


def refined_stencil_solve(data32, data64, offsets, b, precond, *,
                          tol: float = 1e-8, inner_iters: int = 10,
                          max_outer: int = 8,
                          matvec32: Callable | None = None,
                          matvec_dot32: Callable | None = None,
                          M_dot: Callable | None = None) -> RefinedResult:
    """Refinement of an embedded stencil system.

    data32/data64: stencil values [K, NS] in fp32 (inner) / fp64 (residual).
    precond:       fp32 preconditioner (e.g. the MG V-cycle).
    matvec32 / matvec_dot32 / M_dot: optional inner-solve hooks (see
    solve.cg); the default inner matvec is the stencil kernel in fp32.
    """
    from tpufem_torch.ops.stencil_cuda import stencil_apply
    from tpufem_torch.solve.cg import cg_fixed

    offsets = tuple(int(o) for o in offsets)
    if matvec32 is None:
        matvec32 = lambda v: stencil_apply(data32, v, offsets)

    def matvec_hi(v):
        return stencil_apply(data64, v, offsets)

    def inner(r32):
        x, _ = cg_fixed(matvec32, r32, inner_iters, M=precond,
                        matvec_dot=matvec_dot32, M_dot=M_dot)
        return x

    return iterative_refinement(matvec_hi, inner, b, tol=tol,
                                max_outer=max_outer)
