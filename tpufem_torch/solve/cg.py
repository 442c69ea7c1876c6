"""(Preconditioned) conjugate gradients, as in tpufem.solve.cg.

``lax.while_loop`` / ``fori_loop`` become Python loops.  The scalars of the
recurrence (alpha, beta, the guards) stay 0-d tensors on the vectors'
device, so an iteration never waits for the device: ``cg`` reads one flag
back per ``check_every`` block, ``cg_fixed`` none at all.

``matvec_dot`` / ``M_dot`` are the fused hooks: ``p -> (A p, <p, A p>)``
(the stencil kernel's dot) and ``r -> (M^-1 r, <r, M^-1 r>)`` (the V-cycle's
final pass).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

__all__ = ["CGResult", "cg", "cg_fixed"]


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_norm: torch.Tensor   # final ||r|| / ||b|| (0-d)
    converged: bool
    diverged: bool                # NaN/Inf or breakdown detected


def _hooks(matvec, M, matvec_dot, M_dot):
    if M is None:
        M = lambda r: r
    if matvec_dot is None:
        def matvec_dot(p):
            Ap = matvec(p)
            return Ap, torch.dot(p, Ap)
    if M_dot is None:
        def M_dot(r):
            z = M(r)
            return z, torch.dot(r, z)
    return matvec_dot, M_dot


def _safe_div(num, den):
    """num / den, or 0 where den == 0 (0-d tensors, no host sync)."""
    return torch.where(den != 0, num / den, 0.0)


def cg(matvec: Callable, b: torch.Tensor, x0=None, *, tol: float = 1e-8,
       maxiter: int = 1000, M: Optional[Callable] = None,
       check_every: int = 1, matvec_dot: Optional[Callable] = None,
       M_dot: Optional[Callable] = None) -> CGResult:
    """Solve A x = b with (preconditioned) CG to ||r|| <= tol ||b||.

    ``check_every``: iterations per convergence check (one host sync per
    block).  Steps past convergence are inert: the divisions are guarded so
    alpha, beta -> 0 freeze the recurrence instead of producing 0/0, and
    ``iterations`` reports the executed count (a multiple of the block).
    """
    matvec_dot, M_dot = _hooks(matvec, M, matvec_dot, M_dot)
    check_every = max(1, int(check_every))

    x = torch.zeros_like(b) if x0 is None else x0
    b_norm = torch.linalg.vector_norm(b)
    safe_b_norm = torch.where(b_norm > 0, b_norm, torch.ones_like(b_norm))
    atol = tol * safe_b_norm

    r = b - matvec(x)
    z, rz = M_dot(r)
    p = z
    bad = torch.zeros((), dtype=torch.bool, device=b.device)
    k = 0

    def step(x, r, p, rz, bad):
        Ap, pAp = matvec_dot(p)
        alpha = rz / pAp
        x = x + alpha * p
        r = r - alpha * Ap
        z, rz_new = M_dot(r)
        p = z + (rz_new / rz) * p
        bad = ~torch.isfinite(rz_new) | ~torch.isfinite(pAp) | (pAp <= 0)
        return x, r, p, rz_new, bad

    def step_safe(x, r, p, rz, bad):
        Ap, pAp = matvec_dot(p)
        alpha = torch.where(pAp > 0, rz / pAp, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z, rz_new = M_dot(r)
        p = z + torch.where(rz > 0, rz_new / rz, 0.0) * p
        # pAp == 0 with rz > 0 is the singular-system breakdown (with
        # r = 0 exactly, rz = 0 and the stall is just convergence)
        bad = (bad | ~torch.isfinite(rz_new) | ~torch.isfinite(pAp)
               | (pAp < 0) | ((pAp == 0) & (rz > 0)))
        return x, r, p, rz_new, bad

    body = step if check_every == 1 else step_safe
    while bool(((torch.linalg.vector_norm(r) > atol) & ~bad).item()) \
            and k < maxiter:
        for _ in range(check_every):
            x, r, p, rz, bad = body(x, r, p, rz, bad)
        k += check_every

    rnorm = torch.linalg.vector_norm(r) / safe_b_norm
    bad_h = bool(bad.item())
    return CGResult(x=x, iterations=k, residual_norm=rnorm,
                    converged=bool((rnorm <= tol).item()) and not bad_h,
                    diverged=bad_h)


def cg_fixed(matvec: Callable, b: torch.Tensor, iters: int, *,
             M: Optional[Callable] = None, x0=None,
             matvec_dot: Optional[Callable] = None,
             M_dot: Optional[Callable] = None):
    """Fixed-iteration PCG with no convergence checks and no host sync.

    Early exact convergence is safe: alpha and beta are guarded to 0 where
    their denominators vanish, so the iterate freezes.

    Returns ``(x, r)``: the iterate and its (unpreconditioned) residual.
    """
    matvec_dot, M_dot = _hooks(matvec, M, matvec_dot, M_dot)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z, rz = M_dot(r)
    p = z
    for _ in range(int(iters)):
        Ap, pAp = matvec_dot(p)
        alpha = _safe_div(rz, pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z, rz_new = M_dot(r)
        p = z + _safe_div(rz_new, rz) * p
        rz = rz_new
    return x, r
