"""Matrix-free Newton-Krylov for nonlinear FEM systems, as in
tpufem.solve.newton.

The user supplies the assembled nonlinear residual ``R(u)``; the Jacobian-
vector product the inner CG needs is the forward-mode derivative of that
residual, exact to rounding, with no assembled Jacobian.  One Newton step
solves

    J(u) s = -R(u),       J(u) v = d/de R(u + e v) at e = 0,

with the guarded CG of ``solve.cg`` (J symmetric positive definite for
gradient-flow problems such as semilinear diffusion with a monotone
nonlinearity).

``J v`` evaluates the residual on the dual number ``u + e v``
(``torch.autograd.forward_ad``) and takes its tangent, so every inner
iteration pays the primal residual again beside the tangent.  The reference
linearizes once per Newton step (``jax.linearize``); tracing the residual
(``torch.func``, ``make_fx``) cannot see the ELL kernels, which launch
through ctypes, and would bake their outputs in as constants.  The kernels'
products carry their own forward-mode rule (``sparse.ell._Linear``), and the
scatter of ``assemble.dense.assemble_vector`` is differentiable.

The outer loops are Python loops: one host check per Newton step and one
per halving of the line search.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.autograd.forward_ad as fwad

from tpufem_torch.solve.cg import cg

__all__ = ["NewtonResult", "newton_krylov"]


class NewtonResult(NamedTuple):
    x: torch.Tensor
    iterations: int              # outer Newton steps taken
    residual_norm: torch.Tensor  # final ||R(x)|| / ||R(x0)|| (0-d)
    converged: bool
    inner_iterations: int        # total CG iterations across all steps


def _tangent_map(residual: Callable, x: torch.Tensor) -> Callable:
    """v -> J(x) v: the tangent of ``residual`` at the dual x + e v."""
    def jmv(v):
        with fwad.dual_level():
            out = fwad.unpack_dual(residual(fwad.make_dual(x, v)))
        return (out.tangent if out.tangent is not None
                else torch.zeros_like(out.primal))

    return jmv


def newton_krylov(residual: Callable, x0, *, tol: float = 1e-8,
                  maxiter: int = 30, inner_maxiter: int = 500,
                  M: Optional[Callable] = None,
                  forcing_max: float = 0.1, forcing_min: float = 1e-6,
                  damping: float = 1.0) -> NewtonResult:
    """Solve R(x) = 0 by inexact Newton with matrix-free CG inner solves.

    residual:  x -> R(x), the assembled + BC-applied nonlinear residual
               (constrained DOFs should carry R = x - g), built of
               operations forward-mode AD can carry.
    M:         optional inner-CG preconditioner (it changes inner
               iteration counts, never the Newton trajectory's limit).
    tol:       relative tolerance on ||R|| vs the initial residual.
    damping:   the line search's first step length (1.0 = full Newton).

    The inner tolerance follows Eisenstat-Walker choice 2,
    0.9 (||R_k|| / ||R_{k-1}||)^2 clipped to [forcing_min, forcing_max];
    the step is halved (at most 40 times) until ||R|| drops by the Armijo
    factor 1 - 1e-4 lam.  Stops at ``tol * ||R(x0)||``, ``maxiter`` steps
    or a non-finite norm.
    """
    x = torch.as_tensor(x0)
    norm = torch.linalg.vector_norm
    r = residual(x)
    n0 = norm(r)
    safe_n0 = torch.where(n0 > 0, n0, torch.ones_like(n0))
    rn, prev = n0, torch.zeros_like(n0)
    k = inner = 0
    while k < maxiter and bool(((rn > tol * safe_n0)
                                & torch.isfinite(rn)).item()):
        eta = torch.where(prev > 0, 0.9 * (rn / prev) ** 2,
                          torch.full_like(rn, forcing_max))
        eta = eta.clamp(forcing_min, forcing_max)
        res = cg(_tangent_map(residual, x), -r, tol=eta,
                 maxiter=inner_maxiter, M=M, check_every=4)
        s = res.x

        # Armijo backtracking on ||R||: far from the solution a full step
        # can overshoot badly; near it lam = 1 is taken at once
        # (the accepted trial's residual is the next step's R(x))
        lam = torch.tensor(damping, dtype=x.dtype, device=x.device)
        x_try = x + lam * s
        r_try = residual(x_try)
        rn_try = norm(r_try)
        halvings = 0
        while halvings < 40 and bool((~torch.isfinite(rn_try) | (
                rn_try > (1.0 - 1e-4 * lam) * rn)).item()):
            lam = 0.5 * lam
            x_try = x + lam * s
            r_try = residual(x_try)
            rn_try = norm(r_try)
            halvings += 1
        x, r = x_try, r_try
        k, rn, prev = k + 1, rn_try, rn
        inner += res.iterations
    return NewtonResult(x=x, iterations=k, residual_norm=rn / safe_n0,
                        converged=bool((rn <= tol * safe_n0).item()),
                        inner_iterations=inner)
