"""(Preconditioned) MINRES, as in tpufem.solve.minres.

CG (solve/cg.py) requires a positive-definite operator; saddle-point
systems such as Stokes [[A, B^T], [B, 0]] (solve/stokes.py) are symmetric
but indefinite.  MINRES minimizes the residual over the same Krylov space
with the Lanczos three-term recurrence and a Givens QR, one matvec and one
preconditioner application per iteration.  The preconditioner must be
symmetric positive definite (it defines the Lanczos inner product).

``lax.while_loop`` / ``fori_loop`` become Python loops.  The recurrence's
scalars stay 0-d tensors on the vectors' device: one flag is read back per
``check_every`` block of steps, never one per step (cg.py's convention).
The steps are the reference's term for term, guards included, so the
returned ``iterations`` is the reference's count: a multiple of
``check_every`` unless ``maxiter`` or a breakdown stops the run first at a
batch boundary, and up to ``check_every - 1`` past ``maxiter``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

__all__ = ["MinresResult", "minres"]


class MinresResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_norm: torch.Tensor   # final ||r||_{M^-1} / ||b||_{M^-1} (0-d)
    converged: bool
    diverged: bool                # NaN/Inf or Lanczos breakdown


def _vdot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _positive_or_one(t):
    return torch.where(t > 0, t, torch.ones_like(t))


def minres(matvec: Callable, b, x0=None, *, tol: float = 1e-8,
           maxiter: int = 1000, M: Optional[Callable] = None,
           check_every: int = 1) -> MinresResult:
    """Solve A x = b, A symmetric (possibly indefinite), with MINRES.

    matvec: x -> A x (A symmetric; definiteness NOT required).
    M:      optional SPD preconditioner application r -> M^-1 r.
    tol:    relative tolerance on the preconditioned residual norm
            (phibar / beta1, the quantity the recurrence minimizes).

    ``check_every`` batches k Lanczos steps per convergence check (one
    host read per batch).  Within a batch a step whose state is already
    flagged bad returns its input unchanged, so the last finite iterate is
    kept; convergence freezes nothing (the guarded gamma keeps a converged
    recurrence still).
    """
    if M is None:
        M = lambda r: r
    check_every = max(1, int(check_every))

    x0 = torch.zeros_like(b) if x0 is None else x0
    r1 = b - matvec(x0)
    y = M(r1)
    beta1_sq = _vdot(r1, y)
    # beta1 <= 0 with r1 != 0 means M is not SPD; flagged via `bad` below
    beta1 = torch.sqrt(torch.clamp(beta1_sq, min=0))
    safe_beta1 = _positive_or_one(beta1)
    eps = torch.finfo(b.dtype).eps

    def step(state):
        (x, r1_, r2, y_, w, w2, oldb, beta, dbar, epsln, phibar,
         cs, sn, k, bad) = state
        v = y_ / _positive_or_one(beta)
        Av = matvec(v)
        # three-term Lanczos: subtract projections on the two previous
        # M^-1-orthogonal directions
        Av = Av - torch.where(k > 0, beta / _positive_or_one(oldb),
                              torch.zeros_like(beta)) * r1_
        alfa = _vdot(v, Av)
        Av = Av - (alfa / _positive_or_one(beta)) * r2
        r1n = r2
        r2n = Av
        yn = M(r2n)
        oldbn = beta
        beta_sq = _vdot(r2n, yn)
        betan = torch.sqrt(torch.clamp(beta_sq, min=0))
        # previous Givens rotation applied to the new tridiagonal column
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln_n = sn * betan
        dbar_n = -cs * betan
        # current rotation
        gamma = torch.sqrt(gbar * gbar + betan * betan)
        gamma = torch.clamp(gamma, min=eps)
        cs_n = gbar / gamma
        sn_n = betan / gamma
        phi = cs_n * phibar
        phibar_n = sn_n * phibar
        # solution update directions
        w1 = w2
        w2n = w
        wn = (v - oldeps * w1 - delta * w2n) / gamma
        bad_n = (bad | ~torch.isfinite(beta_sq) | (beta_sq < 0)
                 | ~torch.isfinite(alfa))
        # keep the last finite iterate: the step that trips `bad` must not
        # pollute x (phi / wn may already be NaN here)
        xn = torch.where(bad_n, x, x + phi * wn)
        return (xn, r1n, r2n, yn, wn, w2n, oldbn, betan, dbar_n,
                epsln_n, phibar_n, cs_n, sn_n, k + 1, bad_n)

    def step_safe(state):
        # a state already flagged bad passes through unchanged (all 15
        # entries, the step count included)
        new = step(state)
        bad = state[14]
        return tuple(torch.where(bad, o, n) for o, n in zip(state, new))

    zero = torch.zeros_like(b)
    s0 = torch.zeros((), dtype=b.dtype, device=b.device)
    k0 = torch.zeros((), dtype=torch.int32, device=b.device)
    state = (x0, r1, r1, y, zero, zero, s0, beta1, s0, s0, beta1,
             -torch.ones_like(s0), s0, k0,
             ~torch.isfinite(beta1_sq) | (beta1_sq < 0))
    body = step if check_every == 1 else step_safe
    tol_abs = tol * safe_beta1
    while True:
        phibar, k, bad = state[10], state[13], state[14]
        go = (phibar > tol_abs) & (k < maxiter) & ~bad
        if not bool(go.item()):
            break
        for _ in range(check_every):
            state = body(state)

    x, phibar, k, bad = state[0], state[10], state[13], state[14]
    relres = phibar / safe_beta1
    bad_h = bool(bad.item())
    return MinresResult(x=x, iterations=int(k.item()), residual_norm=relres,
                        converged=bool((relres <= tol).item()) and not bad_h,
                        diverged=bad_h)
