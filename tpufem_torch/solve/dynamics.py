"""Explicit structural dynamics: leapfrog (central-difference) stepping, as
in tpufem.solve.dynamics.

With a lumped mass matrix the explicit update has no linear solve: each
step is one SpMV (B9 for an ``ELLMatrix`` on the card) plus elementwise
updates.  The reference's ``lax.scan`` becomes a Python loop that never
reads back to the host: the energy trace stays on the device and is
stacked at the end.

Central differences conserve a discrete energy exactly in exact arithmetic
(undamped linear problem, time-independent BCs):

    E_{n+1/2} = 1/2 v_{n+1/2}^T M v_{n+1/2} + 1/2 u_n^T K u_{n+1}

with v_{n+1/2} = (u_{n+1} - u_n)/dt; ``leapfrog_wave`` returns this trace.
Stability: dt < 2/sqrt(lambda_max(M^-1 K)); ``stable_dt`` estimates the
bound by power iteration.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

__all__ = ["lumped_mass", "stable_dt", "leapfrog_wave", "WaveResult"]


def lumped_mass(space, dtype=torch.float64, *, device="cuda"):
    """Row-sum lumped mass vector [num_dofs] for any cell family, through
    the weak form's mass kernel (per-point |det J| on quads and hexes);
    it preserves total mass (sum = domain volume).  Evaluated on
    ``device`` (the card unless the caller asks for the CPU)."""
    from tpufem_torch.assemble.dense import assemble_vector
    from tpufem_torch.forms.weakform import WeakForm

    wf = WeakForm(space, dtype=dtype, device=device).build(
        lambda u, v: u * v)
    ecoords = torch.as_tensor(space.mesh.element_coords(), dtype=dtype,
                              device=device)
    Me = wf.element_matrices(ecoords)               # [NE, nd, nd]
    return assemble_vector(space.dof_conn, Me.sum(dim=2), space.num_dofs)


def stable_dt(matvec_K: Callable, m_lumped, *, iters: int = 50,
              safety: float = 0.9, seed: int = 0) -> float:
    """Safe explicit step: safety * 2 / sqrt(lambda_max(M_L^-1 K)).

    Power iteration on the symmetrized generalized problem from a start
    drawn by a ``torch.Generator`` seeded with ``seed`` on m_lumped's
    device (the reference's ``jax.random`` stream is not reproduced);
    power iteration approaches lambda_max from below, so keep safety < 1.
    One host read, at the end.
    """
    m = m_lumped
    inv_sqrt_m = 1.0 / torch.sqrt(m)
    gen = torch.Generator(device=m.device).manual_seed(seed)
    x = torch.randn(m.shape[0], generator=gen, dtype=m.dtype,
                    device=m.device)
    x = x / torch.linalg.vector_norm(x)
    lam = None
    for _ in range(int(iters)):
        y = inv_sqrt_m * matvec_K(inv_sqrt_m * x)
        lam = torch.dot(x, y) / torch.dot(x, x)
        x = y / torch.linalg.vector_norm(y)
    return float(safety * 2.0 / float(lam) ** 0.5)


class WaveResult(NamedTuple):
    u: torch.Tensor        # displacement at t = steps*dt
    v: torch.Tensor        # midpoint velocity (u_N - u_{N-1})/dt
    energy: torch.Tensor   # [steps-1] discrete energy trace E_{n+1/2}


def leapfrog_wave(matvec_K: Callable, m_lumped, u0, v0, dt: float,
                  steps: int, *, bc_mask=None,
                  forcing: Optional[Callable] = None) -> WaveResult:
    """Integrate M u'' + K u = f with central differences.

    ``matvec_K``: the stiffness operator (``ELLMatrix.matvec``, a stencil
    operator, or any matrix-free callable).  ``m_lumped``: lumped mass
    vector (its dtype and device are the run's).  ``bc_mask``: True at
    homogeneous-Dirichlet DOFs (kept at zero).  ``forcing``: optional
    ``f(t) -> [n]`` load vector, t = n dt as a Python float.

    A Taylor start-up (u_1 = u_0 + dt v_0 + dt^2/2 a_0) keeps the scheme
    second order; K u_n rides the loop, so a step costs one product (plus
    one for K u_0 and one for K u_1).  No host sync.
    """
    m = m_lumped
    dtype, device = m.dtype, m.device
    u0 = torch.as_tensor(u0, dtype=dtype, device=device)
    v0 = torch.as_tensor(v0, dtype=dtype, device=device)
    inv_m = 1.0 / m
    mask = None
    if bc_mask is not None:
        mask = torch.as_tensor(bc_mask, device=device).bool()
        u0 = torch.where(mask, 0.0, u0)
        v0 = torch.where(mask, 0.0, v0)

    def accel_from(Ku, t):
        f = forcing(t) if forcing is not None else 0.0
        a = inv_m * (f - Ku)
        return a if mask is None else torch.where(mask, 0.0, a)

    u1 = u0 + dt * v0 + 0.5 * dt * dt * accel_from(matvec_K(u0), 0.0)
    if mask is not None:
        u1 = torch.where(mask, 0.0, u1)

    # K u_{n+1} of the energy trace is the next step's stiffness term
    u_prev, u, Ku = u0, u1, matvec_K(u1)
    energy = []
    for n in range(1, int(steps)):
        u_next = 2.0 * u - u_prev + dt * dt * accel_from(Ku, n * dt)
        if mask is not None:
            u_next = torch.where(mask, 0.0, u_next)
        Ku_next = matvec_K(u_next)
        v_half = (u_next - u) / dt
        energy.append(0.5 * torch.dot(v_half, m * v_half)
                      + 0.5 * torch.dot(u, Ku_next))
        u_prev, u, Ku = u, u_next, Ku_next
    energy = (torch.stack(energy) if energy
              else torch.zeros(0, dtype=dtype, device=device))
    return WaveResult(u=u, v=(u - u_prev) / dt, energy=energy)
