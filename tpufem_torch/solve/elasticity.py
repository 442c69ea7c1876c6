"""Linear elasticity solver: vector elements + BCSR + block-Jacobi or block
AMG PCG, as in tpufem.solve.elasticity.

The weak form is the standard small-strain one,

    a(u, v) = ∫ sigma(u) : eps(v),   sigma = lam tr(eps) I + 2 mu eps,

stated through the weak-form frontend; assembly lands in the BCSR block
format (one dense dim x dim block per node pair), whose SpMV is kernel B12
(sparse.ell_cuda) on the card; ``precond="amg"`` preconditions with the
block smoothed-aggregation AMG of solve.amg_block.  The solver runs on the
card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from tpufem_torch.assemble.dense import assemble_vector
from tpufem_torch.fem.space import FunctionSpace, VectorFunctionSpace
from tpufem_torch.forms.language import (Coefficient, Identity, dot, grad,
                                         inner, sym, tr)
from tpufem_torch.forms.weakform import WeakForm
from tpufem_torch.mesh.adjacency import ell_pattern, reverse_cuthill_mckee
from tpufem_torch.mesh.core import Mesh
from tpufem_torch.solve.cg import CGResult, cg
from tpufem_torch.solve.precond import block_jacobi
from tpufem_torch.sparse.bcsr import (BCSRMatrix, apply_dirichlet_bcsr,
                                      assemble_bcsr)
from tpufem_torch.sparse.ell_cuda import (_numpy, bcsr_band_plan,
                                          bcsr_matvec_cuda)

__all__ = ["ElasticitySolution", "elasticity_forms", "solve_elasticity",
           "banded_block_system"]


class ElasticitySolution(NamedTuple):
    u: torch.Tensor            # [num_dofs] displacement (node-major)
    cg: CGResult
    space: FunctionSpace
    A: BCSRMatrix
    walls: Optional[dict] = None   # phase walls (seconds) of the solve


def elasticity_forms(V: FunctionSpace, lam: float, mu: float,
                     body_force: Optional[Callable] = None) -> WeakForm:
    """WeakForm for -div(sigma(u)) = f with Lamé parameters (lam, mu);
    ``body_force`` takes torch points x[..., dim] and returns f[..., dim]."""
    d = V.mesh.dim

    def sigma(u):
        eps = sym(grad(u))
        return lam * tr(eps) * Identity(d) + 2.0 * mu * eps

    wf = WeakForm(V)
    rhs = None
    if body_force is not None:
        f = Coefficient(body_force, rank=1)
        rhs = lambda v: dot(f, v)
    wf.build(lambda u, v: inner(sigma(u), sym(grad(v))), rhs)
    return wf


def _synced(device):
    """Wait for the device's queued work, so a phase wall counts it."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def solve_elasticity(mesh: Mesh, *, lam: float = 1.0, mu: float = 1.0,
                     body_force: Optional[Callable] = None,
                     bc_values=None, dtype=torch.float64,
                     tol: float = 1e-10, maxiter: int = 20_000,
                     matvec: str = "gather", block_rows: int = 1024,
                     precond: Optional[str] = None,
                     interpret: bool = False, aot: bool = False,
                     device="cuda") -> ElasticitySolution:
    """Assemble and solve the elasticity system with block-Jacobi or
    block-AMG PCG.

    ``body_force``: callable on torch points x[..., dim] -> f[..., dim]
    (None: f = 0).  ``bc_values``: Dirichlet displacement per DOF (None:
    clamped 0).  ``matvec="pallas"`` (the reference's name, kept so that
    callers port unchanged): RCM-reorder the node pattern and run CG on the
    banded block kernel (B12) with component-major [b, n] vectors; the
    solution comes back in the original DOF order.  ``matvec="gather"``:
    CG on ``BCSRMatrix.matvec`` (B12 banded where the bandwidth allows, its
    absolute-column mode otherwise).  ``precond``: None / "jacobi" is
    block-Jacobi; "amg" is the block SA hierarchy with the rigid body
    modes (``build_block_amg(A, coords=...)``; for ``"pallas"`` over the
    RCM-permuted system with ``coords[perm]``, its node-major cycle fed
    through two relayouts of the component-major CG vectors, as in the
    reference).  ``interpret`` and ``aot`` (the TPU's interpret mode and
    executable cache) are not ported and raise when set.  Phase walls land
    in ``solution.walls``: host_pattern, element_matrices, assemble,
    band_plan, precond_setup (AMG; its stages in precond_setup_detail),
    solve (each ending in a synchronize on the card).
    """
    if interpret or aot:
        raise NotImplementedError(
            "interpret= and aot= are TPU-only (Pallas interpret mode, the "
            "executable cache of utils/aot.py) and not ported")
    if precond not in (None, "jacobi", "amg"):
        raise ValueError(f"unknown precond {precond!r}")
    if matvec not in ("gather", "pallas"):
        raise ValueError(f"unknown matvec {matvec!r}")

    walls: dict = {}
    t0 = time.perf_counter()
    V = VectorFunctionSpace(mesh, degree=1)
    wf = elasticity_forms(V, lam, mu, body_force)
    wf.dtype, wf.device = dtype, device
    nbv, num_dofs = V.num_components, V.num_dofs
    pattern = ell_pattern(V.scalar_dof_conn, V.num_scalar_dofs,
                          pad_to=8 if mesh.dim == 2 else 16,
                          with_sort_plan=False)
    walls["host_pattern"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ecoords = torch.as_tensor(mesh.element_coords(), dtype=dtype,
                              device=device)
    Ke = wf.element_matrices(ecoords)
    be = wf.element_vectors(ecoords) if wf.rhs_expr is not None else None
    del ecoords
    t1 = _synced(device)
    walls["element_matrices"] = t1 - t0

    A = assemble_bcsr(pattern, Ke, nbv)
    del Ke
    b = (assemble_vector(V.dof_conn, be, num_dofs) if be is not None
         else torch.zeros(num_dofs, dtype=dtype, device=device))
    bcv = (None if bc_values is None
           else torch.as_tensor(bc_values, dtype=dtype,
                                device=device).broadcast_to((num_dofs,)))
    A2, b2 = apply_dirichlet_bcsr(A, b, V.dof_flags, bcv)
    del A, b
    t0 = _synced(device)
    walls["assemble"] = t0 - t1

    if matvec == "gather":
        A2.resolve_band()
        M = block_jacobi(A2.diagonal_blocks())
        t1 = _synced(device)
        walls["band_plan"] = t1 - t0
        if precond == "amg":
            M = _amg_setup(A2, mesh.coords, walls, device).apply
            t1 = _synced(device)
        res = cg(A2.matvec, b2, tol=tol, maxiter=maxiter, M=M)
        walls["solve"] = _synced(device) - t1
        return ElasticitySolution(u=res.x, cg=res, space=V, A=A2,
                                  walls=walls)

    mv, M, perm, data_p, cols_p = banded_block_system(
        A2, pattern.cols, block_rows=block_rows, permuted=True)
    perm_t = torch.as_tensor(perm, device=device)
    # component-major permuted rhs and solution layout
    b_cm = b2.reshape(-1, nbv)[perm_t].T.contiguous()          # [b, NR]
    t1 = _synced(device)
    walls["band_plan"] = t1 - t0
    if precond == "amg":
        # the hierarchy over the RCM-permuted system (min-index aggregates
        # keep every coarse block operator banded); its cycle is
        # node-major, the banded CG component-major: two relayouts
        hier = _amg_setup(
            BCSRMatrix(torch.as_tensor(data_p, device=device),
                       torch.as_tensor(cols_p, device=device)),
            np.asarray(mesh.coords)[perm], walls, device)

        def M(r_cm):
            return hier.apply(r_cm.T.reshape(-1)).reshape(-1, nbv).T

        t1 = _synced(device)
    res = cg(mv, b_cm, tol=tol, maxiter=maxiter, M=M)
    walls["solve"] = _synced(device) - t1
    inv_t = torch.empty_like(perm_t)
    inv_t[perm_t] = torch.arange(perm_t.numel(), device=perm_t.device)
    u = res.x.T[inv_t].reshape(-1)                            # original order
    return ElasticitySolution(u=u, cg=res, space=V, A=A2, walls=walls)


def _amg_setup(A: BCSRMatrix, coords, walls: dict, device):
    """The block AMG hierarchy of A with the rigid body modes of
    ``coords``; its wall and stage walls into ``walls``."""
    from tpufem_torch.solve.amg_block import build_block_amg

    t0 = time.perf_counter()
    pw: dict = {}
    hier = build_block_amg(A, coords=np.asarray(coords), walls_out=pw)
    walls["precond_setup"] = _synced(device) - t0
    # stage walls rounded as the reference rounds them; the hierarchy's
    # shape (coarse_rows, levels, operator_complexity, gather) as it is
    walls["precond_setup_detail"] = {
        k: (round(v, 2) if isinstance(v, float)
            and k != "operator_complexity" else v)
        for k, v in pw.items()}
    return hier


def banded_block_system(A: BCSRMatrix, cols, *, block_rows: int = 1024,
                        permuted: bool = False):
    """The ``matvec="pallas"`` operator of a BCSR system: the node pattern
    ``cols`` (host numpy) renumbered by RCM, the banded block plan on the
    matrix's device and the block-Jacobi inverses, for component-major
    [b, NR] vectors in the new order.  Returns (matvec (kernel B12), M,
    perm) with new node i holding old node perm[i]; with ``permuted`` also
    the permuted host data [NR, K, b, b] and cols [NR, K] (what the AMG
    hierarchy is built on, without a second RCM)."""
    dev = A.data.device
    perm = reverse_cuthill_mckee(cols)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    data_p = _numpy(A.data)[perm]
    cols_p = inv[cols[perm]].astype(cols.dtype)
    plan, data_t = bcsr_band_plan(data_p, cols_p, block_rows=block_rows)
    d_dev = torch.as_tensor(data_t, device=dev)
    r_dev = torch.as_tensor(plan.rel, device=dev)
    M = block_jacobi(A.diagonal_blocks()[torch.as_tensor(perm, device=dev)],
                     component_major=True)

    def matvec(x):
        return bcsr_matvec_cuda(plan, d_dev, r_dev, x)

    if permuted:
        return matvec, M, perm, data_p, cols_p
    return matvec, M, perm
