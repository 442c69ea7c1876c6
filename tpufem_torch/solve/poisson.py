"""The reference model problems and the mesh-based Poisson solvers, as in
tpufem.solve.poisson.

-Δu = f on (-3,3)^dim with u = 0 on the boundary and manufactured solution
u = Π(9 - x_d²): in 2D f = 36 - 2(x² + y²), the reference's own problem;
in 3D its separable analogue.

The solvers run element stiffness -> global assembly (dense or ELL) ->
Dirichlet elimination -> (P)CG on any P1 simplex mesh and any Q1 quad or
hex mesh (the isoparametric weak-form kernels).  They run on the
card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from tpufem_torch.assemble.dense import assemble_dense, assemble_vector
from tpufem_torch.assemble.ell import assemble_ell
from tpufem_torch.assemble.local import element_load, p1_stiffness
from tpufem_torch.fem.elements import is_affine_cell
from tpufem_torch.fem.quadrature import rule_for_cell
from tpufem_torch.fem.space import FunctionSpace
from tpufem_torch.mesh.adjacency import ell_pattern, reverse_cuthill_mckee
from tpufem_torch.mesh.core import Mesh
from tpufem_torch.solve.bc import apply_dirichlet_dense, apply_dirichlet_ell
from tpufem_torch.solve.cg import CGResult, cg
from tpufem_torch.solve.precond import chebyshev, jacobi, lambda_max_bound
from tpufem_torch.sparse.ell import ELLMatrix, reorder_ell
from tpufem_torch.sparse.ell_cuda import ell_band_plan, ell_matvec_cuda

__all__ = ["RhsFunction", "model_problem_2d", "model_problem_2d_planes",
           "model_problem_3d", "model_problem_3d_planes", "PoissonSolution",
           "solve_poisson_dense", "solve_poisson_ell"]


@dataclasses.dataclass(frozen=True)
class RhsFunction:
    """An RHS coefficient f(x, y[, z]) on coordinate planes, in two forms.

    ``fn`` is a PyTorch (or numpy) callable, used by the plain versions;
    ``c_expr`` is the same function as a C expression of ``x, y`` (and
    ``z`` in 3D) of the kernel's floating type ``T`` (write literals as
    ``T(9)``), compiled into the fused-build kernel.  Without ``c_expr``
    only the plain path runs.
    """

    fn: Callable
    c_expr: Optional[str] = None

    def __call__(self, *planes):
        return self.fn(*planes)


def model_problem_2d():
    """(f, exact) on points x [..., 2]."""

    def f(x):
        return 36.0 - 2.0 * (x[..., 0] ** 2 + x[..., 1] ** 2)

    def exact(x):
        return (9.0 - x[..., 0] ** 2) * (9.0 - x[..., 1] ** 2)

    return f, exact


def model_problem_2d_planes() -> RhsFunction:
    """Plane form of the 2D RHS, with its C expression."""

    def f(x, y):
        return 36.0 - 2.0 * (x * x + y * y)

    return RhsFunction(f, "T(36) - T(2) * (x * x + y * y)")


def model_problem_3d():
    """(f, exact) on points x [..., 3]."""

    def exact(x):
        return ((9.0 - x[..., 0] ** 2) * (9.0 - x[..., 1] ** 2)
                * (9.0 - x[..., 2] ** 2))

    def f(x):
        x0, x1, x2 = x[..., 0], x[..., 1], x[..., 2]
        return 2.0 * ((9.0 - x1 ** 2) * (9.0 - x2 ** 2)
                      + (9.0 - x0 ** 2) * (9.0 - x2 ** 2)
                      + (9.0 - x0 ** 2) * (9.0 - x1 ** 2))

    return f, exact


def model_problem_3d_planes() -> RhsFunction:
    """Plane form of the 3D RHS, with its C expression."""

    def f(x, y, z):
        return 2.0 * ((9.0 - y * y) * (9.0 - z * z)
                      + (9.0 - x * x) * (9.0 - z * z)
                      + (9.0 - x * x) * (9.0 - y * y))

    return RhsFunction(
        f, "T(2) * ((T(9) - y * y) * (T(9) - z * z)"
           " + (T(9) - x * x) * (T(9) - z * z)"
           " + (T(9) - x * x) * (T(9) - y * y))")


# -- solvers -----------------------------------------------------------------

class PoissonSolution(NamedTuple):
    u: torch.Tensor
    cg: CGResult
    num_dofs: int


def _setup(mesh: Mesh, f, dtype, device):
    """(space, rule, ecoords, f) of a degree-1 solve."""
    if f is None:
        f = model_problem_2d()[0] if mesh.dim == 2 else model_problem_3d()[0]
    space = FunctionSpace(mesh, degree=1)
    rule = rule_for_cell(mesh.cell_type, 5 if mesh.dim == 2 else 3)
    ecoords = torch.as_tensor(mesh.element_coords(), dtype=dtype,
                              device=device)
    return space, rule, ecoords, f


def _poisson_local(space: FunctionSpace, ecoords, f: Callable, rule, dtype):
    """(Ke [NE, n, n], be [NE, n]) of the Poisson form on any cell type.

    Affine simplices take the closed-form P1 kernel; tensor-product cells
    (quad/hex) go through the isoparametric WeakForm kernels, whose
    geometry is evaluated at every quadrature point.
    """
    if is_affine_cell(space.mesh.cell_type):
        return (p1_stiffness(ecoords, space.element),
                element_load(ecoords, space.element, rule, f))
    from tpufem_torch.forms.language import Coefficient, dot, grad
    from tpufem_torch.forms.weakform import WeakForm

    wf = WeakForm(space, quadrature=rule, dtype=dtype,
                  device=ecoords.device).build(
        lambda u, v: dot(grad(u), grad(v)),
        lambda v: Coefficient(f) * v)
    return wf.element_matrices(ecoords), wf.element_vectors(ecoords)


def _rhs_and_bc(space: FunctionSpace, be: torch.Tensor):
    b = assemble_vector(space.dof_conn, be, space.num_dofs)
    return b, torch.as_tensor(space.dof_flags, device=be.device)


def solve_poisson_dense(mesh: Mesh, f: Optional[Callable] = None, *,
                        dtype=torch.float64, tol: float = 1e-10,
                        maxiter: int = 10_000,
                        device="cuda") -> PoissonSolution:
    """Dense-path solve (small meshes, golden tests)."""
    space, rule, ecoords, f = _setup(mesh, f, dtype, device)
    Ke, be = _poisson_local(space, ecoords, f, rule, dtype)
    A = assemble_dense(space.dof_conn, Ke, space.num_dofs)
    b, bc_mask = _rhs_and_bc(space, be)
    A, b = apply_dirichlet_dense(A, b, bc_mask)
    res = cg(lambda x: A @ x, b, tol=tol, maxiter=maxiter)
    return PoissonSolution(u=res.x, cg=res, num_dofs=space.num_dofs)


def solve_poisson_ell(mesh: Mesh, f: Optional[Callable] = None, *,
                      dtype=torch.float64, tol: float = 1e-8,
                      maxiter: int = 10_000, precondition: bool = True,
                      precond: Optional[str] = None,
                      assembly_method: str = "scatter",
                      pad_to: Optional[int] = None,
                      matvec: str = "gather",
                      block_rows: Optional[int] = None,
                      device="cuda") -> PoissonSolution:
    """ELL-path solve: the scalable single-device pipeline.

    matvec="pallas" (the reference's name, kept so that callers port
    unchanged) RCM-reorders the system and runs CG on the banded ELL
    kernel (sparse.ell_cuda, B9); the solution is returned in the original
    node order.  matvec="gather" runs ``ELLMatrix.matvec``, which takes the
    banded kernel too where the bandwidth allows and the gather form
    (the same kernel in absolute-column mode) elsewhere.

    ``precond``: "jacobi" | "chebyshev" (degree-14 polynomial Jacobi,
    Gershgorin lmax) | "amg" (strength-filtered greedy SA V-cycle with
    banded-embedded transfers, solve.amg: ``build_amg(A, aggregation=
    "greedy", strength=0.08, cycle="V")``); None falls back to the
    ``precondition`` bool (Jacobi).  "amg" implies the RCM-reordered path,
    whatever ``matvec`` says.  With a ``precond`` the "pallas" path primes
    the banded plan explicitly (any bandwidth, honoring ``block_rows``),
    and the AMG hierarchy primes each of its matrices on the card.
    Quad and hex meshes take the isoparametric weak-form kernels.
    """
    if precond not in (None, "jacobi", "chebyshev", "amg"):
        raise ValueError(f"unknown precond {precond!r}")
    if matvec not in ("gather", "pallas"):
        raise ValueError(f"unknown matvec {matvec!r}")
    if assembly_method not in ("scatter", "sort"):
        raise ValueError(f"unknown assembly method {assembly_method!r}")
    space, rule, ecoords, f = _setup(mesh, f, dtype, device)
    if pad_to is None:
        pad_to = 8 if mesh.dim == 2 else 16
    pattern = ell_pattern(space.dof_conn, space.num_dofs, pad_to=pad_to,
                          with_sort_plan=(assembly_method == "sort"))

    Ke, be = _poisson_local(space, ecoords, f, rule, dtype)
    A = assemble_ell(pattern, Ke, method=assembly_method)
    b, bc_mask = _rhs_and_bc(space, be)
    A, b = apply_dirichlet_ell(A, b, bc_mask)

    if precond == "amg":
        # aggregation needs a band-ordered system: the RCM path
        matvec = "pallas"

    def _build_M(Ap):
        if precond == "amg":
            from tpufem_torch.solve.amg import build_amg
            return build_amg(Ap, aggregation="greedy", strength=0.08,
                             cycle="V").apply
        if precond == "chebyshev":
            return chebyshev(Ap.matvec, Ap.diagonal(), degree=14,
                             lmax=lambda_max_bound(Ap))
        if precond == "jacobi" or precondition:
            return jacobi(Ap)
        return None

    if matvec == "gather":
        res = cg(A.matvec, b, tol=tol, maxiter=maxiter, M=_build_M(A))
        return PoissonSolution(u=res.x, cg=res, num_dofs=space.num_dofs)

    cols_np = A.cols.cpu().numpy()
    perm = reverse_cuthill_mckee(cols_np)
    data_p, cols_p = reorder_ell(A.data, cols_np, perm)
    dev = b.device
    perm_t = torch.as_tensor(perm, device=dev)
    b_p = b[perm_t]
    if precond is not None:
        A_p = ELLMatrix(torch.as_tensor(data_p, device=dev),
                        torch.as_tensor(cols_p, device=dev))
        A_p.prime_band_plan(block_rows)
        mv = A_p.matvec
        M = _build_M(A_p)
    else:
        plan = ell_band_plan(data_p, cols_p, block_rows=block_rows)
        d_t = torch.as_tensor(plan.data_t, device=dev)
        r_t = torch.as_tensor(plan.rel, device=dev)
        M = None
        if precondition:
            diag = np.take_along_axis(
                data_p, np.argmax(cols_p == np.arange(
                    len(perm))[:, None], axis=1)[:, None], axis=1)[:, 0]
            inv_d = torch.as_tensor(np.where(diag != 0, 1.0 / diag, 1.0),
                                    dtype=b_p.dtype, device=dev)
            M = lambda r: r * inv_d
        mv = lambda v: ell_matvec_cuda(plan, d_t, r_t, v)
    res = cg(mv, b_p, tol=tol, maxiter=maxiter, M=M)
    inv = torch.empty_like(perm_t)
    inv[perm_t] = torch.arange(perm_t.numel(), device=dev)
    return PoissonSolution(u=res.x[inv], cg=res, num_dofs=space.num_dofs)
