"""High-level fast path, as in tpufem.solve.structured_fast: the benchmark
pipeline as one library call for Poisson on the uniform 2D or 3D box.

    from tpufem_torch.solve.structured_fast import solve_poisson_fast
    sol = solve_poisson_fast((-3, 3), 96, model_problem_3d_planes(),
                             tol=1e-5)                  # on the card
    sol = solve_poisson_fast((-3, 3), 1024, model_problem_2d_planes(),
                             dim=2, tol=1e-5)

Fused system build (K1 in 3D, B7 in 2D) + MG-preconditioned CG with the
stencil SpMV (K2): the constant-coefficient hierarchy (default; B5 sweeps,
fused V-cycle transfers K3, K4 in 3D) or the general one
(``precond="general"``: the finest level is the built operator, sweeps and
residuals in B4).  On 3D grids past the reference's blocked-route rule
(about 300^3) the finest level's stencil calls run B3 / B5b.  Nonzero
Dirichlet data ``g`` is eliminated after the build (solve.bc).  The entry
runs on the card unless ``device="cpu"`` is asked for; there every kernel
runs its plain PyTorch version.
"""
from __future__ import annotations

import math
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from tpufem_torch.assemble.planar import (element_coord_views,
                                          element_load_views,
                                          p1_stiffness_views)
from tpufem_torch.assemble.structured import (assemble_stencil_structured_bt,
                                              assemble_vector_structured_bt,
                                              structured_plan)
from tpufem_torch.fem.quadrature import tetrahedron_rule, triangle_rule
from tpufem_torch.ops.fused_system_cuda import (
    build_poisson_system, node_coords_embedded_from_grid)
from tpufem_torch.ops.stencil_cuda import (stencil_matvec_dot_embedded,
                                           stencil_matvec_embedded)
from tpufem_torch.solve.bc import apply_dirichlet_stencil
from tpufem_torch.solve.cg import CGResult, cg
from tpufem_torch.solve.multigrid import (_embed_grid_numpy, _light_grid,
                                          build_poisson_multigrid,
                                          mg_preconditioner)

__all__ = ["FastSolution", "solve_poisson_fast"]


class FastSolution(NamedTuple):
    u: torch.Tensor              # node-ordered solution [NN]
    cg: CGResult
    num_dofs: int
    phases_s: dict


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _host_system(plan, coords_grid, f_planes, rule, dtype, bc_mask, g_emb):
    """The unfused build on the host, as the reference pins it to its CPU
    device: batch-trailing element planes in torch on the CPU, slice-added
    into the stencil planes, then the Dirichlet elimination.  (A, b)."""
    Xv = element_coord_views(torch.as_tensor(coords_grid, dtype=dtype),
                             plan.info)
    cell = "tetrahedron" if len(plan.info.node_grid) == 3 else "triangle"
    A = assemble_stencil_structured_bt(plan, p1_stiffness_views(Xv, cell))
    b = assemble_vector_structured_bt(
        plan, element_load_views(Xv, cell, rule, f_planes))
    return apply_dirichlet_stencil(A, b, bc_mask, g_emb)


def solve_poisson_fast(domain, n_cells: int, f_planes: Callable, *,
                       dim: int = 3, tol: float = 1e-5, maxiter: int = 60,
                       dtype: torch.dtype = torch.float32,
                       quadrature_degree: int = 2,
                       use_multigrid: bool = True,
                       levels: Optional[int] = None,
                       use_fused: bool = True,
                       g: Optional[Callable] = None,
                       rhs_mode: str = "quadrature",
                       precond: str = "const",
                       check_every: int = 4,
                       device="cuda") -> FastSolution:
    """Assemble + solve -Δu = f on (domain)^dim with n_cells^dim cells,
    dim 2 (P1 triangles) or 3 (P1 tetrahedra), on ``device`` (the card by
    default).

    ``f_planes(x, y[, z])`` takes coordinate planes and returns one plane;
    on a CUDA device the fused build needs a C expression
    (solve.poisson.RhsFunction).  ``n_cells`` should halve down to <= 8
    for the full hierarchy (e.g. 32/48/64/96/128/384; 1024 in 2D).  2D
    quadrature is the triangle rule of degree max(quadrature_degree, 2).

    ``g``: Dirichlet data as ``g(x, y[, z]) -> plane``, evaluated on the
    host's node coordinates; the build then emits the raw system and the
    elimination moves g to the RHS.  Default None: zero data, eliminated
    inside the build.

    ``precond``: "const" (default) preconditions with the analytic
    constant-coefficient hierarchy, valid for any Dirichlet data on this
    box; "general" uses the assembled finest level (``top=``), the right
    choice for an operator edited afterwards.  ``use_multigrid=False``
    preconditions with Jacobi.  ``use_fused=False`` builds the system on
    the host (torch on the CPU) and moves it to ``device``.
    ``check_every``: CG convergence-check batching (solve.cg).
    """
    if precond not in ("const", "general"):
        raise ValueError(f"precond {precond!r}: const | general")
    if dim not in (2, 3):
        raise ValueError(f"dim {dim}: the fast path solves on 2D or 3D "
                         "boxes")
    phases = {}

    t0 = time.perf_counter()
    info, coords_grid, bc_grid = _light_grid(domain, n_cells, dim)
    plan = structured_plan(info, embed=True)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    bc_mask = torch.as_tensor(_embed_grid_numpy(bc_grid, plan.store_grid,
                                                fill=False), device=device)
    g_emb = None
    if g is not None:
        g_nodes = np.asarray(g(*coords_grid), np_dtype)
        g_emb = torch.as_tensor(_embed_grid_numpy(
            g_nodes.reshape(bc_grid.shape), plan.store_grid), device=device)
    phases["host_setup"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    rule = (tetrahedron_rule(quadrature_degree) if dim == 3
            else triangle_rule(max(quadrature_degree, 2)))
    if use_fused:
        C = torch.as_tensor(node_coords_embedded_from_grid(
            coords_grid, plan, np_dtype), device=device)
        A, b = build_poisson_system(plan, C, f_planes, rule,
                                    apply_bc=g_emb is None, rhs_mode=rhs_mode)
        del C       # nothing downstream reads the coordinates
        if g_emb is not None:
            A, b = apply_dirichlet_stencil(A, b, bc_mask, g_emb)
        data = A.data
    else:
        A, b = _host_system(plan, coords_grid, f_planes, rule, dtype,
                            bc_mask.cpu(),
                            None if g_emb is None else g_emb.cpu())
        data, b = A.data.to(device), b.to(device)
    _sync(device)
    phases["assemble_wall"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if use_multigrid:
        if precond == "const":
            mg_levels = build_poisson_multigrid(
                domain, n_cells, dim, dtype=dtype, levels=levels,
                operator="const", device=device)
        else:
            mg_levels = build_poisson_multigrid(
                domain, n_cells, dim, dtype=dtype, levels=levels,
                top=(data, bc_mask), device=device)
        M = mg_preconditioner(mg_levels, nu1=1, nu2=1)
        M_dot = mg_preconditioner(mg_levels, nu1=1, nu2=1, with_dot=True)
    else:
        d = data[plan.offsets.index(0)]
        inv_d = torch.where(d != 0, 1.0 / d, torch.ones_like(d))
        M = lambda r: r * inv_d
        M_dot = None
    phases["hierarchy"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    res = cg(lambda v: stencil_matvec_embedded(data, v, plan), b, tol=tol,
             maxiter=maxiter, M=M, check_every=check_every,
             matvec_dot=lambda v: stencil_matvec_dot_embedded(data, v, plan),
             M_dot=M_dot)
    _sync(device)
    phases["solve_wall"] = time.perf_counter() - t0

    return FastSolution(u=plan.extract_field(res.x), cg=res,
                        num_dofs=math.prod(info.node_grid),
                        phases_s={k: round(v, 3) for k, v in phases.items()})
