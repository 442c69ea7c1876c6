"""High-level fast path, as in tpufem.solve.structured_fast: the benchmark
pipeline as one library call for 3D Poisson on the uniform box.

    from tpufem_torch.solve.structured_fast import solve_poisson_fast
    sol = solve_poisson_fast((-3, 3), 96, model_problem_3d_planes(),
                             tol=1e-5, device="cuda")

Fused system build (K1) + constant-coefficient MG-preconditioned CG with
the stencil SpMV (K2) and the fused V-cycle transfers (K3, K4).  On a CPU
device every kernel runs its plain PyTorch version.
"""
from __future__ import annotations

import math
import time
from typing import Callable, NamedTuple, Optional

import torch

from tpufem_torch.assemble.structured import structured_plan
from tpufem_torch.fem.quadrature import tetrahedron_rule
from tpufem_torch.ops.fused_system_cuda import (
    build_poisson_system, node_coords_embedded_from_grid)
from tpufem_torch.ops.stencil_cuda import (stencil_matvec_dot_embedded,
                                           stencil_matvec_embedded)
from tpufem_torch.solve.cg import CGResult, cg
from tpufem_torch.solve.multigrid import (_light_grid,
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
                       device="cpu") -> FastSolution:
    """Assemble + solve -Δu = f on (domain)^3 with n_cells^3 cells, zero
    Dirichlet data.

    ``f_planes(x, y, z)`` takes coordinate planes and returns one plane;
    on a CUDA device it needs a C expression (solve.poisson.RhsFunction).
    ``n_cells`` should halve down to <= 8 for the full hierarchy (e.g.
    32/48/64/96/128).  ``use_multigrid=False`` preconditions with Jacobi.
    ``check_every``: CG convergence-check batching (solve.cg).

    Not ported yet: nonzero Dirichlet data ``g``, ``precond="general"`` and
    the unfused build ``use_fused=False``.
    """
    if g is not None:
        raise NotImplementedError("nonzero Dirichlet data is not ported yet")
    if precond != "const":
        raise NotImplementedError("only precond='const' is ported")
    if not use_fused:
        raise NotImplementedError("only the fused system build is ported")
    if dim != 3:
        raise NotImplementedError("the port's fast path is 3D")
    phases = {}

    t0 = time.perf_counter()
    info, coords_grid, _ = _light_grid(domain, n_cells, dim)
    plan = structured_plan(info, embed=True)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    C = torch.as_tensor(node_coords_embedded_from_grid(coords_grid, plan,
                                                       np_dtype),
                        device=device)
    phases["host_setup"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    rule = tetrahedron_rule(quadrature_degree)
    A, b = build_poisson_system(plan, C, f_planes, rule, rhs_mode=rhs_mode)
    data = A.data
    del C           # nothing downstream reads the coordinates
    _sync(device)
    phases["assemble_wall"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if use_multigrid:
        mg_levels = build_poisson_multigrid(domain, n_cells, dim,
                                            dtype=dtype, levels=levels,
                                            device=device)
        M = mg_preconditioner(mg_levels)
        M_dot = mg_preconditioner(mg_levels, with_dot=True)
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
