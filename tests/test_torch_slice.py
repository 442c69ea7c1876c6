"""Port parity, the slice whole: solve_poisson_fast (fused build, const
MG-PCG with the fused transfers, guarded cg) and the mixed-precision
refinement of tpufem_torch against the JAX package, on the CPU."""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from tpufem.solve import multigrid as jmg
from tpufem.solve.refine import refined_stencil_solve as jax_refined
from tpufem.solve.structured_fast import solve_poisson_fast as jax_fast
from tpufem.solve.poisson import model_problem_3d_planes as jax_f
from tpufem.sparse.stencil import stencil_matvec

from tpufem_torch.assemble.structured import structured_plan
from tpufem_torch.fem.quadrature import tetrahedron_rule
from tpufem_torch.ops.fused_system_cuda import (
    build_poisson_system, node_coords_embedded_from_grid)
from tpufem_torch.solve import multigrid as tmg
from tpufem_torch.solve.poisson import model_problem_3d, model_problem_3d_planes
from tpufem_torch.solve.refine import refined_stencil_solve
from tpufem_torch.solve.structured_fast import solve_poisson_fast

# several pytest workers share the CPU: one intra-op thread each keeps
# the many small tensor ops from oversubscribing it
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """One BLAS thread a test, as one torch thread: numpy's OpenBLAS
    threads spin against the other workers on the shared CPU (a 729 x 729
    inverse takes seconds on eight, 0.07 s on one)."""
    with threadpool_limits(1, user_api="blas"):
        yield


def test_solve_poisson_fast_matches_jax():
    ref = jax_fast((-3.0, 3.0), 8, jax_f(), tol=1e-8, dtype=jnp.float64,
                   interpret=True)
    sol = solve_poisson_fast((-3.0, 3.0), 8, model_problem_3d_planes(),
                             tol=1e-8, dtype=torch.float64, device="cpu")
    assert sol.cg.converged and bool(ref.cg.converged)
    assert sol.cg.iterations == int(ref.cg.iterations) == 4
    assert sol.num_dofs == ref.num_dofs == 729
    u_ref = np.asarray(ref.u)
    # float64 solves of the same system to 1e-8: iterates agree to 1e-9
    assert np.abs(sol.u.numpy() - u_ref).max() <= 1e-9 * np.abs(u_ref).max()
    # and the solution is the O(h^2) discretization of the manufactured one
    _, coords, _ = tmg._light_grid((-3.0, 3.0), 8)
    ue = model_problem_3d()[1](coords.reshape(3, -1).T)
    err = np.linalg.norm(sol.u.numpy() - ue) / np.linalg.norm(ue)
    assert err < 0.06


def test_jacobi_variant_converges():
    sol = solve_poisson_fast((-3.0, 3.0), 8, model_problem_3d_planes(),
                             tol=1e-8, dtype=torch.float64,
                             use_multigrid=False, maxiter=400, device="cpu")
    assert sol.cg.converged and sol.cg.iterations % 4 == 0


@pytest.mark.parametrize("dim", [1, 4])
def test_unported_options_raise(dim):
    # the structured grids are 2D or 3D, as in the JAX package: any other
    # dim raises up front, before any setup or device work
    with pytest.raises(ValueError, match="2D or 3D"):
        solve_poisson_fast((-3.0, 3.0), 8, model_problem_3d_planes(),
                           dim=dim, device="cpu")
    with pytest.raises(ValueError, match="2D or 3D"):
        tmg.build_poisson_multigrid((-3.0, 3.0), 8, dim, device="cpu")


@pytest.mark.parametrize("entry", [solve_poisson_fast,
                                   tmg.build_poisson_multigrid])
def test_entry_points_default_to_the_card(entry):
    import inspect

    assert inspect.signature(entry).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        # no silent CPU fallback: without a card the default raises torch's
        # own error instead of returning CPU tensors
        with pytest.raises((AssertionError, RuntimeError)):
            if entry is solve_poisson_fast:
                entry((-3.0, 3.0), 8, model_problem_3d_planes(),
                      dtype=torch.float64)
            else:
                entry((-3.0, 3.0), 8, dtype=torch.float64)


def test_refined_stencil_solve_matches_jax():
    """fp32 inner MG-PCG, fp64 residuals of the analytic operator, as in
    bench.py; n=16 with a 3-level hierarchy."""
    n = 16
    info, coords, bc = tmg._light_grid((-3.0, 3.0), n)
    plan = structured_plan(info, embed=True)
    C = torch.as_tensor(node_coords_embedded_from_grid(coords, plan,
                                                       np.float32))
    A32, b32 = build_poisson_system(plan, C, model_problem_3d_planes(),
                                    tetrahedron_rule(2))
    raw64 = tmg._apply_bc_numpy(
        tmg._uniform_stencil_data(plan, tmg._uniform_cell_stiffness(
            (-3.0, 3.0), n)), plan.offsets,
        tmg._embed_grid_numpy(bc, plan.store_grid, fill=False))
    tl = tmg.build_poisson_multigrid((-3.0, 3.0), n, dtype=torch.float32,
                                     coarse_max=4, operator="const",
                                     device="cpu")
    res = refined_stencil_solve(
        A32.data, torch.as_tensor(raw64), plan.offsets,
        b32.to(torch.float64), tmg.mg_preconditioner(tl, nu1=1, nu2=1),
        tol=1e-8, inner_iters=12, max_outer=6,
        M_dot=tmg.mg_preconditioner(tl, nu1=1, nu2=1, with_dot=True))

    jl = jmg.build_poisson_multigrid((-3.0, 3.0), n, 3, dtype=jnp.float32,
                                     coarse_max=4, use_pallas=False,
                                     operator="const")
    d32 = jnp.asarray(A32.data.numpy())
    ref = jax_refined(d32, jnp.asarray(raw64), plan.offsets,
                      jnp.asarray(b32.numpy(), jnp.float64),
                      jmg.mg_preconditioner(jl, nu1=1, nu2=1,
                                            use_pallas=False),
                      tol=1e-8, inner_iters=12, max_outer=6,
                      matvec32=lambda v: stencil_matvec(d32, plan.offsets,
                                                        v))
    assert res.converged and bool(ref.converged)
    assert res.residual_norm <= 1e-8
    assert res.outer_iterations == int(ref.outer_iterations)
    # both iterates solve the fp64 system to a 1e-8 residual; their fp32
    # inner solves round differently, so they agree to ~cond * 1e-8
    x_ref = np.asarray(ref.x)
    assert np.abs(res.x.numpy() - x_ref).max() <= 1e-6 * np.abs(x_ref).max()
