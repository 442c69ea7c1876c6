"""Port parity, the third slice whole: solve_poisson_fast on the 2D box
(fused 2D build B7, 7-point const or general MG-PCG) against the JAX
package's, for every option of the 3D path; float64 on the CPU, equal
iteration counts and u at 1e-10."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpufem.solve.poisson import model_problem_2d_planes as jax_f
from tpufem.solve.structured_fast import solve_poisson_fast as jax_fast

from tpufem_torch.solve.multigrid import _light_grid
from tpufem_torch.solve.poisson import (RhsFunction, model_problem_2d,
                                        model_problem_2d_planes)
from tpufem_torch.solve.structured_fast import solve_poisson_fast

# several pytest workers share the CPU: one intra-op thread each keeps
# the many small tensor ops from oversubscribing it
torch.set_num_threads(1)

DOMAIN = (-3.0, 3.0)


def lin(x, y):
    return 1.0 + 2.0 * x - 3.0 * y


@pytest.mark.parametrize("kw", [dict(), dict(precond="general"), dict(g=lin),
                                dict(use_fused=False),
                                dict(rhs_mode="interp")],
                         ids=["const", "general", "dirichlet", "host_build",
                              "interp"])
def test_solve_poisson_fast_2d_matches_jax(kw):
    ref = jax_fast(DOMAIN, 16, jax_f(), dim=2, tol=1e-8, dtype=jnp.float64,
                   interpret=True, **kw)
    sol = solve_poisson_fast(DOMAIN, 16, model_problem_2d_planes(), dim=2,
                             tol=1e-8, dtype=torch.float64, device="cpu",
                             **kw)
    assert sol.cg.converged and bool(ref.cg.converged)
    assert sol.cg.iterations == int(ref.cg.iterations)
    assert sol.num_dofs == 17 * 17
    u_ref = np.asarray(ref.u)
    assert np.abs(sol.u.numpy() - u_ref).max() <= 1e-10 * np.abs(u_ref).max()


def test_solve_poisson_fast_2d_discretizes_the_model_problem():
    """-Δu = 36 - 2(x² + y²) on (-3, 3)²: O(h²) against u = (9-x²)(9-y²)."""
    sol = solve_poisson_fast(DOMAIN, 32, model_problem_2d_planes(), dim=2,
                             tol=1e-10, dtype=torch.float64, device="cpu")
    _, coords, _ = _light_grid(DOMAIN, 32, 2)
    ue = model_problem_2d()[1](coords.reshape(2, -1).T)
    err = np.linalg.norm(sol.u.numpy() - ue) / np.linalg.norm(ue)
    assert sol.cg.converged and err < 2e-3


def _fused_rounding_matvec(data, offsets, x):
    """stencil_matvec with each multiply-add rounded once, as a fused
    multiply-add rounds it (the fp32 product is exact in fp64)."""
    n, halo = x.shape[0], int(max(abs(int(o)) for o in offsets))
    xp = torch.nn.functional.pad(x, (halo, halo)).double()
    y = torch.zeros_like(x)
    for k, off in enumerate(offsets):
        y = (y.double() + data[k].double()
             * xp[halo + int(off): halo + int(off) + n]).to(x.dtype)
    return y


@pytest.mark.parametrize("rounding", ["separate", "fused"])
def test_fp32_error_at_n1024_is_set_by_the_stencil_rounding(monkeypatch,
                                                           rounding):
    """At n=1024 in fp32 the stencil row sums cancel values of ~81 down to
    the O(h²) load, so how each multiply-add of the CG operator rounds,
    not the tolerance, sets the error at the same iteration count and
    relres: separate multiply and add (PyTorch's eager ops) reach the
    discretization level, one rounding per multiply-add (the CUDA
    kernels' fused multiply-add) leaves ~1.5e-3, under the 2.2e-3 gate
    that chip_smoke.py holds the card to."""
    from tpufem_torch.ops import stencil_cuda

    if rounding == "fused":
        monkeypatch.setattr(stencil_cuda, "stencil_matvec",
                            _fused_rounding_matvec)
    sol = solve_poisson_fast(DOMAIN, 1024, model_problem_2d_planes(), dim=2,
                             tol=1e-5, dtype=torch.float32, device="cpu")
    _, coords, _ = _light_grid(DOMAIN, 1024, 2)
    ue = model_problem_2d()[1](coords.reshape(2, -1).T)
    err = np.linalg.norm(sol.u.double().numpy() - ue) / np.linalg.norm(ue)
    print(f"{rounding}: {sol.cg.iterations} iterations, relres "
          f"{float(sol.cg.residual_norm):.4e}, rel L2 error {err:.4e}")
    assert sol.cg.converged and sol.cg.iterations == 8
    if rounding == "separate":
        assert err < 2e-5
    else:
        assert 1e-3 < err < 2.2e-3


def test_solve_poisson_fast_2d_reproduces_linear_dirichlet_data():
    """f = 0 with g = 1 + 2x - 3y: P1 reproduces the harmonic g exactly."""
    zero = RhsFunction(lambda x, y: 0.0 * x, "T(0)")
    sol = solve_poisson_fast(DOMAIN, 16, zero, dim=2, g=lin, tol=1e-11,
                             maxiter=200, dtype=torch.float64, device="cpu")
    _, coords, _ = _light_grid(DOMAIN, 16, 2)
    assert sol.cg.converged
    assert np.abs(sol.u.numpy() - lin(*coords).reshape(-1)).max() < 1e-8
