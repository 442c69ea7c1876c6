"""Port parity, the second slice whole: solve_poisson_fast with the general
hierarchy (``precond="general"``), with nonzero Dirichlet data (``g=``)
and with the host build (``use_fused=False``), against the JAX package on
the CPU in float64."""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from tpufem.assemble.planar import (element_coord_views as jax_views,
                                    element_load_views as jax_loads,
                                    p1_stiffness_views as jax_stiffness)
from tpufem.assemble.structured import (
    assemble_stencil_structured_bt as jax_assemble,
    assemble_vector_structured_bt as jax_assemble_vector,
    structured_plan as jax_plan)
from tpufem.fem.quadrature import tetrahedron_rule as jax_rule
from tpufem.solve.bc import apply_dirichlet_stencil as jax_dirichlet
from tpufem.solve.multigrid import _embed_grid_numpy, _light_grid
from tpufem.solve.poisson import model_problem_3d_planes as jax_f
from tpufem.solve.structured_fast import solve_poisson_fast as jax_fast

from tpufem_torch.assemble.structured import structured_plan
from tpufem_torch.fem.quadrature import tetrahedron_rule
from tpufem_torch.solve import structured_fast as tsf
from tpufem_torch.solve.multigrid import _light_grid as port_light_grid
from tpufem_torch.solve.poisson import model_problem_3d_planes

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

DOMAIN = (-3.0, 3.0)


def lin(x, y, z):
    """Harmonic Dirichlet data: the solution is the zero-data one plus it."""
    return x + 2.0 * y + 3.0 * z


def _rel(a, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(a) - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("kw", [dict(precond="general"), dict(g=lin)],
                         ids=["general", "dirichlet"])
def test_solve_poisson_fast_matches_jax(kw):
    ref = jax_fast(DOMAIN, 8, jax_f(), tol=1e-8, dtype=jnp.float64,
                   interpret=True, **kw)
    sol = tsf.solve_poisson_fast(DOMAIN, 8, model_problem_3d_planes(),
                                 tol=1e-8, dtype=torch.float64,
                                 device="cpu", **kw)
    assert sol.cg.converged and bool(ref.cg.converged)
    assert sol.cg.iterations == int(ref.cg.iterations)
    # float64 solves of the same system to 1e-8: iterates agree to 1e-9
    assert _rel(sol.u.numpy(), ref.u) <= 1e-9


@pytest.mark.parametrize("g", [None, lin], ids=["zero", "linear"])
def test_host_system_matches_jax(g):
    """The build behind use_fused=False: element planes, slice-add assembly
    and elimination, against the reference's CPU build."""
    n = 8
    info, coords, bc = _light_grid(DOMAIN, n, 3)
    jp = jax_plan(info, embed=True)
    tp = structured_plan(port_light_grid(DOMAIN, n)[0], embed=True)
    mask = _embed_grid_numpy(bc, jp.store_grid, fill=False)
    g_emb = None if g is None else _embed_grid_numpy(
        g(*coords).reshape(bc.shape), jp.store_grid)
    Xv = jax_views(jnp.asarray(coords), info)
    jA = jax_assemble(jp, jax_stiffness(Xv, "tetrahedron"))
    jb = jax_assemble_vector(jp, jax_loads(Xv, "tetrahedron", jax_rule(2),
                                           jax_f()))
    jA, jb = jax_dirichlet(jA, jb, jnp.asarray(mask),
                           None if g_emb is None else jnp.asarray(g_emb))
    tA, tb = tsf._host_system(
        tp, coords, model_problem_3d_planes(), tetrahedron_rule(2),
        torch.float64, torch.as_tensor(mask),
        None if g_emb is None else torch.as_tensor(g_emb))
    ref = np.asarray(jA.data)
    np.testing.assert_allclose(tA.data.numpy(), ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-12,
                               atol=1e-12 * np.abs(np.asarray(jb)).max())


@pytest.mark.parametrize("kw", [dict(), dict(precond="general", g=lin)],
                         ids=["const", "general+dirichlet"])
def test_host_build_solve_matches_fused(kw):
    common = dict(tol=1e-8, dtype=torch.float64, device="cpu", **kw)
    fused = tsf.solve_poisson_fast(DOMAIN, 8, model_problem_3d_planes(),
                                   **common)
    host = tsf.solve_poisson_fast(DOMAIN, 8, model_problem_3d_planes(),
                                  use_fused=False, **common)
    assert host.cg.converged and fused.cg.converged
    assert host.cg.iterations == fused.cg.iterations
    assert _rel(host.u.numpy(), fused.u.numpy()) <= 1e-9


def test_dirichlet_solution_is_shifted_by_the_data():
    """L harmonic: u_g = u_0 + L on the nodes, to the solver tolerance."""
    common = dict(tol=1e-10, dtype=torch.float64, precond="general",
                  device="cpu")
    u0 = tsf.solve_poisson_fast(DOMAIN, 8, model_problem_3d_planes(),
                                **common).u
    ug = tsf.solve_poisson_fast(DOMAIN, 8, model_problem_3d_planes(), g=lin,
                                **common).u
    _, coords, _ = port_light_grid(DOMAIN, 8)
    shift = torch.as_tensor(lin(*coords.reshape(3, -1)))
    assert _rel((ug - shift).numpy(), u0.numpy()) <= 1e-8
