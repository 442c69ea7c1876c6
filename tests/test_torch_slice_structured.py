"""Port parity, the generic structured assembly slice whole: the stiffness
from the fused assembly (B13's plain version on the CPU; the JAX package's
Pallas kernel in interpret mode), the host RHS of
examples/poisson_3d_multigrid.py (element_coords_bt, element_load_bt,
assemble_vector_structured_bt), the Dirichlet elimination on the mesh's
boundary flags, and the MG-PCG on the built operator (top=), against the
JAX package on the CPU in float64."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpufem.assemble import planar as jplanar
from tpufem.assemble import structured as jst
from tpufem.fem.quadrature import tetrahedron_rule as jax_rule
from tpufem.mesh.box import box_mesh as jax_box_mesh
from tpufem.ops.assemble_pallas import (assemble_stencil_pallas,
                                        element_coords_bt_embedded as jax_emb)
from tpufem.solve import multigrid as jmg
from tpufem.solve.bc import apply_dirichlet_stencil as jax_dirichlet
from tpufem.solve.cg import cg as jax_cg
from tpufem.solve.poisson import model_problem_3d_planes as jax_f
from tpufem.sparse.stencil import stencil_matvec as jax_stencil_matvec

import tpufem_torch
from tpufem_torch.assemble import planar
from tpufem_torch.assemble.structured import (assemble_vector_structured_bt,
                                              structured_plan)
from tpufem_torch.fem.quadrature import tetrahedron_rule
from tpufem_torch.ops.assemble_cuda import (assemble_stencil_cuda,
                                            element_coords_bt_embedded)
from tpufem_torch.solve import multigrid as tmg
from tpufem_torch.solve.bc import apply_dirichlet_stencil
from tpufem_torch.solve.poisson import (model_problem_3d,
                                        model_problem_3d_planes)

# several pytest workers share the CPU: one intra-op thread each keeps
# the many small tensor ops from oversubscribing it
torch.set_num_threads(1)

DOMAIN = (-3.0, 3.0)


def _port(n):
    """The slice composed from the port on the CPU: (guarded cg result,
    plan, mesh)."""
    mesh = tpufem_torch.box_mesh(-3, 3, -3, 3, -3, 3, n, n, n)
    plan = structured_plan(mesh, embed=True)
    A = assemble_stencil_cuda(plan, torch.as_tensor(
        element_coords_bt_embedded(mesh, plan, dtype=np.float64)))
    X = torch.as_tensor(planar.element_coords_bt(mesh, np.float64))
    be = planar.element_load_bt(X, "tetrahedron", tetrahedron_rule(3),
                                model_problem_3d_planes())
    b = assemble_vector_structured_bt(plan, be)
    bc = plan.embed_field(torch.as_tensor(mesh.node_flags != 0), fill=0)
    A, b = apply_dirichlet_stencil(A, b, bc)
    levels = tmg.build_poisson_multigrid(DOMAIN, n, dtype=torch.float64,
                                         coarse_max=2, top=(A.data, bc),
                                         device="cpu")
    M = tmg.mg_preconditioner(levels, nu1=1, nu2=1)
    return tpufem_torch.cg(A.matvec, b, tol=1e-10, maxiter=100, M=M), plan, \
        mesh


def _jax(n):
    mesh = jax_box_mesh(-3, 3, -3, 3, -3, 3, n, n, n)
    plan = jst.structured_plan(mesh, embed=True)
    A = assemble_stencil_pallas(plan, jnp.asarray(jax_emb(
        mesh, plan, plan.store_grid[0], np.float64)),
        block_lead=plan.store_grid[0], interpret=True)
    X = jnp.asarray(jplanar.element_coords_bt(mesh, np.float64))
    be = jplanar.element_load_bt(X, "tetrahedron", jax_rule(3), jax_f())
    b = jst.assemble_vector_structured_bt(plan, be)
    bc = plan.embed_field(jnp.asarray(mesh.node_flags != 0), fill=0)
    A, b = jax_dirichlet(A, b, bc)
    levels = jmg.build_poisson_multigrid(DOMAIN, n, 3, dtype=jnp.float64,
                                         coarse_max=2, use_pallas=False,
                                         top=(A.data, bc))
    M = jmg.mg_preconditioner(levels, nu1=1, nu2=1, use_pallas=False)
    return jax_cg(lambda v: jax_stencil_matvec(A.data, A.offsets, v), b,
                  tol=1e-10, maxiter=100, M=M)


@pytest.mark.parametrize("n", [4, 8])
def test_structured_slice_matches_jax(n):
    res, plan, mesh = _port(n)
    ref = _jax(n)
    assert res.converged and bool(ref.converged)
    assert res.iterations == int(ref.iterations)
    x_ref = np.asarray(ref.x)
    assert np.abs(res.x.numpy() - x_ref).max() <= 1e-10 * np.abs(x_ref).max()
    # and it is the discretization of the manufactured solution
    u = plan.extract_field(res.x).numpy()
    ue = model_problem_3d()[1](mesh.coords)
    err = np.linalg.norm(u - ue) / np.linalg.norm(ue)
    assert err < (0.25 if n == 4 else 0.06)
