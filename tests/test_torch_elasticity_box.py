"""Port parity, the structured elasticity path
(tpufem_torch.solve.elasticity_structured) against the JAX package's
tpufem.solve.elasticity_structured, float64 on the CPU: one cell's
element matrices, the block-stencil data with its clamped boundary and the
manufactured solution bit for bit; the block-stencil product within
1e-12 relative of the JAX one and of the port's own BCSR operator; the
MG hierarchy's operators, block inverses and coarse inverse equal; and
solve_elasticity_box with block-Jacobi and with the vector MG at the JAX
package's iteration counts, its solution within 1e-10 relative."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpufem.solve import elasticity_structured as jes
from tpufem.assemble.structured import structured_plan as jax_plan
from tpufem.solve.multigrid import _light_grid as jax_light_grid

from tpufem_torch.assemble.structured import structured_plan
from tpufem_torch.fem.space import VectorFunctionSpace
from tpufem_torch.mesh.adjacency import ell_pattern
from tpufem_torch.mesh.box import box_mesh
from tpufem_torch.solve import elasticity_structured as tes
from tpufem_torch.solve.elasticity import elasticity_forms
from tpufem_torch.solve.multigrid import _embed_grid_numpy, _light_grid
from tpufem_torch.sparse.bcsr import apply_dirichlet_bcsr, assemble_bcsr

torch.set_num_threads(1)

LAM, MU = 1.2, 0.8


def _data(mod, light_grid, plan_of, n):
    info, _, bc = light_grid((-3.0, 3.0), n, 3)
    plan = plan_of(info, embed=True)
    Ke1, _ = mod.uniform_cell_matrices((-3.0, 3.0), n, LAM, MU)
    data = mod.elasticity_stencil_data(plan, Ke1, np.float64)
    mask = _embed_grid_numpy(bc, plan.store_grid, fill=False)
    return plan, mod._apply_bc_blocks(data, plan.offsets, mask)


def test_cell_matrices_stencil_data_and_manufactured_equal():
    for a, b in zip(tes.uniform_cell_matrices((-3.0, 3.0), 4, LAM, MU),
                    jes.uniform_cell_matrices((-3.0, 3.0), 4, LAM, MU)):
        np.testing.assert_array_equal(a, b)
    pt, dt = _data(tes, _light_grid, structured_plan, 4)
    pj, dj = _data(jes, jax_light_grid, jax_plan, 4)
    assert tuple(pt.offsets) == tuple(pj.offsets)
    np.testing.assert_array_equal(dt, dj)
    xyz = np.random.default_rng(0).uniform(-3, 3, (3, 50))
    for ft, fj in zip(tes.manufactured_elasticity_3d(LAM, MU),
                      jes.manufactured_elasticity_3d(LAM, MU)):
        np.testing.assert_array_equal(ft(*xyz), fj(*xyz))


def test_block_stencil_matvec_matches_jax_and_bcsr():
    """The block-stencil product equals the JAX one and the port's generic
    BCSR operator on the same box (1e-12 relative)."""
    n = 4
    plan, data = _data(tes, _light_grid, structured_plan, n)
    mesh = box_mesh(-3, 3, -3, 3, -3, 3, n, n, n)
    V = VectorFunctionSpace(mesh, degree=1)
    wf = elasticity_forms(V, LAM, MU)
    wf.device = "cpu"
    Ke = wf.element_matrices(torch.as_tensor(mesh.element_coords()))
    pattern = ell_pattern(V.scalar_dof_conn, V.num_scalar_dofs, pad_to=16)
    A = assemble_bcsr(pattern, Ke, 3)
    A, _ = apply_dirichlet_bcsr(A, torch.zeros(V.num_dofs,
                                               dtype=torch.float64),
                                V.dof_flags)
    x_nodes = np.random.default_rng(0).standard_normal((mesh.num_nodes, 3))
    y_ref = A.matvec(torch.as_tensor(x_nodes.reshape(-1))).numpy()
    x_emb = torch.stack([plan.embed_field(torch.as_tensor(x_nodes[:, c]))
                         for c in range(3)])
    y_emb = tes.block_stencil_matvec(torch.as_tensor(data), x_emb,
                                     plan.offsets)
    y = torch.stack([plan.extract_field(y_emb[c]) for c in range(3)],
                    dim=1).numpy().reshape(-1)
    assert np.abs(y - y_ref).max() <= 1e-12 * np.abs(y_ref).max()
    yj = np.asarray(jes.block_stencil_matvec(
        jnp.asarray(data), jnp.asarray(x_emb.numpy()), plan.offsets))
    assert np.abs(y_emb.numpy() - yj).max() <= 1e-12 * np.abs(yj).max()


def test_multigrid_hierarchy_equal():
    lt = tes.build_elasticity_multigrid((-3.0, 3.0), 12, lam=LAM, mu=MU,
                                        dtype=torch.float64, device="cpu")
    lj = jes.build_elasticity_multigrid((-3.0, 3.0), 12, lam=LAM, mu=MU,
                                        dtype=jnp.float64)
    assert len(lt) == len(lj) == 2
    for a, b in zip(lt, lj):
        np.testing.assert_array_equal(a.data.numpy(), np.asarray(b.data))
        np.testing.assert_array_equal(a.inv_blocks.numpy(),
                                      np.asarray(b.inv_blocks))
        np.testing.assert_array_equal(a.bc_mask.numpy(),
                                      np.asarray(b.bc_mask))
        assert (a.coarse_inverse is None) == (b.coarse_inverse is None)
    np.testing.assert_array_equal(lt[-1].coarse_inverse.numpy(),
                                  np.asarray(lj[-1].coarse_inverse))


@pytest.mark.parametrize("n,precond", [(6, "jacobi"), (12, "mg")])
def test_solve_elasticity_box_matches_the_reference(n, precond):
    """Manufactured solution, fp64, tol 1e-8: the JAX package's count, u
    within 1e-10 relative."""
    f = jes.manufactured_elasticity_3d(LAM, MU)[1]
    kw = dict(lam=LAM, mu=MU, body_force=f, tol=1e-8, maxiter=4000,
              precond=precond)
    ref = jes.solve_elasticity_box((-3.0, 3.0), n, dtype=jnp.float64, **kw)
    sol = tes.solve_elasticity_box((-3.0, 3.0), n, dtype=torch.float64,
                                   device="cpu", **kw)
    assert sol.cg.converged and bool(ref.cg.converged)
    assert sol.cg.iterations == int(ref.cg.iterations)
    assert sol.num_dofs == ref.num_dofs and sol.node_grid == ref.node_grid
    u_ref = np.asarray(ref.u)
    assert np.abs(sol.u.numpy() - u_ref).max() <= 1e-10 * np.abs(u_ref).max()


def test_zero_force_is_zero_and_options_checked():
    sol = tes.solve_elasticity_box((-3.0, 3.0), 4, lam=LAM, mu=MU,
                                   dtype=torch.float64, tol=1e-12,
                                   maxiter=100, device="cpu")
    assert sol.u.abs().max().item() < 1e-12
    with pytest.raises(ValueError, match="precond"):
        tes.solve_elasticity_box((-3.0, 3.0), 4, precond="amg",
                                 device="cpu")
