"""Port parity, the sharded fused build (B8's plain version; the kernel's
card tests are in test_torch_cuda.py) and the general-geometry pipeline
``solve_poisson_dist_general``, against the port's own whole-grid build
(K1's plain version, bit for bit) and the JAX package on its 8 virtual CPU
devices.  Coordinates: the uniform box with its interior nodes jittered by
up to 0.15 h from a seeded numpy generator, as tests/test_dist_assembly.py
makes them."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from tpufem.assemble.planar import (element_coords_bt, element_load_bt,
                                    p1_stiffness_bt)
from tpufem.assemble.structured import (assemble_stencil_structured_bt,
                                        assemble_vector_structured_bt)
from tpufem.assemble.structured import structured_plan as j_structured_plan
from tpufem.dist.assembly import \
    build_poisson_system_sharded as j_build_sharded
from tpufem.dist.cg import stencil_cg_sharded as j_stencil_cg_sharded
from tpufem.fem.quadrature import tetrahedron_rule as j_tetrahedron_rule
from tpufem.mesh.box import box_mesh as j_box_mesh
from tpufem.solve.bc import apply_dirichlet_stencil as j_apply_dirichlet
from tpufem.solve.poisson import model_problem_3d_planes as j_f

from tpufem_torch.assemble.structured import structured_plan
from tpufem_torch.dist.assembly import (build_poisson_system_sharded,
                                        solve_poisson_dist_general)
from tpufem_torch.dist.mesh import make_mesh
from tpufem_torch.fem.quadrature import tetrahedron_rule
from tpufem_torch.ops import fused_system_cuda as fsc
from tpufem_torch.solve.multigrid import _light_grid
from tpufem_torch.solve.poisson import model_problem_3d_planes

# several pytest workers share the CPU: one intra-op thread each keeps
# the many small tensor ops from oversubscribing it
torch.set_num_threads(1)


def _perturbed(n, dtype=np.float64, seed=0, jitter=0.15):
    """(plan, coords grid [3, *ng], C_emb [3, *store_grid]) of the port."""
    info, coords_grid, bc_grid = _light_grid((-3.0, 3.0), n, 3)
    plan = structured_plan(info, embed=True)
    rng = np.random.default_rng(seed)
    h = 6.0 / n
    pert = rng.uniform(-jitter * h, jitter * h, size=coords_grid.shape)
    interior = ~np.broadcast_to(bc_grid, coords_grid.shape)
    coords = coords_grid + np.where(interior, pert, 0.0)
    C = fsc.node_coords_embedded_from_grid(coords, plan, dtype)
    return plan, coords, torch.as_tensor(C)


def _xla_system(n, coords, rule_degree=2):
    """The JAX package's XLA build (element coordinates, structured
    assembly, Dirichlet elimination; pinned to its fused kernel by
    tests/test_embedded_pipeline.py) on the same perturbed nodes."""
    mesh = j_box_mesh(-3, 3, -3, 3, -3, 3, n, n, n)
    mesh = dataclasses.replace(
        mesh, coords=np.moveaxis(coords, 0, -1).reshape(-1, 3))
    plan = j_structured_plan(mesh, embed=True)
    X = jnp.asarray(element_coords_bt(mesh, np.float64))
    A = assemble_stencil_structured_bt(plan, p1_stiffness_bt(X,
                                                             "tetrahedron"))
    b = assemble_vector_structured_bt(plan, element_load_bt(
        X, "tetrahedron", j_tetrahedron_rule(rule_degree), j_f()))
    bc = plan.embed_field(jnp.asarray(mesh.node_flags != 0), fill=False)
    A, b = j_apply_dirichlet(A, b, bc)
    return plan, np.asarray(A.data), np.asarray(b)


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_stripes_equal_the_whole_build(shards, dtype):
    # n = 14: store z 24, stripes of 24 / 12 / 6 / 3 planes
    plan, _, C = _perturbed(14, dtype)
    f, rule = model_problem_3d_planes(), tetrahedron_rule(2)
    before = fsc.build_poisson_stripe.launches
    data, rhs = build_poisson_system_sharded(
        plan, C, make_mesh(shards, ("z",), device="cpu"), f, rule)
    A, b = fsc.build_poisson_system_plain(plan, C, f, rule)
    # bit for bit: every element's values reach a row in the same order
    assert torch.equal(data.unshard(), A.data)
    assert torch.equal(rhs.unshard(), b)
    assert all(s.shape == (plan.width, plan.num_store_rows // shards)
               for s in data.shards)
    # on CPU tensors the wrapper runs the plain version, no kernel
    assert fsc.build_poisson_stripe.launches == before


def test_whole_build_matches_the_xla_formulation():
    n = 14
    plan, coords, C = _perturbed(n)
    data, rhs = build_poisson_system_sharded(
        plan, C, make_mesh(8, ("z",), device="cpu"),
        model_problem_3d_planes(), tetrahedron_rule(2))
    jplan, A, b = _xla_system(n, coords)
    assert tuple(jplan.store_grid) == tuple(plan.store_grid)
    assert tuple(jplan.offsets) == tuple(plan.offsets)
    # fp64: within 1e-12 of max|.|
    assert np.abs(data.unshard().numpy() - A).max() <= 1e-12 * np.abs(A).max()
    assert np.abs(rhs.unshard().numpy() - b).max() <= 1e-12 * np.abs(b).max()


def test_sharded_build_matches_jax_interpret(cpu_devices):
    """Against the reference's own sharded build (its Pallas kernel in
    interpret mode) at n = 6 (store z 16), 2 shards, fp64."""
    plan, _, C = _perturbed(6)
    jplan = j_structured_plan(_light_grid_jax(6), embed=True)
    jd, jb = j_build_sharded(jplan, C.numpy(), JaxMesh(
        np.array(cpu_devices[:2]), ("z",)), j_f(), j_tetrahedron_rule(2),
        interpret=True)
    data, rhs = build_poisson_system_sharded(
        plan, C, make_mesh(2, ("z",), device="cpu"),
        model_problem_3d_planes(), tetrahedron_rule(2))
    jd, jb = np.asarray(jd), np.asarray(jb)
    assert np.abs(data.unshard().numpy() - jd).max() \
        <= 1e-12 * np.abs(jd).max()
    assert np.abs(rhs.unshard().numpy() - jb).max() \
        <= 1e-12 * np.abs(jb).max()


def _light_grid_jax(n):
    from tpufem.solve.multigrid import _light_grid as jlg

    return jlg((-3.0, 3.0), n, 3)[0]


def test_pipeline_matches_jax_stencil_cg(cpu_devices):
    """solve_poisson_dist_general at n = 14 (store z 24), 8 shards, fp64,
    against the reference's sharded halo CG on the XLA-built system."""
    n = 14
    plan, coords, C = _perturbed(n)
    u, res = solve_poisson_dist_general(
        plan, C, make_mesh(8, ("z",), device="cpu"),
        model_problem_3d_planes(), tetrahedron_rule(2), tol=1e-8,
        maxiter=2000)
    jplan, A, b = _xla_system(n, coords)
    ref = j_stencil_cg_sharded(jnp.asarray(A), jplan.offsets, jnp.asarray(b),
                               JaxMesh(np.array(cpu_devices[:8]), ("z",)),
                               axis_name="z", tol=1e-8, maxiter=2000)
    assert res.converged and bool(ref.converged)
    assert res.iterations == int(ref.iterations)
    u_ref = np.asarray(jplan.extract_field(ref.x))
    assert np.abs(u - u_ref).max() <= 1e-8 * np.abs(u_ref).max()


def test_store_z_must_divide_by_the_shards():
    plan, _, C = _perturbed(6)                    # store z 16
    with pytest.raises(ValueError, match="not divisible by 3"):
        build_poisson_system_sharded(plan, C, make_mesh(3, ("z",),
                                                        device="cpu"),
                                     model_problem_3d_planes(),
                                     tetrahedron_rule(2))
    # the stripe wrapper checks its extended stripe against the plan
    f, rule = model_problem_3d_planes(), tetrahedron_rule(2)
    with pytest.raises(ValueError, match="expected"):
        fsc.build_poisson_stripe(plan, C[:, :4, :5], 0, f, rule)
    with pytest.raises(ValueError, match="outside the store grid"):
        fsc.build_poisson_stripe(plan, C[:, :4], 15, f, rule)
