"""Port parity, generic structured assembly: structured_plan on a mesh, the
shift-invariant stencil and vector assembly, the batch-trailing element
kernels, the embedded element coordinates and kernel B13's plain version
(``assemble_stencil_cuda`` on CPU tensors) against the JAX package on the
CPU in float64.  B13's plain version is held to the Pallas kernel itself,
run in interpret mode."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpufem.assemble.local import p1_stiffness as jax_p1_stiffness
from tpufem.assemble import planar as jplanar
from tpufem.assemble import structured as jst
from tpufem.fem.elements import P1Tetrahedron as JaxTet
from tpufem.fem.elements import P1Triangle as JaxTri
from tpufem.fem.quadrature import tetrahedron_rule as jax_tet_rule
from tpufem.fem.quadrature import triangle_rule as jax_tri_rule
from tpufem.mesh.box import box_mesh as jax_box_mesh
from tpufem.mesh.rectangle import rectangle_mesh as jax_rectangle_mesh
from tpufem.ops.assemble_pallas import (assemble_stencil_pallas,
                                        element_coords_bt_embedded as jax_emb)
from tpufem.solve.poisson import model_problem_2d_planes as jax_f2
from tpufem.solve.poisson import model_problem_3d_planes as jax_f3

from tpufem_torch.assemble import planar
from tpufem_torch.assemble import structured as st
from tpufem_torch.assemble.local import p1_stiffness
from tpufem_torch.fem.elements import P1Tetrahedron, P1Triangle
from tpufem_torch.fem.quadrature import tetrahedron_rule, triangle_rule
from tpufem_torch.mesh.box import box_mesh
from tpufem_torch.mesh.core import Mesh
from tpufem_torch.mesh.rectangle import (perturbed_rectangle_mesh,
                                         rectangle_mesh)
from tpufem_torch.ops import assemble_cuda
from tpufem_torch.solve.poisson import (model_problem_2d_planes,
                                        model_problem_3d_planes)

# several pytest workers share the CPU: one intra-op thread each keeps
# the many small tensor ops from oversubscribing it
torch.set_num_threads(1)

# name -> (mesh arguments, cell, port element, JAX element, port rule,
# JAX rule, port f, JAX f); the 3D box is non-cubic, so a swapped or
# shifted axis cannot hide
_CASES = {
    "tri": ((-3, 2, 0, 1, 5, 4), "triangle", P1Triangle, JaxTri,
            triangle_rule(2), jax_tri_rule(2), model_problem_2d_planes(),
            jax_f2()),
    "tet": ((-1, 2, 0, 1, -2, 0, 5, 4, 6), "tetrahedron", P1Tetrahedron,
            JaxTet, tetrahedron_rule(3), jax_tet_rule(3),
            model_problem_3d_planes(), jax_f3()),
}


def _meshes(name):
    args = _CASES[name][0]
    if len(args) == 6:
        return jax_rectangle_mesh(*args), rectangle_mesh(*args)
    return jax_box_mesh(*args), box_mesh(*args)


def _close(a, ref, rtol=1e-12):
    a, ref = np.asarray(a), np.asarray(ref)
    assert a.shape == ref.shape
    assert np.abs(a - ref).max() <= rtol * max(np.abs(ref).max(), 1e-300)


def test_structured_plan_takes_a_mesh():
    m = box_mesh(-1, 2, 0, 1, -2, 0, 5, 4, 6)
    for embed in (False, True):
        a = st.structured_plan(m, embed=embed)
        b = st.structured_plan(m.structured, embed=embed)
        assert (a.offsets, a.store_grid, a.offsets_grid) == \
            (b.offsets, b.store_grid, b.offsets_grid)
        assert np.array_equal(a.entry_k, b.entry_k)
        assert np.array_equal(a.entry_shift, b.entry_shift)
    unstructured = perturbed_rectangle_mesh(-1, 1, -1, 1, 3, 3, seed=0)
    bare = Mesh(m.coords, m.conn, m.node_flags, cell_type="tetrahedron")
    for mesh in (unstructured, bare, None):
        with pytest.raises(ValueError, match="structured-grid metadata"):
            st.structured_plan(mesh)


@pytest.mark.parametrize("embed", [False, True])
@pytest.mark.parametrize("name", sorted(_CASES))
def test_structured_assembly_matches_jax(name, embed):
    jm, tm = _meshes(name)
    _, cell, Tel, Jel, rule, jrule, f, jf = _CASES[name]
    jp, tp = jst.structured_plan(jm, embed=embed), st.structured_plan(
        tm, embed=embed)
    assert tp.offsets == jp.offsets and tp.store_grid == jp.store_grid
    ec = tm.element_coords()
    Ke = p1_stiffness(torch.as_tensor(ec), Tel())
    jKe = jax_p1_stiffness(jnp.asarray(ec), Jel())
    A = st.assemble_stencil_structured(tp, Ke)
    jA = jst.assemble_stencil_structured(jp, jKe)
    assert A.offsets == jA.offsets
    _close(A.data.numpy(), jA.data)
    rng = np.random.default_rng(3)
    be = rng.standard_normal((tm.num_elements, tm.nodes_per_element))
    _close(st.assemble_vector_structured(tp, torch.as_tensor(be)).numpy(),
           jst.assemble_vector_structured(jp, jnp.asarray(be)))

    # the batch-trailing host kernels
    X = planar.element_coords_bt(tm, np.float64)
    jX = jplanar.element_coords_bt(jm, np.float64)
    np.testing.assert_array_equal(X, jX)
    assert planar.element_coords_bt(tm).dtype == np.float32
    Xt = torch.as_tensor(X)
    Ke_bt = planar.p1_stiffness_bt(Xt, cell)
    _close(Ke_bt.numpy(), jplanar.p1_stiffness_bt(jnp.asarray(jX), cell))
    be_bt = planar.element_load_bt(Xt, cell, rule, f)
    _close(be_bt.numpy(),
           jplanar.element_load_bt(jnp.asarray(jX), cell, jrule, jf))
    _close(st.assemble_stencil_structured_bt(tp, Ke_bt).data.numpy(),
           jA.data)
    _close(st.assemble_vector_structured_bt(tp, be_bt).numpy(),
           jst.assemble_vector_structured_bt(
               jp, jplanar.element_load_bt(jnp.asarray(jX), cell, jrule,
                                           jf)))


@pytest.mark.parametrize("name", sorted(_CASES))
def test_stencil_pattern_structured_matches_jax(name):
    jm, tm = _meshes(name)
    p, jp = st.stencil_pattern_structured(tm), jst.stencil_pattern_structured(
        jm)
    np.testing.assert_array_equal(p.offsets, jp.offsets)
    assert (p.diag_k, p.num_rows, p.width) == (jp.diag_k, jp.num_rows,
                                              jp.width)
    assert p.slots is None and p.perm is None and p.sorted_slots is None


def test_views_take_the_reference_arguments():
    """p1_stiffness_views(Xviews, cell_type) and element_load_views(Xviews,
    cell_type, rule, f_planes), as the reference's, on zero-copy views."""
    jm, tm = _meshes("tet")
    info = tm.structured
    grid = np.moveaxis(tm.coords.reshape(*info.node_grid, 3), -1, 0).copy()
    Xv = planar.element_coord_views(torch.as_tensor(grid), info)
    jXv = jplanar.element_coord_views(jnp.asarray(grid), jm.structured)
    _close(planar.p1_stiffness_views(Xv, "tetrahedron").numpy(),
           jplanar.p1_stiffness_views(jXv, "tetrahedron"))
    _close(planar.element_load_views(Xv, "tetrahedron", tetrahedron_rule(3),
                                     model_problem_3d_planes()).numpy(),
           jplanar.element_load_views(jXv, "tetrahedron", jax_tet_rule(3),
                                      jax_f3()))
    with pytest.raises(ValueError, match="cell_type"):
        planar.p1_stiffness_views(Xv, "triangle")


def test_embed_field_fill():
    plan = st.structured_plan(box_mesh(0, 1, 0, 1, 0, 1, 2, 3, 4),
                              embed=True)
    jplan = jst.structured_plan(jax_box_mesh(0, 1, 0, 1, 0, 1, 2, 3, 4),
                                embed=True)
    v = np.arange(plan.info.node_grid[0] * plan.info.node_grid[1]
                  * plan.info.node_grid[2], dtype=np.float64)
    for fill in (0, 7.5):
        e = plan.embed_field(torch.as_tensor(v), fill=fill)
        np.testing.assert_array_equal(
            e.numpy(), np.asarray(jplan.embed_field(jnp.asarray(v),
                                                    fill=fill)))
        np.testing.assert_array_equal(plan.extract_field(e).numpy(), v)
    mask = plan.embed_field(torch.ones(v.shape, dtype=torch.bool))
    assert mask.dtype == torch.bool and int(mask.sum()) == v.size


@pytest.mark.parametrize("dims", [(5, 4, 6), (4, 4, 4)],
                         ids=["box5x4x6", "cube4"])
def test_fused_assembly_matches_pallas(dims):
    """B13's plain version (assemble_stencil_cuda on CPU tensors) against
    the Pallas kernel in interpret mode, and the embedded coordinates
    against the reference's, bit for bit."""
    args = (-1, 2, 0, 1, -2, 0) + dims
    jm, tm = jax_box_mesh(*args), box_mesh(*args)
    jp, tp = jst.structured_plan(jm, embed=True), st.structured_plan(
        tm, embed=True)
    X = assemble_cuda.element_coords_bt_embedded(tm, tp, 2, np.float64)
    jX = jax_emb(jm, jp, 2, np.float64)
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(
        assemble_cuda.element_coords_bt_embedded(tm, tp, dtype=np.float64),
        X)
    before = assemble_cuda.assemble_stencil_cuda.launches
    A = assemble_cuda.assemble_stencil_cuda(tp, torch.as_tensor(X))
    assert assemble_cuda.assemble_stencil_cuda.launches == before
    jA = assemble_stencil_pallas(jp, jnp.asarray(jX), block_lead=2,
                                 interpret=True)
    assert A.offsets == jA.offsets
    np.testing.assert_allclose(A.data.numpy(), np.asarray(jA.data),
                               rtol=1e-12, atol=1e-13)
    # the same planes as the XLA-style assembly of the element matrices
    Ke = p1_stiffness(torch.as_tensor(tm.element_coords()), P1Tetrahedron())
    _close(A.data.numpy(), st.assemble_stencil_structured(tp, Ke).data)


def test_fused_assembly_rejects_what_the_reference_rejects():
    m = box_mesh(0, 1, 0, 1, 0, 1, 2, 2, 2)
    plan = st.structured_plan(m, embed=True)
    X = torch.as_tensor(assemble_cuda.element_coords_bt_embedded(
        m, plan, dtype=np.float64))
    with pytest.raises(ValueError, match="embed=True"):
        assemble_cuda.assemble_stencil_cuda(st.structured_plan(m), X)
    with pytest.raises(ValueError, match="block_lead"):
        assemble_cuda.element_coords_bt_embedded(m, plan, 3)
    with pytest.raises(ValueError, match="X_emb"):
        assemble_cuda.assemble_stencil_cuda(plan, X[:, :, :, :-1])
    m2 = rectangle_mesh(0, 1, 0, 1, 3, 3)
    p2 = st.structured_plan(m2, embed=True)
    with pytest.raises(NotImplementedError, match="3D"):
        assemble_cuda.assemble_stencil_cuda(p2, torch.zeros(
            (2, 3, 2) + p2.store_grid, dtype=torch.float64))
