"""Port parity, the unstructured host layer and assembly: the meshes, the
ELL pattern and its scatter plan, RCM and the node adjacency equal to the
JAX package's; the quadrature rule, the element kernels, ELL / dense /
vector assembly and the ELL and dense Dirichlet elimination at 1e-12
(float64, CPU)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpufem.assemble import dense as jax_dense
from tpufem.assemble import ell as jax_asm
from tpufem.assemble import local as jax_local
from tpufem.fem import elements as jax_elements
from tpufem.fem import quadrature as jax_quad
from tpufem.fem.space import FunctionSpace as JaxSpace
from tpufem.mesh import adjacency as jax_adj
from tpufem.mesh import rectangle as jax_rect
from tpufem.mesh.box import box_mesh as jax_box_mesh
from tpufem.solve import bc as jax_bc

from tpufem_torch.assemble.dense import assemble_dense, assemble_vector
from tpufem_torch.assemble.ell import assemble_ell, ell_values_scatter
from tpufem_torch.assemble.local import (element_load, element_mass,
                                         map_points, p1_stiffness)
from tpufem_torch.fem.elements import element_for_cell, is_affine_cell
from tpufem_torch.fem.quadrature import rule_for_cell, triangle_rule
from tpufem_torch.fem.space import FunctionSpace
from tpufem_torch.mesh import adjacency, rectangle
from tpufem_torch.mesh.core import Mesh
from tpufem_torch.solve.bc import apply_dirichlet_dense, apply_dirichlet_ell
from tpufem_torch.solve.poisson import model_problem_2d, model_problem_3d

# several pytest workers share the CPU: one intra-op thread each keeps
# the many small tensor ops from oversubscribing it
torch.set_num_threads(1)

_MESHES = {
    "rect": lambda m: m.rectangle_mesh(-3.0, 3.0, -2.0, 1.0, 7, 9),
    "unit": lambda m: m.UnitSquareMesh(5, 4),
    "perturbed": lambda m: m.perturbed_rectangle_mesh(
        -3, 3, -3, 3, 12, 10, jitter=0.25, seed=3),
    "perturbed_kept_numbering": lambda m: m.perturbed_rectangle_mesh(
        0, 1, 0, 2, 6, 6, jitter=0.1, seed=5, renumber=False),
}


def _box():
    """The JAX package's Kuhn box mesh at 6 cells a side, as a port Mesh."""
    ref = jax_box_mesh(-3.0, 3.0, -3.0, 3.0, -3.0, 3.0, 6, 6, 6)
    return ref, Mesh(coords=ref.coords, conn=ref.conn,
                     node_flags=ref.node_flags, cell_type="tetrahedron")


def _pair(name):
    if name == "box":
        return _box()
    return _MESHES[name](jax_rect), _MESHES[name](rectangle)


def _close(a, b, rtol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= rtol * max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("name", sorted(_MESHES))
def test_meshes_equal_jax(name):
    ref, mesh = _pair(name)
    for field in ("coords", "conn", "node_flags"):
        a, b = getattr(mesh, field), getattr(ref, field)
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert mesh.cell_type == ref.cell_type
    assert (mesh.dim, mesh.num_nodes, mesh.num_elements,
            mesh.nodes_per_element) == (ref.dim, ref.num_nodes,
                                        ref.num_elements,
                                        ref.nodes_per_element)
    np.testing.assert_array_equal(mesh.element_coords(), ref.element_coords())
    np.testing.assert_array_equal(mesh.boundary_nodes(), ref.boundary_nodes())
    assert (mesh.structured is None) == (ref.structured is None)
    if ref.structured is not None:
        assert mesh.structured.node_grid == ref.structured.node_grid
        np.testing.assert_array_equal(mesh.structured.type_node_offsets,
                                      ref.structured.type_node_offsets)


def test_mesh_validation():
    with pytest.raises(ValueError, match="nodes/element"):
        Mesh(np.zeros((3, 2)), np.zeros((1, 4)), np.zeros(3))
    with pytest.raises(ValueError, match="out of range"):
        Mesh(np.zeros((3, 2)), np.array([[0, 1, 3]]), np.zeros(3))
    with pytest.raises(ValueError):
        rectangle.rectangle_mesh(0, 1, 0, 1, 0, 3)


@pytest.mark.parametrize("with_sort_plan", [True, False])
@pytest.mark.parametrize("name", ["perturbed", "rect", "box"])
def test_ell_pattern_equals_jax(name, with_sort_plan):
    ref_mesh, mesh = _pair(name)
    pad = 16 if name == "box" else 8
    ref = jax_adj.ell_pattern(ref_mesh.conn, ref_mesh.num_nodes, pad_to=pad,
                              with_sort_plan=with_sort_plan)
    pat = adjacency.ell_pattern(mesh.conn, mesh.num_nodes, pad_to=pad,
                                with_sort_plan=with_sort_plan)
    for field in ("cols", "row_lengths", "slots", "diag_pos"):
        a, b = getattr(pat, field), getattr(ref, field)
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype, field
    # without the sort plan the JAX package takes its C++ host library
    # where it is built, which leaves the keys out
    if ref.unique_keys is not None:
        np.testing.assert_array_equal(pat.unique_keys, ref.unique_keys)
    for field in ("perm", "sorted_slots"):
        a, b = getattr(pat, field), getattr(ref, field)
        assert (a is None) == (b is None) == (not with_sort_plan)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert (pat.nnz, pat.num_rows, pat.width) == (ref.nnz, ref.num_rows,
                                                  ref.width)


@pytest.mark.parametrize("name", ["perturbed", "box"])
def test_rcm_and_adjacency_equal_jax(name):
    ref_mesh, mesh = _pair(name)
    cols = adjacency.ell_pattern(mesh.conn, mesh.num_nodes).cols
    perm = adjacency.reverse_cuthill_mckee(cols)
    np.testing.assert_array_equal(
        perm, jax_adj.reverse_cuthill_mckee(cols, use_native=False))
    assert sorted(perm.tolist()) == list(range(mesh.num_nodes))
    for max_length in (None, 32):
        for a, b in zip(adjacency.node_adjacency(mesh.conn, mesh.num_nodes,
                                                 max_length),
                        jax_adj.node_adjacency(ref_mesh.conn,
                                               ref_mesh.num_nodes,
                                               max_length)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def test_quadrature_elements_and_space_equal_jax():
    for deg in (1, 2, 3, 4, 5):
        a, b = triangle_rule(deg), jax_quad.triangle_rule(deg)
        np.testing.assert_array_equal(a.points, b.points)
        np.testing.assert_array_equal(a.weights, b.weights)
        assert a.degree == b.degree
    for cell, deg in (("triangle", 5), ("tetrahedron", 3)):
        a, b = rule_for_cell(cell, deg), jax_quad.rule_for_cell(cell, deg)
        np.testing.assert_array_equal(a.points, b.points)
        np.testing.assert_array_equal(a.weights, b.weights)
    # degree 6 raises in both packages; the tetrahedron's Duffy rule
    # (degree >= 4) is the JAX package's
    for rule in (triangle_rule, jax_quad.triangle_rule):
        with pytest.raises(NotImplementedError):
            rule(6)
    a, b = rule_for_cell("tetrahedron", 4), jax_quad.rule_for_cell(
        "tetrahedron", 4)
    np.testing.assert_array_equal(a.points, b.points)
    np.testing.assert_array_equal(a.weights, b.weights)
    for cell in ("triangle", "tetrahedron"):
        el, ref = element_for_cell(cell), jax_elements.element_for_cell(cell)
        pts = jax_quad.rule_for_cell(cell, 3).points
        np.testing.assert_array_equal(el.shape_values(pts),
                                      ref.shape_values(pts))
        np.testing.assert_array_equal(el.shape_grads(pts),
                                      ref.shape_grads(pts))
        assert (el.cell_type, el.dim, el.num_nodes) == (
            ref.cell_type, ref.dim, ref.num_nodes)
    for cell in ("triangle", "tetrahedron", "quad", "hexahedron"):
        assert is_affine_cell(cell) == jax_elements.is_affine_cell(cell)
    # the P2 triangle (ported) tabulates as the JAX package's
    pts = jax_quad.rule_for_cell("triangle", 3).points
    np.testing.assert_array_equal(
        element_for_cell("triangle", 2).shape_grads(pts),
        jax_elements.element_for_cell("triangle", 2).shape_grads(pts))
    ref_mesh, mesh = _pair("perturbed")
    sp, ref = FunctionSpace(mesh), JaxSpace(ref_mesh)
    np.testing.assert_array_equal(sp.dof_conn, ref.dof_conn)
    np.testing.assert_array_equal(sp.dof_flags, ref.dof_flags)
    np.testing.assert_array_equal(sp.boundary_dofs(), ref.boundary_dofs())
    assert sp.num_dofs == ref.num_dofs and sp.local_dofs == ref.local_dofs
    np.testing.assert_array_equal(sp.default_quadrature().points,
                                  ref.default_quadrature().points)
    # the vector space's node-major DOF arrays, and the P2 space's
    vs, vref = (FunctionSpace(mesh, num_components=2),
                JaxSpace(ref_mesh, num_components=2))
    np.testing.assert_array_equal(vs.dof_conn, vref.dof_conn)
    np.testing.assert_array_equal(vs.dof_flags, vref.dof_flags)
    assert vs.num_dofs == vref.num_dofs and vs.local_dofs == vref.local_dofs
    p2, p2ref = FunctionSpace(mesh, degree=2), JaxSpace(ref_mesh, degree=2)
    np.testing.assert_array_equal(p2.dof_conn, p2ref.dof_conn)
    np.testing.assert_array_equal(p2.dof_flags, p2ref.dof_flags)
    np.testing.assert_array_equal(p2.scalar_dof_coords,
                                  p2ref.scalar_dof_coords)


def _local(name):
    ref_mesh, mesh = _pair(name)
    ec = mesh.element_coords()
    el = element_for_cell(mesh.cell_type)
    rule = rule_for_cell(mesh.cell_type, 5 if mesh.dim == 2 else 3)
    return ref_mesh, mesh, ec, el, rule


@pytest.mark.parametrize("name", ["perturbed", "box"])
def test_element_kernels_match_jax(name):
    ref_mesh, mesh, ec, el, rule = _local(name)
    jel = jax_elements.element_for_cell(mesh.cell_type)
    f = (model_problem_2d() if mesh.dim == 2 else model_problem_3d())[0]
    t, j = torch.as_tensor(ec), jnp.asarray(ec)
    _close(p1_stiffness(t, el).numpy(), jax_local.p1_stiffness(j, jel))
    _close(element_load(t, el, rule, f).numpy(),
           jax_local.element_load(j, jel, rule, f))
    _close(element_mass(t, el, rule).numpy(),
           jax_local.element_mass(j, jel, rule))
    _close(map_points(t, el, rule).numpy(), jax_local.map_points(j, jel, rule))


@pytest.mark.parametrize("method", ["scatter", "sort"])
@pytest.mark.parametrize("name", ["perturbed", "box"])
def test_assembly_and_dirichlet_match_jax(name, method):
    """assemble_ell (scatter and sort), assemble_vector and
    apply_dirichlet_ell (with zero and nonzero boundary data)."""
    ref_mesh, mesh, ec, el, rule = _local(name)
    jel = jax_elements.element_for_cell(mesh.cell_type)
    f = (model_problem_2d() if mesh.dim == 2 else model_problem_3d())[0]
    pat = adjacency.ell_pattern(mesh.conn, mesh.num_nodes,
                                pad_to=8 if mesh.dim == 2 else 16)
    ref_pat = jax_adj.ell_pattern(ref_mesh.conn, ref_mesh.num_nodes,
                                  pad_to=8 if mesh.dim == 2 else 16)
    Ke = p1_stiffness(torch.as_tensor(ec), el)
    be = element_load(torch.as_tensor(ec), el, rule, f)
    jKe = jax_local.p1_stiffness(jnp.asarray(ec), jel)
    jbe = jax_local.element_load(jnp.asarray(ec), jel, rule, f)
    A = assemble_ell(pat, Ke, method=method)
    R = jax_asm.assemble_ell(ref_pat, jKe, method=method)
    _close(A.data.numpy(), R.data)
    np.testing.assert_array_equal(A.cols.numpy(), np.asarray(R.cols))
    np.testing.assert_array_equal(A.diag_pos.numpy(), np.asarray(R.diag_pos))
    if method == "scatter":
        _close(ell_values_scatter(pat.slots, Ke, *pat.cols.shape).numpy(),
               R.data)
    b = assemble_vector(mesh.conn, be, mesh.num_nodes)
    jb = jax_dense.assemble_vector(ref_mesh.conn, jbe, ref_mesh.num_nodes)
    _close(b.numpy(), jb)
    mask = mesh.node_flags != 0
    g = np.random.default_rng(0).standard_normal(mesh.num_nodes)
    for values in (None, g):
        A2, b2 = apply_dirichlet_ell(
            A, b, torch.as_tensor(mask),
            None if values is None else torch.as_tensor(values))
        R2, jb2 = jax_bc.apply_dirichlet_ell(R, jb, jnp.asarray(mask), values)
        _close(A2.data.numpy(), R2.data)
        _close(b2.numpy(), jb2)
    assert A.data.shape == R.data.shape


def test_dense_assembly_and_dirichlet_match_jax():
    ref_mesh, mesh, ec, el, rule = _local("perturbed")
    jel = jax_elements.element_for_cell(mesh.cell_type)
    Ke = p1_stiffness(torch.as_tensor(ec), el)
    jKe = jax_local.p1_stiffness(jnp.asarray(ec), jel)
    A = assemble_dense(mesh.conn, Ke, mesh.num_nodes)
    R = jax_dense.assemble_dense(ref_mesh.conn, jKe, ref_mesh.num_nodes)
    _close(A.numpy(), R)
    b = assemble_vector(mesh.conn, element_load(torch.as_tensor(ec), el, rule,
                                                model_problem_2d()[0]),
                        mesh.num_nodes)
    mask = mesh.node_flags != 0
    A2, b2 = apply_dirichlet_dense(A, b, torch.as_tensor(mask), 2.5)
    R2, jb2 = jax_bc.apply_dirichlet_dense(R, jnp.asarray(b.numpy()),
                                           jnp.asarray(mask), 2.5)
    _close(A2.numpy(), R2)
    _close(b2.numpy(), jb2)
    assert not torch.equal(A, A2)          # the given A is not modified
