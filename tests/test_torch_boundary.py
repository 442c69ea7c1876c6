"""Port parity, boundary (facet) terms: tpufem_torch.fem.facets and the
boundary parts of forms.weakform against the JAX package's (float64, CPU,
the same numpy meshes).  Facets, their DOF maps, quadrature points,
surface Jacobians and outward normals are equal bit for bit (2D, 3D, P1,
P2, quads; hexes raise as in the JAX package); Neumann, Robin and traction
terms and the dense, ELL and stencil formats agree at 1e-12;
integrate_boundary gives the JAX package's values; the quad Neumann solve
reproduces u = x; the boundary slot scatter repeats bit for bit."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpufem.fem import facets as jfacets
from tpufem.fem.space import FunctionSpace as JaxSpace
from tpufem.forms import language as jl
from tpufem.forms import weakform as jwf
from tpufem.mesh.box import box_hex_mesh as jax_box_hex_mesh
from tpufem.mesh.box import box_mesh as jax_box_mesh
from tpufem.mesh.rectangle import perturbed_quad_mesh as jax_quad_mesh
from tpufem.mesh.rectangle import perturbed_rectangle_mesh as jax_perturbed
from tpufem.mesh.rectangle import rectangle_mesh as jax_rectangle_mesh
from tpufem.solve.bc import apply_dirichlet_ell as jax_bc_ell

from tpufem_torch.fem import facets
from tpufem_torch.fem.quadrature import rule_for_cell
from tpufem_torch.fem.space import FunctionSpace
from tpufem_torch.forms import language as tl
from tpufem_torch.forms import weakform as twf
from tpufem_torch.mesh.box import box_hex_mesh, box_mesh
from tpufem_torch.mesh.rectangle import (perturbed_quad_mesh,
                                         perturbed_rectangle_mesh,
                                         rectangle_mesh)
from tpufem_torch.solve.bc import apply_dirichlet_ell
from tpufem_torch.solve.cg import cg

torch.set_num_threads(1)

_MESHES = {
    "tri": (lambda m: m(-3, 3, -3, 3, 5, 4), jax_rectangle_mesh,
            rectangle_mesh),
    "perturbed": (lambda m: m(-3, 3, -3, 3, 5, 4, jitter=0.2, seed=4),
                  jax_perturbed, perturbed_rectangle_mesh),
    "tet": (lambda m: m(-3, 3, -3, 3, -3, 3, 2, 3, 2), jax_box_mesh,
            box_mesh),
    "quad": (lambda m: m(0, 2, 0, 1, 5, 4, jitter=0.2, seed=1),
             jax_quad_mesh, perturbed_quad_mesh),
}


def _meshes(name):
    make, jm, tm = _MESHES[name]
    return make(jm), make(tm)


def _staged(fn, *args):
    """fn(*args) under jax.jit: the JAX package's weak form, called
    eagerly, compiles each of its many small ops on first use (seconds a
    form on the CPU); staged it is the same program on the same inputs."""
    return jax.jit(fn)(*args)


def _close(a, ref, rtol=1e-12):
    a, ref = np.asarray(a), np.asarray(ref)
    assert a.shape == ref.shape, (a.shape, ref.shape)
    assert np.abs(a - ref).max() <= rtol * max(np.abs(ref).max(), 1e-300)


_CASES = [("tri", 1), ("tri", 2), ("perturbed", 1), ("perturbed", 2),
          ("tet", 1), ("tet", 2), ("quad", 1)]


@pytest.mark.parametrize("name,degree", _CASES,
                         ids=[f"{n}-p{d}" for n, d in _CASES])
def test_facets_and_geometry_equal_jax(name, degree):
    jm, tm = _meshes(name)
    jf, tf = jfacets.boundary_facets(jm), facets.boundary_facets(tm)
    np.testing.assert_array_equal(tf.conn, jf.conn)
    np.testing.assert_array_equal(tf.opposite, jf.opposite)
    assert tf.cell_type == jf.cell_type and tf.num_facets == jf.num_facets
    np.testing.assert_array_equal(
        facets.facet_dof_conn(FunctionSpace(tm, degree=degree), tf),
        jfacets.facet_dof_conn(JaxSpace(jm, degree=degree), jf))
    rule = rule_for_cell(tf.cell_type, 2 * degree + 1)
    for a, b in zip(facets.facet_geometry(tm.coords, tf, rule),
                    jfacets.facet_geometry(jm.coords, jf, rule)):
        np.testing.assert_array_equal(a, b)
    _, detS, n = facets.facet_geometry(tm.coords, tf, rule)
    np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-14)
    # the measure of the boundary: the rectangle's perimeter, the box's
    # surface
    if name != "quad":
        total = detS.sum() * (0.5 if tf.cell_type == "triangle" else 1.0)
        assert abs(total - (24.0 if tm.dim == 2 else 216.0)) < 1e-11


def test_hex_facets_raise_as_jax():
    for make, m in ((jfacets.boundary_facets, jax_box_hex_mesh),
                    (facets.boundary_facets, box_hex_mesh)):
        with pytest.raises(NotImplementedError, match="hex"):
            make(m(0, 1, 0, 1, 0, 1, 2, 2, 2))


def _f(p):
    return 36.0 - 2.0 * (p[..., 0] ** 2 + p[..., 1] ** 2)


def _forms(L, V, where):
    """(volume, boundary) builders of a Robin + Neumann Poisson form."""
    g = L.Coefficient(lambda p: 1.0 + 0.5 * p[..., 0] - p[..., 1] ** 2)

    def build(wf):
        wf.build(lambda u, v: L.dot(L.grad(u), L.grad(v)),
                 lambda v: L.Coefficient(_f) * v)
        wf.build_boundary(lhs=lambda u, v: 2.5 * u * v,
                          rhs=lambda v: g * v, where=where)
        return wf

    return build


_WHERE = {"all": None,
          "top": lambda c: c[:, 1] > c[:, 1].max() - 1e-9}
_TERMS = [("perturbed", 1, "all"), ("perturbed", 2, "top"),
          ("tet", 2, "top"), ("quad", 1, "top")]


@pytest.mark.parametrize("name,degree,where", _TERMS,
                         ids=[f"{n}-p{d}-{w}" for n, d, w in _TERMS])
def test_robin_neumann_terms_equal_jax(name, degree, where):
    jm, tm = _meshes(name)
    jV, tV = JaxSpace(jm, degree=degree), FunctionSpace(tm, degree=degree)
    jw = _forms(jl, jV, _WHERE[where])(jwf.WeakForm(jV))
    tw = _forms(tl, tV, _WHERE[where])(twf.WeakForm(tV, device="cpu"))
    _close(tw.boundary_element_matrices().numpy(),
           _staged(jw.boundary_element_matrices))
    _close(tw.boundary_element_vectors().numpy(),
           _staged(jw.boundary_element_vectors))
    A, b = tw.assemble(format="ell")
    jA, jb = _staged(lambda: jw.assemble(format="ell"))
    _close(A.to_dense().numpy(), np.asarray(_staged(jA.to_dense)))
    _close(b.numpy(), jb)


def test_three_formats_agree_with_jax():
    """tests/test_boundary.py::test_boundary_formats_agree in both
    packages (on a smaller mesh): dense, ELL and stencil assembly of a
    Robin form."""
    jm, tm = (m(-3, 3, -3, 3, 5, 4) for m in (jax_rectangle_mesh,
                                              rectangle_mesh))
    jV, tV = JaxSpace(jm), FunctionSpace(tm)

    def build(L, wf):
        wf.build(lambda u, v: L.dot(L.grad(u), L.grad(v)),
                 lambda v: L.Coefficient(_f) * v)
        wf.build_boundary(lhs=lambda u, v: 2.5 * u * v,
                          rhs=lambda v: L.Constant(1.0) * v)
        return wf

    out = {}
    for fmt in ("dense", "ell", "stencil"):
        A, b = build(tl, twf.WeakForm(tV, device="cpu")).assemble(format=fmt)
        jA, jb = build(jl, jwf.WeakForm(jV)).assemble(format=fmt)
        dense = A if fmt == "dense" else A.to_dense()
        _close(dense.numpy(), np.asarray(jA if fmt == "dense"
                                         else jA.to_dense()))
        _close(b.numpy(), jb)
        out[fmt] = dense
    torch.testing.assert_close(out["ell"], out["dense"], rtol=1e-14,
                               atol=1e-13)
    torch.testing.assert_close(out["stencil"], out["dense"], rtol=1e-14,
                               atol=1e-13)


def test_stencil_boundary_outside_raises_as_jax():
    """A boundary coupling the stencil does not hold raises in both
    packages (a facet 'segment' across the diagonal the split lacks)."""
    tm = rectangle_mesh(0, 1, 0, 1, 2, 2)
    wf = twf.WeakForm(FunctionSpace(tm), device="cpu").build(
        lambda u, v: tl.dot(tl.grad(u), tl.grad(v)))
    wf.build_boundary(lhs=lambda u, v: u * v)
    odd = facets.BoundaryFacets(np.array([[0, 8]], np.int32),
                                np.array([4], np.int32), "segment")
    real = facets.boundary_facets
    try:
        facets_mod = twf
        facets_mod.boundary_facets = lambda mesh: odd
        with pytest.raises(RuntimeError, match="outside the stencil"):
            wf.assemble(format="stencil")
    finally:
        twf.boundary_facets = real


def test_traction_resultant_and_integrals_equal_jax():
    from tpufem.forms.language import Constant as JConstant

    jm, tm = (m(0, 2, 0, 1, 5, 4) for m in (jax_rectangle_mesh,
                                            rectangle_mesh))
    jV, tV = JaxSpace(jm, num_components=2), FunctionSpace(tm,
                                                           num_components=2)
    top = lambda c: c[:, 1] > 1 - 1e-9
    tw = twf.WeakForm(tV, device="cpu").build_boundary(
        rhs=lambda v: tl.dot(tl.Constant(np.array([0.5, -1.25])), v),
        where=top)
    jw = jwf.WeakForm(jV).build_boundary(
        rhs=lambda v: jl.dot(JConstant(np.array([0.5, -1.25])), v),
        where=top)
    from tpufem.assemble.dense import assemble_vector as jax_vector

    from tpufem_torch.assemble.dense import assemble_vector

    setup, jsetup = tw._facet_setup(), jw._facet_setup()
    b = assemble_vector(tw._expanded_facet_dofs(setup[1]),
                        tw.boundary_element_vectors(setup), tV.num_dofs)
    jb = _staged(lambda: jax_vector(jw._expanded_facet_dofs(jsetup[1]),
                                    jw.boundary_element_vectors(jsetup),
                                    jV.num_dofs))
    _close(b.numpy(), jb)
    np.testing.assert_allclose(b.numpy().reshape(-1, 2).sum(0),
                               [1.0, -2.5], rtol=1e-12)
    # integrate_boundary: perimeter, a filtered edge, x^2, n . x
    sV, jsV = FunctionSpace(tm), JaxSpace(jm)
    X, jX = tl.SpatialCoordinate(sV), jl.SpatialCoordinate(jsV)
    for expr, jexpr, kw in (
            (tl.Constant(1.0), jl.Constant(1.0), {}),
            (tl.Constant(1.0), jl.Constant(1.0), dict(where=top)),
            (X[0] * X[0], jX[0] * jX[0], {}),
            (tl.dot(tl.FacetNormal(sV), X), jl.dot(jl.FacetNormal(jsV), jX),
             {})):
        got = twf.integrate_boundary(sV, expr, device="cpu", **kw)
        ref = _staged(lambda: jwf.integrate_boundary(jsV, jexpr, **kw))
        assert abs(got.item() - float(ref)) <= 1e-12 * abs(float(ref))
    # the divergence theorem: int n . x ds = 2 |Omega| = 4
    assert abs(got.item() - 4.0) < 1e-12


def test_quad_neumann_exact_flux():
    """tests/test_quad_hex.py's case on the port: -Δu = 0 with u = 0 on
    x = 0 and du/dn = 1 on x = 1 reproduces u = x; the eliminated
    system is the JAX package's."""
    jm, tm = (m(0, 1, 0, 1, 5, 4, jitter=0.2, seed=2, renumber=False)
              for m in (jax_quad_mesh, perturbed_quad_mesh))
    results = []
    for L, wf, mesh, bc in (
            (tl, twf.WeakForm(FunctionSpace(tm), device="cpu"), tm,
             apply_dirichlet_ell),
            (jl, jwf.WeakForm(JaxSpace(jm)), jm, jax_bc_ell)):
        wf.build(lambda u, v: L.dot(L.grad(u), L.grad(v)))
        wf.build_boundary(rhs=lambda v: 1.0 * v,
                          where=lambda c: c[:, 0] > 1.0 - 1e-9)
        mask = mesh.coords[:, 0] < 1e-12
        if L is tl:
            A, b = wf.assemble(format="ell")
            A, b = bc(A, b, torch.as_tensor(mask))
            res = cg(A.matvec, b, tol=1e-13, maxiter=2000)
            assert res.converged
            results.append(res.x.numpy())
            system = (A, b)
        else:
            A, b = _staged(lambda: bc(*wf.assemble(format="ell"),
                                      jnp.asarray(mask)))
            results += [(A, b), system]
    np.testing.assert_allclose(results[0], tm.coords[:, 0], atol=1e-9)
    jA, jb = results[1]
    A, b = results[2]
    _close(A.to_dense().numpy(), np.asarray(_staged(jA.to_dense)))
    _close(b.numpy(), jb)


def test_boundary_slot_scatter_repeats_bit_for_bit():
    """The ELL boundary slots are added by a sorted accumulating scatter:
    two assemblies are equal bit for bit, and equal the dense format's."""
    tm = box_mesh(-1, 1, -1, 1, -1, 1, 3, 3, 3)
    V = FunctionSpace(tm, degree=2)
    build = _forms(tl, V, None)
    A1, b1 = build(twf.WeakForm(V, device="cpu")).assemble(format="ell")
    A2, b2 = build(twf.WeakForm(V, device="cpu")).assemble(format="ell")
    assert torch.equal(A1.data, A2.data) and torch.equal(b1, b2)
    Ad, _ = build(twf.WeakForm(V, device="cpu")).assemble(format="dense")
    torch.testing.assert_close(A1.to_dense(), Ad, rtol=1e-13, atol=1e-13)
