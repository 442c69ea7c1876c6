"""Port parity, the weak-form frontend: tpufem_torch.forms (language and
weakform) against the JAX package's WeakForm on the same meshes (float64,
CPU).  Element matrices and vectors of the Poisson, mass, coefficient,
spatial-coordinate, anisotropic, div and elasticity forms, the dense and
ELL assembly and ``integrate`` agree at 1e-12 relative to the largest
entry; chunked evaluation equals unchunked bit for bit."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpufem.fem.space import FunctionSpace as JaxSpace
from tpufem.forms import language as jl
from tpufem.forms import weakform as jwf
from tpufem.mesh.box import box_mesh as jax_box_mesh
from tpufem.mesh.rectangle import rectangle_mesh as jax_rectangle_mesh

from tpufem_torch.fem.space import FunctionSpace
from tpufem_torch.forms import language as tl
from tpufem_torch.forms import weakform as twf
from tpufem_torch.mesh.box import box_mesh
from tpufem_torch.mesh.rectangle import rectangle_mesh

# several pytest workers share the CPU: one intra-op thread each keeps
# the many small tensor ops from oversubscribing it
torch.set_num_threads(1)

_MESHES = {"tri": lambda m: m(-3, 3, -3, 3, 4, 4),
           "tet": lambda m: m(-1, 1, -1, 1, -1, 1, 2, 2, 2)}


def _pair(cell, nc=1):
    """(JAX space, port space) on the same mesh."""
    jm = _MESHES[cell](jax_rectangle_mesh if cell == "tri" else jax_box_mesh)
    tm = _MESHES[cell](rectangle_mesh if cell == "tri" else box_mesh)
    return (JaxSpace(jm, num_components=nc),
            FunctionSpace(tm, num_components=nc))


def _close(a, ref, rtol=1e-12):
    a, ref = np.asarray(a), np.asarray(ref)
    assert a.shape == ref.shape
    assert np.abs(a - ref).max() <= rtol * max(np.abs(ref).max(), 1e-300)


def _f(p):
    """f = 36 - 2(x² + y²): arithmetic that runs on both packages' arrays."""
    return 36.0 - 2.0 * (p[..., 0] ** 2 + p[..., 1] ** 2)


def _sigma(L, d, lam=1.2, mu=0.8):
    def sigma(u):
        eps = L.sym(L.grad(u))
        return lam * L.tr(eps) * L.Identity(d) + 2 * mu * eps
    return sigma


# name -> (cell, components, L, V -> (lhs, rhs)); L is a language module
_FORMS = {
    "poisson": ("tri", 1, lambda L, V: (
        lambda u, v: L.dot(L.grad(u), L.grad(v)), None)),
    "mass": ("tri", 1, lambda L, V: (lambda u, v: u * v, None)),
    "spatial_coordinate": ("tri", 1, lambda L, V: (None, lambda v: (
        36 - 2 * (L.SpatialCoordinate(V)[0] * L.SpatialCoordinate(V)[0]
                  + L.SpatialCoordinate(V)[1] ** 2)) * v)),
    "coefficient": ("tri", 1, lambda L, V: (
        None, lambda v: L.Coefficient(_f) * v)),
    "anisotropic": ("tri", 1, lambda L, V: (
        lambda u, v: (1 + L.SpatialCoordinate(V)[0] ** 2)
        * L.dot(L.grad(u), L.grad(v)), None)),
    "div": ("tri", 2, lambda L, V: (
        lambda u, v: L.div(u) * L.div(v), None)),
    "outer": ("tri", 2, lambda L, V: (
        lambda u, v: L.inner(L.outer(u, v), L.Identity(2)), None)),
    "elasticity_2d": ("tri", 2, lambda L, V: (
        lambda u, v: L.inner(_sigma(L, 2)(u), L.sym(L.grad(v))),
        lambda v: L.dot(L.Coefficient(
            lambda p: _stack(L)([0 * p[..., 0] + 1.0, p[..., 1]]), rank=1),
            v))),
    "elasticity_3d": ("tet", 3, lambda L, V: (
        lambda u, v: L.inner(_sigma(L, 3)(u), L.sym(L.grad(v))),
        lambda v: L.dot(L.Coefficient(
            lambda p: _stack(L)([p[..., 2], 0 * p[..., 0] - 0.5,
                                 p[..., 0] * p[..., 1]]), rank=1), v))),
    "dot_of_tensors": ("tet", 3, lambda L, V: (
        lambda u, v: L.inner(L.dot(L.grad(u), L.grad(v)), L.Identity(3)),
        None)),
}


def _stack(L):
    if L is jl:
        return lambda parts: jnp.stack(parts, axis=-1)
    return lambda parts: torch.stack(parts, dim=-1)


def _forms(name):
    cell, nc, make = _FORMS[name]
    jV, tV = _pair(cell, nc)
    jf = jwf.WeakForm(jV).build(*make(jl, jV))
    tf = twf.WeakForm(tV, device="cpu").build(*make(tl, tV))
    return jf, tf, tV


def _set_chunk(monkeypatch, wf, n):
    """Make ``chunk_elements`` give ``n`` elements per evaluation."""
    V = wf.space
    per_element = (V.local_dofs ** 2 * wf.quadrature.num_points
                   * V.mesh.dim ** 2
                   * torch.empty((), dtype=wf.dtype).element_size())
    monkeypatch.setattr(twf, "_CHUNK_BYTES", n * per_element)
    assert twf.chunk_elements(V, wf.quadrature, wf.dtype) == n


@pytest.mark.parametrize("name", sorted(_FORMS))
def test_element_kernels_match_jax(name, monkeypatch):
    jf, tf, tV = _forms(name)
    ec = tV.mesh.element_coords()
    if tf.lhs_expr is not None:
        Ke = tf.element_matrices(torch.as_tensor(ec))
        assert Ke.shape == (tV.mesh.num_elements,) + (tV.local_dofs,) * 2
        _close(Ke.numpy(), jf.element_matrices(jnp.asarray(ec)))
    if tf.rhs_expr is not None:
        be = tf.element_vectors(torch.as_tensor(ec))
        _close(be.numpy(), jf.element_vectors(jnp.asarray(ec)))
    # chunks of 3 and 5 elements give the same bits
    _set_chunk(monkeypatch, tf, 3)
    if tf.lhs_expr is not None:
        assert torch.equal(Ke, tf.element_matrices(torch.as_tensor(ec)))
    _set_chunk(monkeypatch, tf, 5)
    if tf.rhs_expr is not None:
        assert torch.equal(be, tf.element_vectors(torch.as_tensor(ec)))


@pytest.mark.parametrize("fmt", ["dense", "ell", "stencil"])
@pytest.mark.parametrize("name", ["elasticity_2d", "elasticity_3d",
                                  "anisotropic"])
def test_assemble_matches_jax(name, fmt):
    jf, tf, tV = _forms(name)
    if tf.rhs_expr is None:
        X = tl.SpatialCoordinate(tV)
        tf.build(rhs=lambda v: (1 + X[1]) * v)
        jX = jl.SpatialCoordinate(None)
        jf.build(rhs=lambda v: (1 + jX[1]) * v)
    if fmt == "stencil" and tV.num_components > 1:
        # the stencil format takes P1 scalar spaces only, in both packages
        for wf in (tf, jf):
            with pytest.raises(ValueError, match="scalar"):
                wf.assemble(format=fmt)
        return
    A, b = tf.assemble(format=fmt)
    jA, jb = jf.assemble(format=fmt)
    _close(b.numpy(), jb)
    if fmt == "dense":
        _close(A.numpy(), jA)
    elif fmt == "stencil":
        assert A.offsets == jA.offsets
        _close(A.data.numpy(), jA.data)
    else:
        np.testing.assert_array_equal(A.cols.numpy(), np.asarray(jA.cols))
        np.testing.assert_array_equal(A.diag_pos.numpy(),
                                      np.asarray(jA.diag_pos))
        _close(A.data.numpy(), jA.data)


def test_integrate_and_function_match_jax():
    """∫u and ∫|grad u|² of u = x + 2y on the unit square (1.5 and 5), and
    a vector Function's value and gradient inside a form."""
    jm, tm = (m(0, 1, 0, 1, 4, 4) for m in (jax_rectangle_mesh,
                                            rectangle_mesh))
    jV, tV = JaxSpace(jm), FunctionSpace(tm)
    vals = tm.coords[:, 0] + 2 * tm.coords[:, 1]
    tu = twf.Function(tV, torch.as_tensor(vals))
    ju = jwf.Function(jV, jnp.asarray(vals))
    total = twf.integrate(tV, tu, device="cpu")
    energy = twf.integrate(tV, tl.dot(tl.grad(tu), tl.grad(tu)),
                           device="cpu")
    np.testing.assert_allclose(total.item(), 1.5, rtol=1e-12)
    np.testing.assert_allclose(energy.item(), 5.0, rtol=1e-12)
    _close(total.item(), float(jwf.integrate(jV, ju)))
    # a vector Function u = (x y, x - y) in a linear form
    jW, tW = JaxSpace(jm, num_components=2), FunctionSpace(tm,
                                                           num_components=2)
    w = np.stack([tm.coords[:, 0] * tm.coords[:, 1],
                  tm.coords[:, 0] - tm.coords[:, 1]], 1).reshape(-1)
    tw, jw = twf.Function(tW, torch.as_tensor(w)), jwf.Function(jW,
                                                                jnp.asarray(w))
    tf = twf.WeakForm(tW, device="cpu").build(
        rhs=lambda v: tl.inner(tl.grad(tw), tl.grad(v)) + tl.dot(tw, v))
    jf = jwf.WeakForm(jW).build(
        rhs=lambda v: jl.inner(jl.grad(jw), jl.grad(v)) + jl.dot(jw, v))
    ec = tm.element_coords()
    _close(tf.element_vectors(torch.as_tensor(ec)).numpy(),
           jf.element_vectors(jnp.asarray(ec)))


def test_chunk_rule_and_unported_parts():
    _, tV = _pair("tri", 2)
    wf = twf.WeakForm(tV, dtype=torch.float32, device="cpu")
    # 6 x 6 local DOFs, 7 points, 2 x 2 values, 4 bytes: 4032 per element
    assert twf.chunk_elements(tV, wf.quadrature, torch.float32) == \
        twf._CHUNK_BYTES // 4032
    with pytest.raises(NotImplementedError, match="A3"):
        wf.build_boundary(rhs=lambda v: v[0])
    with pytest.raises(NotImplementedError, match="A3"):
        twf.integrate_boundary(tV, tl.Constant(1.0))
    wf.build(lambda u, v: tl.inner(tl.grad(u), tl.grad(v)))
    with pytest.raises(ValueError, match="format"):
        wf.assemble(format="coo")
    with pytest.raises(ValueError, match="lhs"):
        twf.WeakForm(tV, device="cpu").element_matrices(
            torch.zeros((1, 3, 2)))
    with pytest.raises(ValueError, match="rank"):
        tl.inner(tl.grad(tl.TrialFunction(tV)), tl.TestFunction(tV))
    with pytest.raises(ValueError, match="FacetNormal"):
        tl.FacetNormal(tV).evaluate(object())


def test_stencil_format_matches_jax():
    """The shift-invariant stencil assembly of the weak form against the
    JAX package's (tests/test_weakform.py's 5^3 box): the operator on a
    random vector and b at 1e-12, and against the port's own ELL
    assembly; an unstructured mesh is rejected."""
    from tpufem.mesh.rectangle import perturbed_rectangle_mesh as jax_pert

    from tpufem_torch.mesh.rectangle import perturbed_rectangle_mesh

    args = (-3, 3, -3, 3, -3, 3, 5, 5, 5)
    jV, tV = JaxSpace(jax_box_mesh(*args)), FunctionSpace(box_mesh(*args))

    def f(X):
        return 36 - 2 * (X[0] ** 2 + X[1] ** 2 + X[2] ** 2)

    jX, tX = jl.SpatialCoordinate(jV), tl.SpatialCoordinate(tV)
    jf = jwf.WeakForm(jV).build(lambda u, v: jl.dot(jl.grad(u), jl.grad(v)),
                                lambda v: f(jX) * v)
    tf = twf.WeakForm(tV, device="cpu").build(
        lambda u, v: tl.dot(tl.grad(u), tl.grad(v)), lambda v: f(tX) * v)
    A, b = tf.assemble(format="stencil")
    jA, jb = jf.assemble(format="stencil")
    assert A.offsets == jA.offsets and A.data.shape == (15, tV.num_dofs)
    x = np.random.default_rng(0).standard_normal(tV.num_dofs)
    ref = np.asarray(jA.matvec(jnp.asarray(x)))
    _close(A.matvec(torch.as_tensor(x)).numpy(), ref)
    _close(b.numpy(), jb)
    A_ell, b_ell = tf.assemble(format="ell")
    _close(A_ell.matvec(torch.as_tensor(x)).numpy(), ref)
    assert torch.equal(b, b_ell)
    for wf in (twf.WeakForm(FunctionSpace(perturbed_rectangle_mesh(
            -1, 1, -1, 1, 4, 4, seed=0)), device="cpu"),
               jwf.WeakForm(JaxSpace(jax_pert(-1, 1, -1, 1, 4, 4, seed=0)))):
        wf.build(lambda u, v: u * v)
        with pytest.raises(ValueError, match="structured"):
            wf.assemble(format="stencil")


def test_weakform_entry_defaults_to_the_card():
    import inspect

    for entry in (twf.WeakForm, twf.integrate):
        assert inspect.signature(entry).parameters["device"].default \
            == "cuda"
