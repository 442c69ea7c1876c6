"""Port parity, P2 spaces: tpufem_torch's degree-2 FunctionSpace, its P2
element matrices and the P2 Poisson system against the JAX package's
(float64, CPU, the same numpy meshes).  The DOF arrays, flags and edge
midpoints are equal bit for bit in 2D and 3D; the element matrices and
vectors agree at 1e-12 relative to the largest entry; the RCM-ordered P2
system preconditioned by the greedy strength-0.08 AMG (the JAX package's
amg_systems.p2_system at n = 40) takes the JAX package's PCG count."""
import functools

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from tpufem.fem.space import FunctionSpace as JaxSpace
from tpufem.forms import language as jl
from tpufem.forms import weakform as jwf
from tpufem.mesh.box import box_mesh as jax_box_mesh
from tpufem.mesh.rectangle import perturbed_rectangle_mesh as jax_perturbed
from tpufem.mesh.rectangle import rectangle_mesh as jax_rectangle_mesh

from tpufem_torch.fem.space import FunctionSpace, VectorFunctionSpace
from tpufem_torch.forms import language as tl
from tpufem_torch.forms import weakform as twf
from tpufem_torch.mesh.adjacency import reverse_cuthill_mckee
from tpufem_torch.mesh.box import box_mesh
from tpufem_torch.mesh.rectangle import perturbed_rectangle_mesh
from tpufem_torch.mesh.rectangle import rectangle_mesh
from tpufem_torch.solve.amg import build_amg
from tpufem_torch.solve.bc import apply_dirichlet_ell
from tpufem_torch.solve.cg import cg
from tpufem_torch.sparse.ell import ELLMatrix, reorder_ell

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """One BLAS thread a test, as one torch thread: numpy's OpenBLAS
    threads spin against the other workers on the shared CPU (a 729 x 729
    inverse takes seconds on eight, 0.07 s on one)."""
    with threadpool_limits(1, user_api="blas"):
        yield

_MESHES = {
    "tri": lambda m: m(-3, 3, -3, 3, 5, 4),
    "perturbed": lambda m: m(-3, 3, -3, 3, 6, 6, jitter=0.2, seed=4),
    "tet": lambda m: m(-1, 1, -1, 1, -1, 1, 2, 3, 2),
}
_MAKERS = {"tri": (jax_rectangle_mesh, rectangle_mesh),
           "perturbed": (jax_perturbed, perturbed_rectangle_mesh),
           "tet": (jax_box_mesh, box_mesh)}


def _pair(name, nc=1):
    jm, tm = (_MESHES[name](m) for m in _MAKERS[name])
    return (JaxSpace(jm, degree=2, num_components=nc),
            FunctionSpace(tm, degree=2, num_components=nc))


def _close(a, ref, rtol=1e-12):
    a, ref = np.asarray(a), np.asarray(ref)
    assert a.shape == ref.shape
    assert np.abs(a - ref).max() <= rtol * max(np.abs(ref).max(), 1e-300)


@pytest.mark.parametrize("name", list(_MESHES))
@pytest.mark.parametrize("nc", [1, 2, 3])
def test_p2_dofs_equal_jax(name, nc):
    jV, tV = _pair(name, nc)
    for field in ("scalar_dof_conn", "scalar_dof_flags", "scalar_dof_coords",
                  "dof_conn", "dof_flags"):
        np.testing.assert_array_equal(getattr(tV, field),
                                      getattr(jV, field), err_msg=field)
    assert (tV.num_dofs, tV.num_scalar_dofs, tV.local_dofs) == (
        jV.num_dofs, jV.num_scalar_dofs, jV.local_dofs)
    np.testing.assert_array_equal(tV.boundary_dofs(), jV.boundary_dofs())
    a, b = tV.default_quadrature(), jV.default_quadrature()
    np.testing.assert_array_equal(a.points, b.points)
    np.testing.assert_array_equal(a.weights, b.weights)


def test_vector_p2_space_and_3d_boundary_edges():
    """VectorFunctionSpace(degree=2) (the Stokes velocity space); in 3D an
    edge is a boundary edge iff it lies on a boundary facet: on the box
    its midpoint is on the box's surface."""
    tm = box_mesh(-1, 1, -1, 1, -1, 1, 3, 2, 2)
    V = VectorFunctionSpace(tm, degree=2)
    assert V.num_components == 3 and V.num_dofs == 3 * V.num_scalar_dofs
    on_surface = (np.abs(V.scalar_dof_coords) > 1 - 1e-12).any(axis=1)
    np.testing.assert_array_equal(V.scalar_dof_flags, on_surface)


_FORMS = {
    "poisson": lambda L, V: (lambda u, v: L.dot(L.grad(u), L.grad(v)),
                             lambda v: (36 - 2 * (L.SpatialCoordinate(V)[0]
                                                  ** 2)) * v),
    "mass": lambda L, V: (lambda u, v: u * v,
                          lambda v: L.Constant(1.5) * v),
}


@pytest.mark.parametrize("form", list(_FORMS))
@pytest.mark.parametrize("name", ["perturbed", "tet"])
def test_p2_element_matrices_equal_jax(name, form):
    jV, tV = _pair(name)
    ec = tV.mesh.element_coords()
    lj, rj = _FORMS[form](jl, jV)
    lt, rt = _FORMS[form](tl, tV)
    jf = jwf.WeakForm(jV).build(lj, rj)
    tf = twf.WeakForm(tV, device="cpu").build(lt, rt)
    _close(tf.element_matrices(torch.as_tensor(ec)).numpy(),
           jf.element_matrices(jnp.asarray(ec)))
    _close(tf.element_vectors(torch.as_tensor(ec)).numpy(),
           jf.element_vectors(jnp.asarray(ec)))


def test_vector_p2_elasticity_matrices_equal_jax():
    jV, tV = _pair("tet", 3)

    def form(L):
        def lhs(u, v):
            eps = L.sym(L.grad(u))
            return L.inner(0.7 * L.tr(eps) * L.Identity(3) + 2.0 * eps,
                           L.sym(L.grad(v)))
        return lhs

    ec = tV.mesh.element_coords()
    _close(twf.WeakForm(tV, device="cpu").build(form(tl)).element_matrices(
        torch.as_tensor(ec)).numpy(),
        jwf.WeakForm(jV).build(form(jl)).element_matrices(jnp.asarray(ec)))


def _p2_form(L, V):
    X = L.SpatialCoordinate(V)
    return (lambda u, v: L.dot(L.grad(u), L.grad(v)),
            lambda v: (36 - 2 * (X[0] ** 2 + X[1] ** 2)) * v)


@functools.lru_cache(maxsize=None)
def _p2_system(n):
    """The port's amg_systems.p2_system(n): the RCM-ordered,
    Dirichlet-eliminated P2 Poisson system of the n x n square."""
    V = FunctionSpace(rectangle_mesh(-3, 3, -3, 3, n, n), degree=2)
    A, b = twf.WeakForm(V, device="cpu").build(*_p2_form(tl, V)).assemble(
        format="ell")
    A, b = apply_dirichlet_ell(A, b, torch.as_tensor(V.dof_flags))
    perm = reverse_cuthill_mckee(A.cols.numpy())
    data_p, cols_p = reorder_ell(A.data, A.cols, perm)
    return (ELLMatrix(torch.as_tensor(data_p), torch.as_tensor(cols_p)),
            b[torch.as_tensor(perm)], A, b)


def test_p2_assembled_system_equals_jax():
    n = 6
    jV = JaxSpace(jax_rectangle_mesh(-3, 3, -3, 3, n, n), degree=2)
    jA, jb = jwf.WeakForm(jV).build(*_p2_form(jl, jV)).assemble(format="ell")
    _, _, A, b = _p2_system(n)
    from tpufem.solve.bc import apply_dirichlet_ell as jax_bc

    jA, jb = jax_bc(jA, jb, jnp.asarray(jV.dof_flags))
    _close(A.to_dense().numpy(), np.asarray(jA.to_dense()))
    _close(b.numpy(), jb)


def test_p2_amg_count_equals_jax(monkeypatch):
    """n = 40 (6561 DOFs): the greedy strength-0.08 AMG with coarse_n=300
    (tests/test_amg_scaling.py's P2 cell) takes the JAX package's PCG
    count to 1e-9."""
    import jax

    import tpufem.sparse.ell as jax_ell_mod
    from amg_systems import p2_system
    from tpufem.solve import amg as jamg
    from tpufem.solve.cg import cg as jax_cg

    monkeypatch.setattr(jax_ell_mod, "_AUTO_BAND_MAX", -1)
    monkeypatch.setenv("TPUFEM_BAND_DISPATCH", "0")
    Aj, bj = p2_system(40)
    hj = jamg.build_amg(Aj, aggregation="greedy", strength=0.08,
                        coarse_n=300)
    ref = jax_cg(Aj.matvec, bj, tol=1e-9, maxiter=100,
                 M=jax.jit(hj.apply))
    Ap, bp, _, _ = _p2_system(40)
    _close(Ap.data.numpy(), Aj.data)
    np.testing.assert_array_equal(Ap.cols.numpy(), np.asarray(Aj.cols))
    ht = build_amg(Ap, aggregation="greedy", strength=0.08, coarse_n=300)
    assert [lv.A.shape[0] for lv in ht.levels] == [
        lv.A.shape[0] for lv in hj.levels]
    res = cg(Ap.matvec, bp, tol=1e-9, maxiter=100, M=ht.apply)
    assert res.converged and bool(ref.converged)
    assert res.iterations == int(ref.iterations) <= 25
