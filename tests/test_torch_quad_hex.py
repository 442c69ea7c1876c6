"""Port parity, Q1 quads and hexes: tpufem_torch's quad / hex meshes, the
isoparametric weak-form kernels (the Jacobian at every quadrature point)
and solve_poisson_ell / solve_poisson_dense on Q1 meshes against the JAX
package's (float64, CPU).  Meshes equal bit for bit (the perturbed one
from the same numpy draws); the golden single-element matrices of
tests/test_quad_hex.py at 1e-12; element matrices on distorted cells and
the solves' PCG counts equal the JAX package's; the patch tests reproduce
linear fields."""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from tpufem.fem.space import FunctionSpace as JaxSpace
from tpufem.forms import language as jl
from tpufem.forms import weakform as jwf
from tpufem.mesh.box import box_hex_mesh as jax_box_hex_mesh
from tpufem.mesh.rectangle import perturbed_quad_mesh as jax_quad_mesh
from tpufem.mesh.rectangle import rectangle_quad_mesh as jax_rect_quad
from tpufem.solve.poisson import solve_poisson_dense as jax_dense
from tpufem.solve.poisson import solve_poisson_ell as jax_ell

from tpufem_torch.fem.space import FunctionSpace
from tpufem_torch.forms import language as tl
from tpufem_torch.forms import weakform as twf
from tpufem_torch.mesh.box import box_hex_mesh
from tpufem_torch.mesh.core import Mesh
from tpufem_torch.mesh.rectangle import (perturbed_quad_mesh,
                                         rectangle_quad_mesh)
from tpufem_torch.solve.bc import apply_dirichlet_ell
from tpufem_torch.solve.cg import cg
from tpufem_torch.solve.poisson import (solve_poisson_dense,
                                        solve_poisson_ell)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """One BLAS thread a test, as one torch thread: numpy's OpenBLAS
    threads spin against the other workers on the shared CPU (a 729 x 729
    inverse takes seconds on eight, 0.07 s on one)."""
    with threadpool_limits(1, user_api="blas"):
        yield


def _close(a, ref, rtol=1e-12):
    a, ref = np.asarray(a), np.asarray(ref)
    assert a.shape == ref.shape
    assert np.abs(a - ref).max() <= rtol * max(np.abs(ref).max(), 1e-300)


_MESHES = [
    (rectangle_quad_mesh, jax_rect_quad, (-3, 3, -3, 3, 5, 4), {}),
    (perturbed_quad_mesh, jax_quad_mesh, (-3, 3, -3, 3, 6, 5),
     dict(jitter=0.25, seed=5)),
    (perturbed_quad_mesh, jax_quad_mesh, (0, 1, 0, 1, 3, 4),
     dict(jitter=0.2, seed=2, renumber=False)),
    (box_hex_mesh, jax_box_hex_mesh, (-3, 3, -3, 3, -3, 3, 2, 3, 4), {}),
]


@pytest.mark.parametrize("i", range(len(_MESHES)),
                         ids=["quad", "perturbed_quad", "quad_in_order",
                              "hex"])
def test_meshes_equal_jax(i):
    make, jmake, args, kw = _MESHES[i]
    m, jm = make(*args, **kw), jmake(*args, **kw)
    for field in ("coords", "conn", "node_flags"):
        np.testing.assert_array_equal(getattr(m, field), getattr(jm, field))
    assert m.cell_type == jm.cell_type
    assert (m.structured is None) == (jm.structured is None)
    if m.structured is not None:
        assert m.structured.node_grid == jm.structured.node_grid
        assert m.structured.cell_grid == jm.structured.cell_grid
        np.testing.assert_array_equal(m.structured.type_node_offsets,
                                      jm.structured.type_node_offsets)


def _single(coords, cell):
    n = len(coords)
    return Mesh(coords=np.asarray(coords, np.float64),
                conn=np.arange(n, dtype=np.int32)[None],
                node_flags=np.ones(n, np.int32), cell_type=cell)


def _element_matrices(mesh, lhs):
    wf = twf.WeakForm(FunctionSpace(mesh), device="cpu").build(lhs)
    return wf.element_matrices(torch.as_tensor(mesh.element_coords()))


def test_golden_single_element_matrices():
    """tests/test_quad_hex.py's golden matrices at 1e-12: the unit square's
    Q1 stiffness (diag 2/3, adjacent -1/6, opposite -1/3) and mass, and the
    unit cube's stiffness against the tensor-product construction."""
    quad = _single([[0, 0], [1, 0], [1, 1], [0, 1]], "quad")
    Ke = _element_matrices(quad, lambda u, v: tl.dot(tl.grad(u),
                                                      tl.grad(v)))
    golden = (1 / 6) * np.array([
        [4, -1, -2, -1], [-1, 4, -1, -2], [-2, -1, 4, -1], [-1, -2, -1, 4]])
    np.testing.assert_allclose(Ke[0].numpy(), golden, rtol=0, atol=1e-12)
    Me = _element_matrices(quad, lambda u, v: u * v)
    golden = (1 / 36) * np.array([
        [4, 2, 1, 2], [2, 4, 2, 1], [1, 2, 4, 2], [2, 1, 2, 4]])
    np.testing.assert_allclose(Me[0].numpy(), golden, rtol=0, atol=1e-12)
    K1 = np.array([[1.0, -1.0], [-1.0, 1.0]])
    M1 = np.array([[1 / 3, 1 / 6], [1 / 6, 1 / 3]])
    K_lex = (np.kron(M1, np.kron(M1, K1)) + np.kron(M1, np.kron(K1, M1))
             + np.kron(K1, np.kron(M1, M1)))
    perm = [0, 1, 3, 2, 4, 5, 7, 6]
    Ke = _element_matrices(box_hex_mesh(0, 1, 0, 1, 0, 1, 1, 1, 1),
                           lambda u, v: tl.dot(tl.grad(u), tl.grad(v)))
    np.testing.assert_allclose(Ke[0].numpy(), K_lex[np.ix_(perm, perm)],
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("i", [1, 3], ids=["perturbed_quad", "hex"])
def test_isoparametric_element_kernels_equal_jax(i):
    """Stiffness, mass and a coefficient load on distorted quads and on
    hexes (jittered interior nodes): the per-point Jacobians agree with
    the JAX package's at 1e-12."""
    make, jmake, args, kw = _MESHES[i]
    m, jm = make(*args, **kw), jmake(*args, **kw)
    if m.cell_type == "hexahedron":
        rng = np.random.default_rng(7)
        inner = m.node_flags == 0
        shift = rng.uniform(-0.2, 0.2, (int(inner.sum()), 3))
        for mesh in (m, jm):
            mesh.coords[inner] += shift
    V, jV = FunctionSpace(m), JaxSpace(jm)
    ec = m.element_coords()
    f = lambda p: 1.0 + p[..., 0] * p[..., 1]
    for lhs in ("stiffness", "mass"):
        def form(L):
            if lhs == "stiffness":
                return lambda u, v: L.dot(L.grad(u), L.grad(v))
            return lambda u, v: u * v
        tw = twf.WeakForm(V, device="cpu").build(
            form(tl), lambda v: tl.Coefficient(f) * v)
        jw = jwf.WeakForm(jV).build(form(jl),
                                    lambda v: jl.Coefficient(f) * v)
        _close(tw.element_matrices(torch.as_tensor(ec)).numpy(),
               jw.element_matrices(jnp.asarray(ec)))
        _close(tw.element_vectors(torch.as_tensor(ec)).numpy(),
               jw.element_vectors(jnp.asarray(ec)))
    # the area of the distorted quads is the rectangle's
    if m.cell_type == "quad":
        one = tl.Coefficient(lambda x: torch.ones(x.shape[:-1],
                                                  dtype=x.dtype))
        assert abs(twf.integrate(V, one, device="cpu").item() - 36.0) \
            < 1e-12 * 36.0


def test_chunked_isoparametric_evaluation_is_bit_equal(monkeypatch):
    """Chunks of elements change no bit on the per-point geometry path."""
    m = perturbed_quad_mesh(-1, 1, -1, 1, 6, 6, jitter=0.2, seed=3)
    V = FunctionSpace(m)
    wf = twf.WeakForm(V, device="cpu").build(
        lambda u, v: tl.dot(tl.grad(u), tl.grad(v)))
    ec = torch.as_tensor(m.element_coords())
    whole = wf.element_matrices(ec)
    # 4 x 4 local entries, 4 points, 2 x 2 values, 8 bytes: 5 elements
    monkeypatch.setattr(twf, "_CHUNK_BYTES", 4 * 4 * 4 * 4 * 8 * 5)
    assert twf.chunk_elements(V, wf.quadrature, torch.float64) == 5
    assert torch.equal(wf.element_matrices(ec), whole)


@pytest.mark.parametrize("cell", ["quad", "hex"])
def test_patch_tests_reproduce_linear_fields(cell):
    if cell == "quad":
        mesh = perturbed_quad_mesh(0, 2, 0, 1, 5, 7, jitter=0.25, seed=3)
        lin = lambda c: 0.75 + 1.5 * c[..., 0] - 2.25 * c[..., 1]
    else:
        base = box_hex_mesh(0, 1, 0, 1, 0, 1, 3, 3, 3)
        rng = np.random.default_rng(7)
        coords = base.coords.copy()
        inner = base.node_flags == 0
        coords[inner] += rng.uniform(-0.08, 0.08, (int(inner.sum()), 3))
        mesh = Mesh(coords=coords, conn=base.conn,
                    node_flags=base.node_flags, cell_type="hexahedron")
        lin = lambda c: (1.0 - 2.0 * c[..., 0] + 3.0 * c[..., 1]
                         + 0.5 * c[..., 2])
    V = FunctionSpace(mesh)
    A, _ = twf.WeakForm(V, device="cpu").build(
        lambda u, v: tl.dot(tl.grad(u), tl.grad(v))).assemble(format="ell")
    g = torch.as_tensor(lin(mesh.coords))
    A, b = apply_dirichlet_ell(A, torch.zeros(V.num_dofs,
                                              dtype=torch.float64),
                               torch.as_tensor(V.dof_flags), g)
    res = cg(A.matvec, b, tol=1e-13, maxiter=2000)
    assert res.converged
    np.testing.assert_allclose(res.x.numpy(), g.numpy(), atol=1e-9)


_SOLVES = [
    ("quad_jacobi", lambda m: m(-3, 3, -3, 3, 8, 8, jitter=0.25, seed=5),
     (perturbed_quad_mesh, jax_quad_mesh), dict(tol=1e-10)),
    ("quad_amg", lambda m: m(-3, 3, -3, 3, 16, 16, jitter=0.25, seed=5),
     (perturbed_quad_mesh, jax_quad_mesh), dict(tol=1e-10,
                                                precond="amg")),
    ("hex_amg", lambda m: m(-3, 3, -3, 3, -3, 3, 6, 6, 6),
     (box_hex_mesh, jax_box_hex_mesh), dict(tol=1e-10, precond="amg")),
]


@pytest.mark.parametrize("name,make,makers,kw", _SOLVES,
                         ids=[s[0] for s in _SOLVES])
def test_solve_poisson_ell_counts_equal_jax(name, make, makers, kw,
                                            monkeypatch):
    monkeypatch.setenv("TPUFEM_BAND_DISPATCH", "0")
    m, jm = make(makers[0]), make(makers[1])
    sol = solve_poisson_ell(m, device="cpu", **kw)
    ref = jax_ell(jm, **kw)
    assert sol.cg.converged and bool(ref.cg.converged)
    assert sol.cg.iterations == int(ref.cg.iterations)
    u_ref = np.asarray(ref.u)
    assert np.abs(sol.u.numpy() - u_ref).max() <= 1e-8 * np.abs(u_ref).max()


def test_solve_poisson_dense_on_quads_equals_jax():
    m, jm = (f(-3, 3, -3, 3, 4, 4) for f in (rectangle_quad_mesh,
                                             jax_rect_quad))
    sol = solve_poisson_dense(m, tol=1e-12, device="cpu")
    ref = jax_dense(jm, tol=1e-12)
    assert sol.cg.iterations == int(ref.cg.iterations)
    _close(sol.u.numpy(), ref.u, rtol=1e-10)
