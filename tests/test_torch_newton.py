"""Matrix-free Newton-Krylov and the semilinear load: tpufem_torch against
the JAX package on the CPU, fp64.

The semilinear model problem of tests/test_newton.py and
examples/nonlinear_poisson.py (-Δu + u³ = f on (-3,3)², u = 0 on the
boundary, exact solution (9-x²)(9-y²)) is built by both packages on the
same mesh; random states come from a numpy seed.  The port's Jacobian-
vector product is the forward-mode tangent of its residual: the ELL
product's own rule and the sorted scatter's.
"""
import functools

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwad

import jax
import jax.numpy as jnp

from tpufem.assemble import dense as jdense
from tpufem.assemble import ell as jell
from tpufem.assemble import local as jlocal
from tpufem.fem.elements import P1Triangle as JP1Triangle
from tpufem.fem.quadrature import triangle_rule as j_triangle_rule
from tpufem.mesh.adjacency import ell_pattern as j_ell_pattern
from tpufem.mesh.rectangle import rectangle_mesh as j_rectangle_mesh
from tpufem.solve.newton import newton_krylov as j_newton_krylov

from tpufem_torch.assemble.dense import assemble_vector
from tpufem_torch.assemble.ell import assemble_ell
from tpufem_torch.assemble.local import (element_load,
                                         element_nonlinear_load,
                                         p1_stiffness)
from tpufem_torch.fem.elements import P1Triangle
from tpufem_torch.fem.quadrature import triangle_rule
from tpufem_torch.mesh.adjacency import ell_pattern
from tpufem_torch.mesh.rectangle import rectangle_mesh
from tpufem_torch.solve.newton import NewtonResult, newton_krylov

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _jax_gather_products(monkeypatch):
    # the JAX package's ELL products as XLA gathers, not its Pallas kernel
    # in interpret mode (the same sums, seconds faster on the CPU)
    monkeypatch.setenv("TPUFEM_BAND_DISPATCH", "0")


def _exact(x):
    return (9.0 - x[..., 0] ** 2) * (9.0 - x[..., 1] ** 2)


def _f(x):
    return 36.0 - 2.0 * (x[..., 0] ** 2 + x[..., 1] ** 2) + _exact(x) ** 3


@functools.lru_cache(maxsize=None)
def _jax_semilinear(n):
    """The reference's residual closure (tests/test_newton.py's)."""
    mesh = j_rectangle_mesh(-3, 3, -3, 3, n, n)
    pat = j_ell_pattern(mesh.conn, mesh.num_nodes, pad_to=8)
    el, rule = JP1Triangle(), j_triangle_rule(5)
    ec = jnp.asarray(mesh.element_coords())
    conn = jnp.asarray(mesh.conn)
    nn = mesh.num_nodes
    A = jell.assemble_ell(pat, jlocal.p1_stiffness(ec, el))
    b = jdense.assemble_vector(conn, jlocal.element_load(ec, el, rule, _f),
                               nn)
    bc = jnp.asarray(mesh.node_flags != 0)

    def residual(u):
        ui = jnp.where(bc, 0.0, u)
        nl = jdense.assemble_vector(
            conn, jlocal.element_nonlinear_load(ec, el, rule, ui[conn],
                                                lambda w: w ** 3), nn)
        return jnp.where(bc, u, A.matvec(ui) + nl - b)

    return mesh, residual, A, bc


def _port_semilinear(n):
    """The same residual built by the port (CPU tensors)."""
    mesh = rectangle_mesh(-3, 3, -3, 3, n, n)
    pat = ell_pattern(mesh.conn, mesh.num_nodes, pad_to=8,
                      with_sort_plan=False)
    el, rule = P1Triangle(), triangle_rule(5)
    ec = torch.as_tensor(mesh.element_coords())
    conn = torch.as_tensor(mesh.conn).long()
    nn = mesh.num_nodes
    A = assemble_ell(pat, p1_stiffness(ec, el))
    b = assemble_vector(mesh.conn, element_load(ec, el, rule, _f), nn)
    bc = torch.as_tensor(mesh.node_flags != 0)

    def residual(u):
        ui = torch.where(bc, 0.0, u)
        nl = assemble_vector(conn, element_nonlinear_load(
            ec, el, rule, ui[conn], lambda w: w ** 3), nn)
        return torch.where(bc, u, A.matvec(ui) + nl - b)

    return mesh, residual, A, bc


def test_element_nonlinear_load_matches_jax():
    mesh = j_rectangle_mesh(-3, 3, -3, 3, 12, 12)
    ec = mesh.element_coords()
    rng = np.random.default_rng(0)
    u_local = 3.0 * rng.standard_normal(mesh.conn.shape)
    ref = jlocal.element_nonlinear_load(
        jnp.asarray(ec), JP1Triangle(), j_triangle_rule(5),
        jnp.asarray(u_local), lambda w: w ** 3 + jnp.sin(w))
    got = element_nonlinear_load(
        torch.as_tensor(ec), P1Triangle(), triangle_rule(5),
        torch.as_tensor(u_local), lambda w: w ** 3 + torch.sin(w))
    ref = np.asarray(ref)
    assert got.dtype == torch.float64
    assert np.abs(got.numpy() - ref).max() <= 1e-13 * np.abs(ref).max()


def test_scatter_assembly_carries_the_tangent():
    """assemble_vector's accumulating index_put_ has a forward-mode rule:
    the tangent of the assembled vector is the assembled tangents."""
    mesh = rectangle_mesh(0, 1, 0, 1, 6, 6)
    rng = np.random.default_rng(1)
    vals, tans = (torch.as_tensor(rng.standard_normal(mesh.conn.shape))
                  for _ in range(2))
    with fwad.dual_level():
        out = fwad.unpack_dual(assemble_vector(
            mesh.conn, fwad.make_dual(vals, tans), mesh.num_nodes))
    assert out.tangent is not None
    want = np.zeros(mesh.num_nodes)
    np.add.at(want, mesh.conn.reshape(-1), tans.numpy().reshape(-1))
    np.testing.assert_allclose(out.tangent.numpy(), want, rtol=0,
                               atol=1e-14)
    want = np.zeros(mesh.num_nodes)
    np.add.at(want, mesh.conn.reshape(-1), vals.numpy().reshape(-1))
    np.testing.assert_allclose(out.primal.numpy(), want, rtol=0, atol=1e-14)


def test_residual_and_its_jvp_match_jax_and_a_central_difference():
    """tests/test_newton.py's JVP check (seed 0) through the port:
    the residual and its tangent against the JAX package's, the tangent
    within 1e-6 of a central difference, as the reference's is."""
    n = 16
    _, j_res, _, _ = _jax_semilinear(n)
    mesh, residual, _, _ = _port_semilinear(n)
    rng = np.random.default_rng(0)
    u, v = (rng.standard_normal(mesh.num_nodes) for _ in range(2))
    r_ref = np.asarray(j_res(jnp.asarray(u)))
    r = residual(torch.as_tensor(u)).numpy()
    assert np.abs(r - r_ref).max() <= 1e-12 * np.abs(r_ref).max()

    with fwad.dual_level():
        jv = fwad.unpack_dual(residual(fwad.make_dual(
            torch.as_tensor(u), torch.as_tensor(v)))).tangent.numpy()
    jv_ref = np.asarray(jax.jvp(j_res, (jnp.asarray(u),),
                                (jnp.asarray(v),))[1])
    assert np.abs(jv - jv_ref).max() <= 1e-12 * np.abs(jv_ref).max()
    eps = 1e-6
    fd = (residual(torch.as_tensor(u + eps * v)).numpy()
          - residual(torch.as_tensor(u - eps * v)).numpy()) / (2 * eps)
    assert np.abs(jv - fd).max() < 1e-6 * max(1.0, np.abs(jv).max())


@pytest.mark.parametrize("precond,start", [
    ("none", "zero"), ("jacobi", "zero"), ("jacobi", "random")])
def test_newton_krylov_matches_jax(precond, start):
    """Same Newton and inner CG counts as the JAX package, x within 1e-10
    (Eisenstat-Walker forcing, check_every=4 inner CG, Armijo halving).

    The random start is O(1): from 20 x randn the Jacobians' 3u^2 terms
    make the loose inner solves rounding-sensitive, and the JAX package
    alone, with its stiffness product summed in another order (a dense
    matmul), moves its inner count by one check block of 4."""
    n = 16
    _, j_res, jA, jbc = _jax_semilinear(n)
    mesh, residual, A, bc = _port_semilinear(n)
    nn = mesh.num_nodes
    x0 = (np.zeros(nn) if start == "zero"
          else np.random.default_rng(3).standard_normal(nn))
    jM = M = None
    if precond == "jacobi":
        jd = jA.diagonal()
        j_inv = jnp.where(jbc, 1.0, jnp.where(jd != 0, 1.0 / jd, 1.0))
        jM = lambda r: r * j_inv
        inv = torch.where(bc, 1.0, 1.0 / A.diagonal())
        M = lambda r: r * inv
    ref = j_newton_krylov(j_res, jnp.asarray(x0), tol=1e-10, maxiter=20,
                          M=jM)
    got = newton_krylov(residual, torch.as_tensor(x0), tol=1e-10,
                        maxiter=20, M=M)
    assert isinstance(got, NewtonResult) and got.converged
    assert bool(ref.converged)
    assert got.iterations == int(ref.iterations)
    assert got.inner_iterations == int(ref.inner_iterations)
    x_ref = np.asarray(ref.x)
    assert np.abs(got.x.numpy() - x_ref).max() <= 1e-10 * np.abs(x_ref).max()
    assert abs(float(got.residual_norm) - float(ref.residual_norm)) <= 1e-12
    err = (np.linalg.norm(got.x.numpy() - _exact(mesh.coords))
           / np.linalg.norm(_exact(mesh.coords)))
    assert err < 30.0 / (n * n)                        # O(h^2)


def test_newton_krylov_stops_at_maxiter_and_on_a_zero_residual():
    mesh, residual, _, _ = _port_semilinear(8)
    res = newton_krylov(residual, torch.zeros(mesh.num_nodes,
                                              dtype=torch.float64),
                        tol=1e-14, maxiter=1)
    assert res.iterations == 1 and not res.converged
    lin = lambda x: x - 2.0
    res = newton_krylov(lin, torch.full((5,), 2.0, dtype=torch.float64))
    assert res.iterations == 0 and res.converged
    assert res.inner_iterations == 0
