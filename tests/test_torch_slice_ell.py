"""Port parity, the fourth slice whole: solve_poisson_ell (ELL assembly,
Dirichlet elimination, Jacobi / Chebyshev PCG on the gather form or the
RCM-reordered banded kernel) against the JAX package's, float64 on the
CPU: equal iteration counts and u at 1e-10; the preconditioners at 1e-12;
a JAX-assembled system carried across by convert.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpufem.assemble import ell as jax_asm
from tpufem.assemble import local as jax_local
from tpufem.assemble.dense import assemble_vector as jax_assemble_vector
from tpufem.fem.elements import P1Triangle as JaxP1Triangle
from tpufem.fem.quadrature import triangle_rule as jax_triangle_rule
from tpufem.mesh import adjacency as jax_adj
from tpufem.mesh.box import box_mesh as jax_box_mesh
from tpufem.mesh.rectangle import perturbed_rectangle_mesh as jax_perturbed
from tpufem.solve import bc as jax_bc
from tpufem.solve import poisson as jax_poisson
from tpufem.solve import precond as jax_precond
from tpufem.solve.cg import cg as jax_cg

from tpufem_torch.convert import band_plan_from_numpy, ell_from_numpy
from tpufem_torch.mesh.core import Mesh
from tpufem_torch.mesh.rectangle import perturbed_rectangle_mesh
from tpufem_torch.solve import precond
from tpufem_torch.solve.cg import cg
from tpufem_torch.solve.poisson import (model_problem_2d,
                                        solve_poisson_dense,
                                        solve_poisson_ell)

# several pytest workers share the CPU: one intra-op thread each keeps
# the many small tensor ops from oversubscribing it
torch.set_num_threads(1)


@pytest.fixture
def jax_gather(monkeypatch):
    """The JAX package's own switch: its ELLMatrix products take the XLA
    gather instead of the interpreted Pallas kernel (30x slower on the
    CPU); the explicit banded path still runs the kernel, interpreted."""
    monkeypatch.setenv("TPUFEM_BAND_DISPATCH", "0")


def _meshes(n=24):
    kw = dict(jitter=0.2, seed=3)
    return (jax_perturbed(-3, 3, -3, 3, n, n, **kw),
            perturbed_rectangle_mesh(-3, 3, -3, 3, n, n, **kw))


def _same(sol, ref, n_dofs):
    assert sol.cg.converged and bool(ref.cg.converged)
    assert sol.cg.iterations == int(ref.cg.iterations)
    assert sol.num_dofs == ref.num_dofs == n_dofs
    u_ref = np.asarray(ref.u)
    assert np.abs(sol.u.numpy() - u_ref).max() <= 1e-10 * np.abs(u_ref).max()


@pytest.mark.parametrize("method", ["scatter", "sort"])
@pytest.mark.parametrize("matvec", ["gather", "pallas"])
@pytest.mark.parametrize("pc", [None, "jacobi", "chebyshev"])
def test_solve_poisson_ell_matches_jax(jax_gather, pc, matvec, method):
    ref_mesh, mesh = _meshes()
    kw = dict(tol=1e-8, precond=pc, matvec=matvec, assembly_method=method)
    ref = jax_poisson.solve_poisson_ell(ref_mesh, interpret=True, **kw)
    sol = solve_poisson_ell(mesh, device="cpu", **kw)
    _same(sol, ref, 25 * 25)


@pytest.mark.parametrize("matvec", ["gather", "pallas"])
def test_solve_poisson_ell_unpreconditioned_matches_jax(jax_gather, matvec):
    ref_mesh, mesh = _meshes(16)
    kw = dict(tol=1e-8, precondition=False, matvec=matvec, block_rows=128)
    ref = jax_poisson.solve_poisson_ell(ref_mesh, interpret=True, **kw)
    _same(solve_poisson_ell(mesh, device="cpu", **kw), ref, 17 * 17)


def test_solve_poisson_ell_3d_box_matches_jax(jax_gather):
    """The JAX package's Kuhn box mesh (6 cells a side) fed to the port's
    Mesh: P1 tetrahedra, pad_to 16, quadrature degree 3."""
    ref_mesh = jax_box_mesh(-3.0, 3.0, -3.0, 3.0, -3.0, 3.0, 6, 6, 6)
    mesh = Mesh(coords=ref_mesh.coords, conn=ref_mesh.conn,
                node_flags=ref_mesh.node_flags, cell_type="tetrahedron")
    for kw in (dict(), dict(precond="chebyshev", matvec="pallas")):
        ref = jax_poisson.solve_poisson_ell(ref_mesh, tol=1e-8, **kw)
        _same(solve_poisson_ell(mesh, tol=1e-8, device="cpu", **kw), ref,
              7 ** 3)


def test_solve_poisson_dense_matches_jax():
    ref_mesh, mesh = _meshes(10)
    ref = jax_poisson.solve_poisson_dense(ref_mesh)
    _same(solve_poisson_dense(mesh, device="cpu"), ref, 11 * 11)


def test_solve_poisson_ell_discretizes_the_model_problem():
    """-Δu = 36 - 2(x² + y²) on (-3, 3)², row-major numbering (the banded
    path): O(h²) against u = (9-x²)(9-y²), as the verify recipe's 2.0e-4
    at 64 x 64."""
    from tpufem_torch.mesh.rectangle import RectangleMesh

    mesh = RectangleMesh(-3, 3, -3, 3, 32, 32)
    sol = solve_poisson_ell(mesh, tol=1e-10, device="cpu")
    ue = model_problem_2d()[1](mesh.coords)
    err = np.linalg.norm(sol.u.numpy() - ue) / np.linalg.norm(ue)
    assert sol.cg.converged and 4e-4 < err < 1.2e-3


def test_unported_options_raise():
    _, mesh = _meshes(4)
    # precond="amg" is ported (ROADMAP A2): it solves
    assert solve_poisson_ell(mesh, precond="amg", device="cpu").cg.converged
    for kw in (dict(precond="ilu"), dict(matvec="csr"),
               dict(assembly_method="coo")):
        with pytest.raises(ValueError):
            solve_poisson_ell(mesh, device="cpu", **kw)
    # quad meshes (ported) solve as the JAX package's: the same count and
    # solution on a 4 x 4 Q1 mesh
    from tpufem.mesh.rectangle import rectangle_quad_mesh as jax_quad_mesh

    from tpufem_torch.mesh.rectangle import rectangle_quad_mesh

    sol = solve_poisson_ell(rectangle_quad_mesh(-3, 3, -3, 3, 4, 4),
                            tol=1e-10, device="cpu")
    ref = jax_poisson.solve_poisson_ell(jax_quad_mesh(-3, 3, -3, 3, 4, 4),
                                        tol=1e-10)
    assert sol.cg.converged and sol.cg.iterations == int(ref.cg.iterations)
    u_ref = np.asarray(ref.u)
    assert np.abs(sol.u.numpy() - u_ref).max() <= 1e-12 * np.abs(u_ref).max()


def _jax_system(n=20):
    """A JAX-assembled, JAX-BC'd 2D ELL system (RCM-renumbered mesh)."""
    mesh = jax_perturbed(-3, 3, -3, 3, n, n, jitter=0.25, seed=2)
    cols0 = jax_adj.ell_pattern(mesh.conn, mesh.num_nodes, pad_to=8).cols
    perm = jax_adj.reverse_cuthill_mckee(cols0, use_native=False)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    conn = inv[mesh.conn].astype(np.int32)
    coords, flags = mesh.coords[perm], mesh.node_flags[perm]
    pat = jax_adj.ell_pattern(conn, mesh.num_nodes, pad_to=8)
    ec = jnp.asarray(coords[conn])
    el, rule = JaxP1Triangle(), jax_triangle_rule(5)
    A = jax_asm.assemble_ell(pat, jax_local.p1_stiffness(ec, el))
    b = jax_assemble_vector(conn, jax_local.element_load(
        ec, el, rule, jax_poisson.model_problem_2d()[0]), mesh.num_nodes)
    return jax_bc.apply_dirichlet_ell(A, b, jnp.asarray(flags != 0))


def test_convert_carries_a_jax_ell_system_and_band_plan(jax_gather):
    """A JAX-assembled and JAX-BC'd ELL system, with the JAX band plan
    carried across, gives the port's solve the JAX solution."""
    A, b = _jax_system()
    ref = jax_cg(A.matvec, b, tol=1e-10, maxiter=500,
                 M=jax_precond.jacobi(A))
    A.prime_band_plan(256)
    plan = A._band[0]
    band = band_plan_from_numpy(
        plan.rel, plan.data_t, n=plan.n, np_rows=plan.np_rows,
        block_rows=plan.block_rows, d_lists=plan.d_lists, width=plan.width,
        segments=plan.segments)
    At = ell_from_numpy(np.asarray(A.data), np.asarray(A.cols),
                        np.asarray(A.row_lengths), np.asarray(A.diag_pos),
                        band=band)
    assert At._band[0].rel.dtype == np.int16
    res = cg(At.matvec, torch.as_tensor(np.asarray(b)), tol=1e-10,
             maxiter=500, M=precond.jacobi(At))
    assert res.converged and res.iterations == int(ref.iterations)
    u_ref = np.asarray(ref.x)
    assert np.abs(res.x.numpy() - u_ref).max() <= 1e-10 * np.abs(u_ref).max()
    with pytest.raises(ValueError, match="window"):
        band_plan_from_numpy(
            plan.rel + np.int16(plan.block_rows), plan.data_t, n=plan.n,
            np_rows=plan.np_rows, block_rows=plan.block_rows,
            d_lists=plan.d_lists, width=plan.width)


def _port_system():
    A, b = _jax_system(12)
    At = ell_from_numpy(np.asarray(A.data), np.asarray(A.cols),
                        np.asarray(A.row_lengths), np.asarray(A.diag_pos))
    return A, At


def test_preconditioners_match_jax(jax_gather):
    """lambda_max_bound; Jacobi and Chebyshev(14) on [n] and on [n, q]
    (through the multi-RHS product)."""
    A, At = _port_system()
    lmax = precond.lambda_max_bound(At)
    assert abs(lmax - jax_precond.lambda_max_bound(A)) <= 1e-12 * lmax
    rng = np.random.default_rng(0)
    r = rng.standard_normal(A.shape[0])
    R = rng.standard_normal((A.shape[0], 3))
    cheb = precond.chebyshev(At.matvec, At.diagonal(), degree=14, lmax=lmax)
    cheb_m = precond.chebyshev(At.matvec_multi, At.diagonal(), degree=14,
                               lmax=lmax)
    ref = jax_precond.chebyshev(A.matvec, A.diagonal(), degree=14, lmax=lmax)
    ref_m = jax_precond.chebyshev(A.matvec_multi, A.diagonal(), degree=14,
                                  lmax=lmax)
    for got, want in ((cheb(torch.as_tensor(r)), ref(jnp.asarray(r))),
                      (cheb_m(torch.as_tensor(R)), ref_m(jnp.asarray(R))),
                      (precond.jacobi(At)(torch.as_tensor(r)),
                       jax_precond.jacobi(A)(jnp.asarray(r)))):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()
    # the [n, q] application is q [n] applications
    for j in range(3):
        col = cheb(torch.as_tensor(R[:, j])).numpy()
        got = cheb_m(torch.as_tensor(R)).numpy()[:, j]
        assert np.abs(got - col).max() <= 1e-12 * np.abs(col).max()


def test_estimate_lambda_max_against_dense_eigenvalues():
    """Power iteration from a seeded torch.Generator start (not JAX's PRNG
    bits) against the dense spectrum of D^-1 A."""
    _, At = _port_system()
    dense = At.to_dense().numpy()
    d = np.diag(dense)
    lmax = np.linalg.eigvalsh(dense / np.sqrt(np.outer(d, d))).max()
    est = precond.estimate_lambda_max(At.matvec, At.diagonal(), dense.shape[0],
                                      iters=400, dtype=torch.float64,
                                      boost=1.0)
    assert abs(est - lmax) <= 1e-3 * lmax
    est = precond.estimate_lambda_max(At.matvec, At.diagonal(),
                                      dense.shape[0], dtype=torch.float64)
    assert 0.7 * lmax < est < 1.1 * lmax
    assert est == precond.estimate_lambda_max(
        At.matvec, At.diagonal(), dense.shape[0], dtype=torch.float64)
    assert precond.lambda_max_bound(At) >= lmax


def test_jacobi_guards_a_zero_diagonal():
    M = precond.jacobi_from_diagonal(torch.tensor([2.0, 0.0, -4.0]))
    assert M(torch.ones(3)).tolist() == [0.5, 1.0, -0.25]
