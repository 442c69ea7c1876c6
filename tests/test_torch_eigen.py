"""Modal analysis and the lockstep block CG: tpufem_torch against the JAX
package on the CPU, fp64.

Both packages build the Dirichlet Laplacian of the same mesh (ELL, lumped
mass; tests/test_eigen.py's system); the port's stepper then runs from the
JAX package's random start X0 (the two random streams differ), so every
outer step sees the same inputs.  Compared: the Ritz values and the
residual norms of ``finish`` after a few ``step`` s, column-serial, batched
(``cg_fixed_block``) and mixed precision (fp32 inner solves in iterative
refinement, fp64 Gram matrices).
"""
import functools

import numpy as np
import pytest
import scipy.linalg
import torch

import jax
import jax.numpy as jnp

from tpufem.assemble import dense as jdense
from tpufem.assemble import ell as jell
from tpufem.assemble import local as jlocal
from tpufem.fem.elements import P1Triangle as JP1Triangle
from tpufem.fem.quadrature import triangle_rule as j_triangle_rule
from tpufem.mesh.adjacency import ell_pattern as j_ell_pattern
from tpufem.mesh.rectangle import rectangle_mesh as j_rectangle_mesh
from tpufem.solve import cg as jcg
from tpufem.solve.bc import apply_dirichlet_ell as j_apply_dirichlet_ell
from tpufem.solve.eigen import subspace_stepper as j_subspace_stepper
from tpufem.solve.precond import jacobi as j_jacobi
from tpufem.sparse.ell import ELLMatrix as JELLMatrix
from tpufem.sparse.ell import ell_matvec_multi as j_ell_matvec_multi

from tpufem_torch.assemble.dense import assemble_vector
from tpufem_torch.assemble.ell import assemble_ell
from tpufem_torch.assemble.local import element_mass, p1_stiffness
from tpufem_torch.fem.elements import P1Triangle
from tpufem_torch.fem.quadrature import triangle_rule
from tpufem_torch.mesh.adjacency import ell_pattern
from tpufem_torch.mesh.rectangle import rectangle_mesh
from tpufem_torch.solve.bc import apply_dirichlet_ell
from tpufem_torch.solve.cg import cg_fixed, cg_fixed_block
from tpufem_torch.solve.eigen import (EigenResult, smallest_eigenpairs,
                                      subspace_stepper)
from tpufem_torch.solve.precond import jacobi
from tpufem_torch.sparse.ell import ELLMatrix, ell_matvec_multi

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _jax_gather_products(monkeypatch):
    # the JAX package's ELL products as XLA gathers, not its Pallas kernel
    # in interpret mode (the same sums, seconds faster on the CPU)
    monkeypatch.setenv("TPUFEM_BAND_DISPATCH", "0")


N = 12


@functools.lru_cache(maxsize=None)
def _jax_system():
    mesh = j_rectangle_mesh(-3, 3, -3, 3, N, N)
    pat = j_ell_pattern(mesh.conn, mesh.num_nodes, pad_to=8)
    ec = jnp.asarray(mesh.element_coords())
    A = jell.assemble_ell(pat, jlocal.p1_stiffness(ec, JP1Triangle()))
    bc = jnp.asarray(mesh.node_flags != 0)
    A, _ = j_apply_dirichlet_ell(A, jnp.zeros(mesh.num_nodes), bc)
    Me = jlocal.element_mass(ec, JP1Triangle(), j_triangle_rule(5))
    mL = jdense.assemble_vector(jnp.asarray(mesh.conn), Me.sum(-1),
                                mesh.num_nodes)
    return A, mL, bc


@functools.lru_cache(maxsize=None)
def _port_system():
    mesh = rectangle_mesh(-3, 3, -3, 3, N, N)
    pat = ell_pattern(mesh.conn, mesh.num_nodes, pad_to=8)
    ec = torch.as_tensor(mesh.element_coords())
    A = assemble_ell(pat, p1_stiffness(ec, P1Triangle()))
    bc = torch.as_tensor(mesh.node_flags != 0)
    A, _ = apply_dirichlet_ell(A, torch.zeros(mesh.num_nodes,
                                              dtype=torch.float64), bc)
    Me = element_mass(ec, P1Triangle(), triangle_rule(5))
    mL = assemble_vector(mesh.conn, Me.sum(-1), mesh.num_nodes)
    return A, mL, bc


def _as32(A, cls):
    return cls(A.data.astype(jnp.float32) if cls is JELLMatrix
               else A.data.float(), A.cols, A.row_lengths, A.diag_pos)


def test_cg_fixed_block_matches_jax_and_cg_fixed_by_column():
    A, _, _ = _port_system()
    jA, _, _ = _jax_system()
    n, q = A.shape[0], 4
    B = np.random.default_rng(0).standard_normal((n, q))
    B[:, 3] = 0.0                       # a column that starts converged
    inv_d = (1.0 / A.diagonal())[:, None]
    got, R = cg_fixed_block(A.matvec_multi, torch.as_tensor(B), 25,
                            M_multi=lambda R: R * inv_d)
    ref, jR = jax.jit(lambda B: jcg.cg_fixed_block(
        jA.matvec_multi, B, 25,
        M_multi=lambda R: R / jA.diagonal()[:, None]))(jnp.asarray(B))
    for a, b in ((got, ref), (R, jR)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-12 * np.abs(b).max()
    assert torch.all(got[:, 3] == 0) and torch.all(torch.isfinite(got))
    M = jacobi(A)
    for j in range(q):
        x, r = cg_fixed(A.matvec, torch.as_tensor(B[:, j]), 25, M=M)
        scale = max(x.abs().max().item(), 1e-300)
        assert (got[:, j] - x).abs().max() <= 1e-12 * scale
        assert (R[:, j] - r).abs().max() <= 1e-12 * max(
            r.abs().max().item(), 1e-300)


def _kits(mode, k, **common):
    """(port stepper, JAX stepper) on the same system in ``mode``."""
    A, mL, bc = _port_system()
    jA, jmL, jbc = _jax_system()
    n = A.shape[0]
    kw = dict(lumped_mass=mL, bc_mask=bc, **common)
    jkw = dict(lumped_mass=jmL, bc_mask=jbc, **common)
    if mode == "serial":
        kw.update(M=jacobi(A))
        jkw.update(M=j_jacobi(jA))
        mv, jmv = A.matvec, jA.matvec
    elif mode == "batched":
        kw.update(M=jacobi(A), matvec_multi=A.matvec_multi)
        jkw.update(M=j_jacobi(jA), matvec_multi=jA.matvec_multi)
        mv, jmv = A.matvec, jA.matvec
    else:                                   # mixed: fp32 inner solves
        A32, jA32 = _as32(A, ELLMatrix), _as32(jA, JELLMatrix)
        kw.update(M=jacobi(A32), matvec_multi=A32.matvec_multi,
                  matvec_hi_multi=lambda X: ell_matvec_multi(
                      A.data, A.cols, X), dtype=torch.float32)
        jkw.update(M=j_jacobi(jA32), matvec_multi=jA32.matvec_multi,
                   matvec_hi_multi=lambda X: j_ell_matvec_multi(
                       jA.data, jA.cols, X), dtype=jnp.float32)
        mv, jmv = A32.matvec, jA32.matvec
    jX0, jstep, jfinish = j_subspace_stepper(jmv, n, k, **jkw)
    return (subspace_stepper(mv, n, k, device="cpu", **kw),
            (jX0, jax.jit(jstep), jax.jit(jfinish)))


@pytest.mark.parametrize("mode", ["serial", "batched", "mixed"])
def test_subspace_stepper_matches_jax_from_its_start(mode):
    """Ritz values and residual norms within 1e-10.  Mixed precision
    decomposes the q x q pencil in fp32, as the reference does, so its
    outputs are held there at fp32 resolution (the fp32 Gram entries of
    the two packages differ in their last bits, and the pair at 1.345 /
    1.352 turns its eigenvectors by eps32 / gap); the fp64 part, the
    subspace, gives the same fp64 Rayleigh-Ritz values within 1e-10."""
    k, steps = 3, 4
    (_, step, finish), (jX0, jstep, jfinish) = _kits(
        mode, k, inner_iters=15, outer_iters=steps, buffer=3)
    X, jX = torch.as_tensor(np.asarray(jX0)), jX0
    for _ in range(steps):
        X, jX = step(X), jstep(jX)
    got, ref = finish(X), jfinish(jX)
    assert isinstance(got, EigenResult) and got.iterations == steps
    assert got.eigenvalues.dtype == torch.float64
    lam, jlam = got.eigenvalues.numpy(), np.asarray(ref.eigenvalues)
    res, jres = got.residual_norms.numpy(), np.asarray(ref.residual_norms)
    if mode == "mixed":
        eps32 = np.finfo(np.float32).eps
        assert np.abs(lam - jlam).max() <= 8 * eps32 * np.abs(jlam).max()
        assert np.abs(res - jres).max() <= 1e-4 * np.abs(jres).max()
        A, mL, _ = _port_system()
        Ad, m = A.to_dense().numpy(), mL.numpy()

        def ritz64(Y):
            Y = np.asarray(Y)
            return scipy.linalg.eigh(Y.T @ Ad @ Y, Y.T @ (m[:, None] * Y),
                                     eigvals_only=True)

        lam, jlam = ritz64(X.numpy()), ritz64(jX)
    assert np.abs(lam - jlam).max() <= 1e-10 * np.abs(jlam).max(), (lam,
                                                                    jlam)
    if mode != "mixed":
        assert np.abs(res - jres).max() <= 1e-10, (res, jres)
    # the Ritz vectors are M_L-orthonormal (to the fp32 Cholesky's shift,
    # 100 eps32 trace(M_hat) = 7e-5 relative, when mixed)
    U, mL = got.eigenvectors, _port_system()[1]
    G = U.T @ (mL[:, None] * U)
    assert (G - torch.eye(k, dtype=G.dtype)).abs().max() < (
        2e-4 if mode == "mixed" else 1e-6)


def test_smallest_eigenpairs_is_finish_of_steps_from_its_start():
    A, mL, bc = _port_system()
    n, k = A.shape[0], 3
    kw = dict(lumped_mass=mL, M=jacobi(A), bc_mask=bc, inner_iters=15,
              outer_iters=3, buffer=2, seed=7, device="cpu")
    res = smallest_eigenpairs(A.matvec, n, k, **kw)
    X0, step, finish = subspace_stepper(A.matvec, n, k, **kw)
    assert X0.shape == (n, k + 2) and torch.all(X0[bc] == 0)
    assert torch.equal(X0, subspace_stepper(A.matvec, n, k, **kw)[0])
    X = X0
    for _ in range(3):
        X = step(X)
    again = finish(X)
    assert torch.equal(res.eigenvalues, again.eigenvalues)
    assert torch.equal(res.eigenvectors, again.eigenvectors)
    # a standard problem (no mass) converges to A's own eigenvalues
    std = smallest_eigenpairs(A.matvec, n, 2, inner_iters=60,
                              outer_iters=40, bc_mask=bc, device="cpu",
                              matvec_multi=A.matvec_multi)
    dense = np.linalg.eigvalsh(A.to_dense().numpy()[~bc.numpy()][
        :, ~bc.numpy()])
    np.testing.assert_allclose(std.eigenvalues.numpy(), dense[:2],
                               rtol=1e-8)
