"""Taylor-Hood Stokes: tpufem_torch.solve.stokes against the JAX package's
on the CPU.

Both packages build the operator on the same mesh (a 6 x 6 square and a
4 x 4 x 4 cube): the seven arrays, the saddle-point product, the lifted
rhs and the block preconditioner on vectors from a numpy seed agree to
1e-12, and the port's operator is symmetric.  The velocity AMG has the
reference's RCM permutation and level shapes; the solves (Jacobi and AMG,
the regularized lid-driven cavity and a body force) take the reference's
MINRES count in fp64 and give its u and p to 1e-8, and the fp32 AMG
cavity its count within one check_every batch.  The JAX package's products
run as XLA gathers (TPUFEM_BAND_DISPATCH=0), not its Pallas kernel in
interpret mode: the same sums, seconds faster.  Its operator builds and
products are staged under jax.jit: called eagerly, each of their many small
ops compiles on its first call (seconds a build); staged they are the same
programs on the same inputs.  Its solve_stokes runs as it is, the solves at
one mesh size so that their eager builds share those compiles.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

from tpufem.fem.space import VectorFunctionSpace as JVectorFunctionSpace
from tpufem.mesh.box import box_mesh as j_box_mesh
from tpufem.mesh.rectangle import rectangle_mesh as j_rectangle_mesh
from tpufem.solve import stokes as jst

from tpufem_torch.mesh.box import box_mesh
from tpufem_torch.mesh.rectangle import rectangle_mesh
from tpufem_torch.solve import stokes as tst

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """One BLAS thread a test, as one torch thread: numpy's OpenBLAS
    threads spin against the other workers on the shared CPU (a 729 x 729
    inverse takes seconds on eight, 0.07 s on one)."""
    with threadpool_limits(1, user_api="blas"):
        yield


@pytest.fixture(autouse=True)
def _jax_gather_products(monkeypatch):
    # the JAX package's ELL products as XLA gathers, not its Pallas kernel
    # in interpret mode (the same sums, seconds faster on the CPU)
    monkeypatch.setenv("TPUFEM_BAND_DISPATCH", "0")

_FIELDS = ("Ke", "Be", "conn_v", "conn_q", "free_v", "diag_a", "mp_lumped")


def _meshes(case):
    if case == "square6":
        args = (0.0, 1.0, 0.0, 1.0, 6, 6)
        return j_rectangle_mesh(*args), rectangle_mesh(*args)
    args = (0.0, 1.0, 0.0, 1.0, 0.0, 1.0, 4, 4, 4)
    return j_box_mesh(*args), box_mesh(*args)


@functools.lru_cache(maxsize=None)
def _built(case):
    """(JAX mesh, its (op, V), port mesh, its (op, V)); the JAX operator
    from build_stokes staged under jax.jit (the spaces are host objects,
    built as build_stokes builds them)."""
    jm, tm = _meshes(case)
    jop = jax.jit(lambda: jst.build_stokes(jm, viscosity=0.7)[0])()
    top, tV, _ = tst.build_stokes(tm, viscosity=0.7, device="cpu")
    return jm, (jop, JVectorFunctionSpace(jm, degree=2)), tm, (top, tV)


def _ops(case):
    _, (jop, _), _, (top, _) = _built(case)
    return jop, top


def _lid(X):
    """examples/stokes_cavity.py's regularized lid."""
    on_top = (np.abs(X[..., 1] - 1.0) < 1e-12).astype(float)
    profile = 16.0 * (X[..., 0] * (1 - X[..., 0])) ** 2
    return np.stack([on_top * profile, 0.0 * X[..., 0]], axis=-1)


def _close(a, ref, rel):
    ref = np.asarray(ref, np.float64)
    a = np.asarray(a, np.float64)
    assert a.shape == ref.shape
    assert np.abs(a - ref).max() <= rel * max(np.abs(ref).max(), 1e-300)


@pytest.mark.parametrize("case", ["square6", "cube4"])
def test_operator_arrays_match_jax(case):
    jop, top = _ops(case)
    assert [f.name for f in dataclasses.fields(top)] \
        == list(_FIELDS)
    for name in _FIELDS:
        a, ref = getattr(top, name), np.asarray(getattr(jop, name))
        if ref.dtype.kind in "biu":
            assert np.array_equal(a.numpy(), ref), name
        else:
            _close(a.numpy(), ref, 1e-12)
    assert (top.nv, top.nq) == (jop.nv, jop.nq)


@pytest.mark.parametrize("case", ["square6", "cube4"])
def test_products_match_jax_and_are_symmetric(case):
    jop, top = _ops(case)
    rng = np.random.default_rng(17)
    n = top.nv + top.nq
    x, y = rng.standard_normal(n), rng.standard_normal(n)
    f_v, u_bc = rng.standard_normal(top.nv), rng.standard_normal(top.nv)
    u_bc = np.where(top.free_v.numpy(), 0.0, u_bc)
    t = torch.as_tensor

    def ref(name, *args):
        """The JAX operator's method, staged (the operator an argument)."""
        return jax.jit(lambda o, *a: getattr(o, name)(*a))(
            jop, *(jnp.asarray(a) for a in args))

    _close(top.matvec(t(x)).numpy(), ref("matvec", x), 1e-12)
    _close(top.precond(t(x)).numpy(), ref("precond", x), 1e-12)
    _close(top.rhs(t(f_v), t(u_bc)).numpy(), ref("rhs", f_v, u_bc), 1e-12)
    for blk, arg in (("apply_a", x[:top.nv]), ("apply_b", x[:top.nv]),
                     ("apply_bt", x[top.nv:])):
        _close(getattr(top, blk)(t(arg)).numpy(), ref(blk, arg), 1e-12)
    # <x, K y> = <K x, y>: the projections keep the operator symmetric
    kx, ky = top.matvec(t(x)), top.matvec(t(y))
    lhs, rhs = torch.dot(t(x), ky).item(), torch.dot(kx, t(y)).item()
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)


def test_velocity_amg_matches_jax():
    """The 6 x 6 square's operator with coarse_n = 10: two levels on the
    169 scalar P2 rows (169 -> 13 -> 1); the same RCM permutation, level
    shapes and coarsest size, and the block preconditioner on a seeded
    vector to 1e-12."""
    jm, (jop, jV), tm, (top, tV) = _built("square6")
    kw = dict(viscosity=0.7, coarse_n=10)
    jw, tw = {}, {}
    jh, jperm, jinv = jst.build_velocity_amg(jm, jV, walls_out=jw, **kw)
    th, tperm, tinv = tst.build_velocity_amg(tm, tV, walls_out=tw,
                                             device="cpu", **kw)
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))
    shapes = [tuple(lv.A.data.shape) for lv in th.levels]
    assert len(shapes) >= 2
    assert shapes == [tuple(np.asarray(lv.A.data).shape)
                      for lv in jh.levels]
    assert th.coarse_inv.shape == np.asarray(jh.coarse_inv).shape
    assert set(jw) <= set(tw) and "scalar_system" in tw
    r = np.random.default_rng(23).standard_normal(top.nv + top.nq)
    Mt = tst.velocity_amg_precond(top, th, tperm, tinv, 2)
    Mj = jax.jit(lambda op, h, p, i, v: jst.velocity_amg_precond(
        op, h, p, i, 2)(v))
    _close(Mt(torch.as_tensor(r)).numpy(),
           Mj(jop, jh, jperm, jinv, jnp.asarray(r)), 1e-12)


def _body_force_jax(x):
    return jnp.stack([jnp.sin(2 * x[..., 0]), jnp.cos(2 * x[..., 1])], -1)


def _body_force_torch(x):
    return torch.stack([torch.sin(2 * x[..., 0]), torch.cos(2 * x[..., 1])],
                       -1)


_SOLVES = {
    # name: (n, velocity_precond, lid, body force, amg_kw)
    "jacobi_lid": (8, "jacobi", True, False, None),
    "amg_body_force": (8, "amg", False, True, dict(coarse_n=100)),
}


@functools.lru_cache(maxsize=None)
def _solves(name):
    n, vp, lid, force, amg_kw = _SOLVES[name]
    kw = dict(bc_velocity=_lid if lid else None, tol=1e-8,
              velocity_precond=vp, amg_kw=amg_kw)
    ref = jst.solve_stokes(j_rectangle_mesh(0, 1, 0, 1, n, n),
                           body_force=_body_force_jax if force else None,
                           **kw)
    mesh = rectangle_mesh(0, 1, 0, 1, n, n)
    sol = tst.solve_stokes(mesh,
                           body_force=_body_force_torch if force else None,
                           device="cpu", **kw)
    return ref, sol, mesh


@pytest.mark.parametrize("name", list(_SOLVES))
def test_solve_stokes_matches_jax(name):
    ref, sol, _ = _solves(name)
    assert sol.res.converged and bool(ref.res.converged)
    assert sol.res.iterations == int(ref.res.iterations)
    _close(sol.u.numpy(), ref.u, 1e-8)
    _close(sol.p.numpy(), ref.p, 1e-8)
    assert abs(sol.p.mean().item()) <= 1e-12 * sol.p.abs().max().item()
    assert sol.V.num_dofs == ref.V.num_dofs
    assert sol.Q.num_scalar_dofs == ref.Q.num_scalar_dofs
    keys = {"build", "solve"} | ({"precond_setup", "precond_setup_detail"}
                                 if _SOLVES[name][1] == "amg" else set())
    assert set(sol.walls) == keys


def test_discrete_divergence_free():
    """B u ~ 0 at convergence, the bound tests/test_stokes.py sets for the
    JAX package on its n = 8 Jacobi solve to 1e-10 with a body force."""
    mesh = rectangle_mesh(0, 1, 0, 1, 8, 8)
    sol = tst.solve_stokes(mesh, body_force=_body_force_torch, tol=1e-10,
                           maxiter=4000, device="cpu")
    assert sol.res.converged
    op, _, _ = tst.build_stokes(mesh, device="cpu")
    div = op.apply_b(sol.u)
    div = div - div.mean()
    bnorm = (torch.linalg.vector_norm(div)
             / max(torch.linalg.vector_norm(sol.u).item(), 1e-30))
    assert bnorm < 1e-8, bnorm


def test_fp32_amg_cavity_count():
    """tests/test_stokes.py's fp32 AMG cavity at n = 12 (tol 1e-6): the
    port's count within one check_every batch of the reference's, fp32
    throughout, the lid imposed."""
    kw = dict(bc_velocity=_lid, tol=1e-6, maxiter=4000,
              velocity_precond="amg")
    ref = jst.solve_stokes(j_rectangle_mesh(0, 1, 0, 1, 12, 12),
                           dtype=jnp.float32, **kw)
    sol = tst.solve_stokes(rectangle_mesh(0, 1, 0, 1, 12, 12),
                           dtype=torch.float32, device="cpu", **kw)
    assert sol.res.converged and bool(ref.res.converged)
    assert abs(sol.res.iterations - int(ref.res.iterations)) <= 4
    assert sol.u.dtype == torch.float32 and sol.p.dtype == torch.float32
    u = sol.u.numpy().reshape(-1, 2)
    top = np.abs(sol.V.scalar_dof_coords[:, 1] - 1.0) < 1e-12
    assert u[top, 0].max() > 0.9
    _close(sol.u.numpy(), ref.u, 1e-3)


def test_unknown_velocity_precond_raises():
    with pytest.raises(ValueError, match="velocity_precond"):
        tst.solve_stokes(rectangle_mesh(0, 1, 0, 1, 2, 2),
                         velocity_precond="ilu", device="cpu")
