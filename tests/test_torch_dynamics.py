"""Explicit leapfrog dynamics: tpufem_torch.solve.dynamics against the JAX
package on the CPU, fp64.

Both packages assemble the stiffness of the same mesh with their weak forms
(ELL) and lump the mass through it; the initial states come from a numpy
seed.  The stable step's power iteration starts from each package's own
random stream, so it is compared after enough iterations to converge.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpufem.fem.space import FunctionSpace as JFunctionSpace
from tpufem.forms.language import dot as jdot
from tpufem.forms.language import grad as jgrad
from tpufem.forms.weakform import WeakForm as JWeakForm
from tpufem.mesh.rectangle import perturbed_rectangle_mesh as j_perturbed
from tpufem.mesh.rectangle import perturbed_quad_mesh as j_perturbed_quad
from tpufem.mesh.rectangle import rectangle_quad_mesh as j_quad_mesh
from tpufem.solve import dynamics as jdyn

from tpufem_torch.assemble.stencil import assemble_stencil
from tpufem_torch.assemble.local import p1_stiffness
from tpufem_torch.dist import partition as tpart
from tpufem_torch.dist.dynamics import leapfrog_wave_sharded
from tpufem_torch.dist.mesh import make_mesh
from tpufem_torch.fem.elements import P1Triangle
from tpufem_torch.fem.space import FunctionSpace
from tpufem_torch.forms.language import dot, grad
from tpufem_torch.forms.weakform import WeakForm
from tpufem_torch.mesh.rectangle import (perturbed_quad_mesh,
                                         perturbed_rectangle_mesh,
                                         rectangle_mesh, rectangle_quad_mesh)
from tpufem_torch.solve.bc import apply_dirichlet_stencil
from tpufem_torch.solve.dynamics import (WaveResult, leapfrog_wave,
                                         lumped_mass, stable_dt)
from tpufem_torch.sparse.stencil import stencil_matvec, stencil_pattern

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _jax_gather_products(monkeypatch):
    # the JAX package's ELL products as XLA gathers, not its Pallas kernel
    # in interpret mode (the same sums, seconds faster on the CPU)
    monkeypatch.setenv("TPUFEM_BAND_DISPATCH", "0")


def _meshes(kind):
    """The (port, JAX) mesh of a case.  "tri_gap" / "quad_gap": top
    eigenvalues of M_L^-1 K apart by a ratio of 0.89 / 0.94, so that 300
    power iterations converge from any start (the uniform quad mesh's two
    largest are 0.977 apart; 0.977^600 leaves 1e-6)."""
    if kind in ("tri", "tri_gap"):
        args = (0, 1, 0, 1, 12, 12)
        kw = dict(jitter=0.2, seed=9 if kind == "tri" else 5)
        return perturbed_rectangle_mesh(*args, **kw), j_perturbed(*args,
                                                                  **kw)
    if kind == "quad_gap":
        args, kw = (0, 2, 0, 1, 10, 8), dict(jitter=0.25, seed=1)
        return perturbed_quad_mesh(*args, **kw), j_perturbed_quad(*args,
                                                                  **kw)
    return rectangle_quad_mesh(0, 2, 0, 1, 10, 8), j_quad_mesh(0, 2, 0, 1,
                                                               10, 8)


@functools.lru_cache(maxsize=None)
def _systems(kind):
    """(port K, mL, mask; JAX K, mL, mask) on the same mesh."""
    mesh, jmesh = _meshes(kind)
    V = FunctionSpace(mesh, degree=1)
    K, _ = WeakForm(V, device="cpu").build(
        lambda u, v: dot(grad(u), grad(v))).assemble(format="ell")
    mL = lumped_mass(V, device="cpu")
    jV = JFunctionSpace(jmesh, degree=1)
    jK, _ = JWeakForm(jV).build(
        lambda u, v: jdot(jgrad(u), jgrad(v))).assemble(format="ell")
    jmL = jdyn.lumped_mass(jV)
    return (K, mL, torch.as_tensor(V.dof_flags),
            jK, jmL, jnp.asarray(jV.dof_flags))


def _close(got, ref, tol):
    ref = np.asarray(ref)
    scale = max(np.abs(ref).max(), 1e-300)
    assert np.abs(got.numpy() - ref).max() <= tol * scale


@pytest.mark.parametrize("kind", ["tri", "quad"])
def test_lumped_mass_matches_jax(kind):
    K, mL, _, _, jmL, _ = _systems(kind)
    assert mL.dtype == torch.float64 and mL.device.type == "cpu"
    _close(mL, jmL, 1e-13)
    np.testing.assert_allclose(float(mL.sum()), 1.0 if kind == "tri" else
                               2.0, rtol=1e-12)


@pytest.mark.parametrize("kind", ["tri_gap", "quad_gap"])
def test_stable_dt_matches_jax_at_300_iterations(kind):
    K, mL, _, jK, jmL, _ = _systems(kind)
    got = stable_dt(K.matvec, mL, iters=300)
    ref = jdyn.stable_dt(jK.matvec, jmL, iters=300)
    assert isinstance(got, float)
    assert abs(got - ref) <= 1e-6 * ref
    # both at the dense generalized eigenvalue's step
    lam = np.linalg.eigvalsh(K.to_dense().numpy()
                             / np.sqrt(np.outer(mL.numpy(), mL.numpy())))
    assert abs(got - 0.9 * 2.0 / np.sqrt(lam[-1])) <= 1e-6 * got
    # a seeded start: the same step again
    assert stable_dt(K.matvec, mL, iters=300) == got


@pytest.mark.parametrize("kind,bc,forced", [
    ("tri", True, False), ("tri", False, False), ("tri", True, True),
    ("quad", True, False), ("quad", False, True)])
def test_leapfrog_wave_matches_jax(kind, bc, forced):
    K, mL, mask, jK, jmL, jmask = _systems(kind)
    n = mL.shape[0]
    rng = np.random.default_rng(4)
    u0, v0, f = (rng.standard_normal(n) for _ in range(3))
    dt = 0.5 * jdyn.stable_dt(jK.matvec, jmL)
    steps = 120
    kw, jkw = {}, {}
    if bc:
        kw["bc_mask"], jkw["bc_mask"] = mask, jmask
    if forced:
        ft, jf = torch.as_tensor(f), jnp.asarray(f)
        kw["forcing"] = lambda t: ft * np.cos(3.0 * t)
        jkw["forcing"] = lambda t: jf * jnp.cos(3.0 * t)
    ref = jdyn.leapfrog_wave(jK.matvec, jmL, jnp.asarray(u0),
                             jnp.asarray(v0), dt, steps, **jkw)
    got = leapfrog_wave(K.matvec, mL, torch.as_tensor(u0),
                        torch.as_tensor(v0), dt, steps, **kw)
    assert isinstance(got, WaveResult)
    assert got.energy.shape == (steps - 1,)
    for a, b in zip(got, ref):
        _close(a, b, 1e-12)
    if bc:
        assert torch.all(got.u[mask] == 0) and torch.all(got.v[mask] == 0)
    if not forced:
        e = got.energy.numpy()
        assert np.abs(e - e[0]).max() / abs(e[0]) < 1e-10


def test_leapfrog_wave_one_step_and_no_trace():
    K, mL, _, jK, jmL, _ = _systems("tri")
    u0 = np.random.default_rng(5).standard_normal(mL.shape[0])
    got = leapfrog_wave(K.matvec, mL, u0, np.zeros_like(u0), 1e-3, 1)
    ref = jdyn.leapfrog_wave(jK.matvec, jmL, jnp.asarray(u0),
                             jnp.zeros(u0.shape[0]), 1e-3, 1)
    assert got.energy.shape == (0,)
    _close(got.u, ref.u, 1e-12)
    _close(got.v, ref.v, 1e-12)


def test_sharded_leapfrog_matches_the_port_single_device():
    """dist.dynamics.leapfrog_wave_sharded equals solve.dynamics'
    leapfrog_wave on the same stencil system (8 row stripes on the host),
    as tests/test_dist.py pins for the reference."""
    mesh = rectangle_mesh(-3, 3, -3, 3, 24, 24)
    nn = mesh.num_nodes
    A = assemble_stencil(stencil_pattern(mesh.conn, nn), p1_stiffness(
        torch.as_tensor(mesh.element_coords()), P1Triangle()))
    bc = torch.as_tensor(mesh.node_flags != 0)
    A, _ = apply_dirichlet_stencil(A, torch.zeros(nn, dtype=torch.float64),
                                   bc)
    offsets = tuple(int(o) for o in A.offsets)
    c = mesh.coords
    u0 = torch.where(bc, 0.0, torch.as_tensor(
        np.sin(np.pi * (c[:, 0] + 3) / 6) * np.sin(np.pi * (c[:, 1] + 3) / 6)))
    mL = torch.full((nn,), 0.5, dtype=torch.float64)
    dt, steps = 1e-3, 25
    ref = leapfrog_wave(lambda u: stencil_matvec(A.data, offsets, u), mL,
                        u0, torch.zeros(nn, dtype=torch.float64), dt, steps,
                        bc_mask=bc)
    data_p, u0_p, n_orig = tpart.pad_rows(A.data, u0, offsets, 8,
                                          offsets.index(0))
    npad = u0_p.shape[0]
    mL_p = torch.cat([mL, torch.ones(npad - nn, dtype=torch.float64)])
    bc_p = torch.cat([bc, torch.ones(npad - nn, dtype=torch.bool)])
    res = leapfrog_wave_sharded(data_p, offsets, mL_p, u0_p,
                                torch.zeros(npad, dtype=torch.float64), dt,
                                steps, make_mesh(8, ("rows",), device="cpu"),
                                bc_mask=bc_p)
    u_s = res.u.unshard()[:n_orig]
    assert (u_s - ref.u).abs().max() <= 1e-10 * ref.u.abs().max()
    e, e_ref = res.energy, ref.energy
    assert (e - e_ref).abs().max() <= 1e-9 * e_ref[0].abs()
    assert ((e - e[0]).abs().max() / e[0].abs()).item() < 1e-9
