"""Port parity, the elasticity slice: tpufem_torch.solve.elasticity
``solve_elasticity`` against the JAX package's on the CPU (float64), for
both ``matvec`` branches ("gather": BCSRMatrix.matvec; "pallas": RCM and
the banded block kernel's plain version here, the TPU kernel in interpret
mode on the JAX side).  Affine Dirichlet data in 2D and 3D (P1 reproduces
u = A x + c exactly) and a body-force solve: solutions within 1e-10, equal
iteration counts."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpufem.mesh.box import box_mesh as jax_box_mesh
from tpufem.mesh.rectangle import rectangle_mesh as jax_rectangle_mesh
from tpufem.solve.elasticity import solve_elasticity as jax_solve

from tpufem_torch.mesh.box import box_mesh
from tpufem_torch.mesh.rectangle import rectangle_mesh
from tpufem_torch.solve.elasticity import solve_elasticity

# several pytest workers share the CPU: one intra-op thread each keeps
# the many small tensor ops from oversubscribing it
torch.set_num_threads(1)

_MESHES = {"2d": lambda m: m(0, 1, 0, 2, 5, 4),
           "3d": lambda m: m(0, 1, 0, 1, 0, 1, 3, 3, 3)}


def _pair(dim):
    make = _MESHES[dim]
    if dim == "2d":
        return make(jax_rectangle_mesh), make(rectangle_mesh)
    return make(jax_box_mesh), make(box_mesh)


def _solves(jmesh, mesh, matvec, jax_kw, port_kw, **kw):
    """(the JAX package's solution, the port's) of the same problem;
    ``jax_kw`` / ``port_kw`` hold the arguments each package takes in its
    own array type."""
    ref = jax_solve(jmesh, matvec=matvec, interpret=matvec == "pallas",
                    **jax_kw, **kw)
    sol = solve_elasticity(mesh, matvec=matvec, device="cpu", **port_kw,
                           **kw)
    return ref, sol


@pytest.mark.parametrize("matvec", ["gather", "pallas"])
@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_affine_displacement_matches_jax(dim, matvec):
    """f = 0 with affine Dirichlet data (tests/test_elasticity.py:18-32)."""
    jmesh, mesh = _pair(dim)
    d = mesh.dim
    rng = np.random.default_rng(0)
    Amat = rng.standard_normal((d, d)) * 0.1
    c = rng.standard_normal(d)
    g = (mesh.coords @ Amat.T + c).reshape(-1)
    ref, sol = _solves(jmesh, mesh, matvec, dict(bc_values=jnp.asarray(g)),
                       dict(bc_values=g), lam=1.3, mu=0.6, tol=1e-12)
    assert sol.cg.converged and bool(ref.cg.converged)
    assert sol.cg.iterations == int(ref.cg.iterations)
    u = sol.u.numpy()
    assert np.abs(u - np.asarray(ref.u)).max() <= 1e-10
    np.testing.assert_allclose(u, g, rtol=1e-8, atol=1e-9)
    assert sol.u.shape == (sol.space.num_dofs,) and sol.A.block_size == d


@pytest.mark.parametrize("matvec", ["gather", "pallas"])
def test_body_force_solve_matches_jax(matvec):
    """f = (1, y) on the unit square (tests/test_elasticity.py:35-57), and
    the walls of every phase."""
    jmesh, mesh = jax_rectangle_mesh(0, 1, 0, 1, 4, 4), rectangle_mesh(
        0, 1, 0, 1, 4, 4)
    jf = lambda x: jnp.stack([0 * x[..., 0] + 1.0, x[..., 1]], axis=-1)
    tf = lambda x: torch.stack([0 * x[..., 0] + 1.0, x[..., 1]], dim=-1)
    ref, sol = _solves(jmesh, mesh, matvec, dict(body_force=jf),
                       dict(body_force=tf), lam=1.0, mu=1.0, tol=1e-12)
    assert sol.cg.converged and sol.cg.iterations == int(ref.cg.iterations)
    u, u_ref = sol.u.numpy(), np.asarray(ref.u)
    assert np.abs(u - u_ref).max() <= 1e-10 * np.abs(u_ref).max()
    assert set(sol.walls) == {"host_pattern", "element_matrices", "assemble",
                              "band_plan", "solve"}


def test_unported_options_raise():
    mesh = rectangle_mesh(0, 1, 0, 1, 3, 3)
    for kw, exc in ((dict(interpret=True), NotImplementedError),
                    (dict(aot=True), NotImplementedError),
                    (dict(precond="ilu"), ValueError),
                    (dict(matvec="dense"), ValueError)):
        with pytest.raises(exc):
            solve_elasticity(mesh, device="cpu", **kw)
