"""Port parity, the AMG-preconditioned elasticity solves:
solve_elasticity(precond="amg") (tpufem_torch.solve.elasticity, the block
AMG of solve.amg_block) against the JAX package's, float64 on the CPU, on
both matvec branches ("gather": the hierarchy over the assembled system;
"pallas": over the RCM-permuted one, the JAX side's kernel interpreted):
equal PCG iteration counts, solutions within 1e-10 relative."""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from tpufem.mesh.box import box_mesh as jax_box_mesh
from tpufem.mesh.rectangle import perturbed_rectangle_mesh as jax_perturbed
from tpufem.solve.elasticity import solve_elasticity as jax_solve

from tpufem_torch.mesh.box import box_mesh
from tpufem_torch.mesh.rectangle import perturbed_rectangle_mesh
from tpufem_torch.solve.elasticity import solve_elasticity

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """One BLAS thread a test, as one torch thread: numpy's OpenBLAS
    threads spin against the other workers on the shared CPU (a 729 x 729
    inverse takes seconds on eight, 0.07 s on one)."""
    with threadpool_limits(1, user_api="blas"):
        yield


@pytest.fixture(autouse=True)
def jax_gather(monkeypatch):
    """The JAX package's own switch: its ELL / BCSR products take XLA's
    gather instead of the interpreted Pallas kernel on the CPU (its
    "pallas" branch still runs the kernel, interpreted)."""
    monkeypatch.setenv("TPUFEM_BAND_DISPATCH", "0")


_MESHES = {2: lambda m: m(-1, 1, -1, 1, 20, 20, jitter=0.2, seed=0),
           3: lambda m: m(-1, 1, -1, 1, -1, 1, 6, 6, 6)}


@pytest.mark.parametrize("dim,matvec", [(2, "gather"), (3, "gather"),
                                        (2, "pallas")])
def test_solve_elasticity_amg_matches_the_reference(dim, matvec):
    """solve_elasticity(precond="amg"), f = (1, -0.5[, 0.25]): the fp64
    count equals the JAX package's; u within 1e-10 relative."""
    jmesh = _MESHES[dim](jax_perturbed if dim == 2 else jax_box_mesh)
    c = (1.0, -0.5, 0.25)[:dim]
    ref = jax_solve(jmesh, matvec=matvec, interpret=matvec == "pallas",
                    precond="amg", tol=1e-10, body_force=lambda x: jnp.stack(
                        [0 * x[..., i] + v for i, v in enumerate(c)], -1))
    sol = solve_elasticity(_MESHES[dim](perturbed_rectangle_mesh if dim == 2
                                        else box_mesh),
                           matvec=matvec, precond="amg",
                           tol=1e-10, device="cpu",
                           body_force=lambda x: torch.stack(
                               [0 * x[..., i] + v for i, v in enumerate(c)],
                               -1))
    assert sol.cg.converged and bool(ref.cg.converged)
    assert sol.cg.iterations == int(ref.cg.iterations)
    u_ref = np.asarray(ref.u)
    assert np.abs(sol.u.numpy() - u_ref).max() <= 1e-10 * np.abs(u_ref).max()
    assert {"precond_setup", "precond_setup_detail"} <= set(sol.walls)
