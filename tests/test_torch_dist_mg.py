"""Port parity, the distributed multigrid (tpufem_torch.dist.multigrid)
against the JAX package's tpufem.dist.multigrid on its 8 virtual CPU
devices: the hierarchy's arrays, the sharded MG-PCG in 3D and 2D, and the
replicated fallback.  Right-hand sides come from a manufactured solution
of a seeded numpy generator, as tests/test_dist_mg.py makes them; fp64."""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from tpufem.dist import multigrid as jdm

from tpufem_torch.convert import dist_levels_from_numpy
from tpufem_torch.dist import multigrid as tdm
from tpufem_torch.dist.mesh import Sharded, make_mesh, unshard

# several pytest workers share the CPU: one intra-op thread each keeps
# the many small tensor ops from oversubscribing it
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """One BLAS thread a test, as one torch thread: numpy's OpenBLAS
    threads spin against the other workers on the shared CPU (a 729 x 729
    inverse takes seconds on eight, 0.07 s on one)."""
    with threadpool_limits(1, user_api="blas"):
        yield

DOMAIN = (-3.0, 3.0)


def _manufactured(levels, seed=3):
    """(b [Zp, ...] z-padded, x_true [*node_grid]) with b = A x_true."""
    fine = levels[0]
    ng = fine.node_grid
    zp = fine.data.shape[1]
    xt = np.random.default_rng(seed).standard_normal(ng)
    xt = np.where(fine.bc_mask[:ng[0]], 0.0, xt)
    xt_p = np.pad(xt, [(0, zp - ng[0])] + [(0, 0)] * (len(ng) - 1))
    b = tdm.grid_stencil_matvec(torch.as_tensor(fine.data),
                                torch.as_tensor(xt_p), fine.offsets_grid,
                                None).numpy()
    b[ng[0]:] = 0.0
    return b, xt


@pytest.mark.parametrize("n, dim", [(16, 3), (16, 2), (15, 3), (32, 2)])
def test_hierarchy_equals_jax(n, dim):
    jl = jdm.build_dist_hierarchy(DOMAIN, n, dim, 8, dtype=np.float64)
    tl = tdm.build_dist_hierarchy(DOMAIN, n, dim, 8, dtype=np.float64)
    assert len(tl) == len(jl)
    for a, b in zip(jl, tl):
        assert (b.offsets_grid, b.node_grid, b.local_planes, b.distributed) \
            == (a.offsets_grid, a.node_grid, a.local_planes, a.distributed)
        for name in ("data", "inv_diag", "bc_mask", "coarse_inverse"):
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None) == (y is None), name
            if x is not None:
                assert np.array_equal(np.asarray(x), y), name
    # the converted JAX hierarchy is the port's
    for a, b in zip(dist_levels_from_numpy(jl), tl):
        assert a.distributed == b.distributed
        assert np.array_equal(a.data, b.data)
    # the specs put_hierarchy follows: stripes on distributed levels
    specs = tdm.shard_specs(tl)
    assert [s[0] for s in specs] == [((None, "z") if lv.distributed else ())
                                     for lv in tl]


@pytest.mark.parametrize("dim", [3, 2])
def test_mgpcg_dist_matches_jax(cpu_devices, dim):
    n = 16
    jl = jdm.build_dist_hierarchy(DOMAIN, n, dim, 8, dtype=np.float64)
    b, x_true = _manufactured(jl)
    jmesh = JaxMesh(np.array(cpu_devices[:8]), ("z",))
    # the reference's solve staged under jax.jit: its shard_map region,
    # called eagerly, dispatches op by op (seconds a V-cycle on the CPU);
    # staged it is the same program on the same inputs
    ref = jax.jit(lambda arrs, rhs: jdm.mgpcg_dist(
        jl, arrs, rhs, jmesh, tol=1e-10, maxiter=100))(
        jdm.put_hierarchy(jl, jmesh), jnp.asarray(b))
    mesh = make_mesh(8, ("z",), device="cpu")
    tl = dist_levels_from_numpy(jl)
    arrs = tdm.put_hierarchy(tl, mesh)
    assert sum(isinstance(a[0], Sharded) for a in arrs) \
        == sum(lv.distributed for lv in tl) >= 1
    res = tdm.mgpcg_dist(tl, arrs, b, mesh, tol=1e-10, maxiter=100)
    assert res.converged and bool(ref.converged)
    # fp64: the same count, x within 1e-10 of max|x|
    assert res.iterations == int(ref.iterations)
    x_ref = np.asarray(ref.x)
    x = unshard(res.x).numpy()
    assert np.abs(x - x_ref).max() <= 1e-10 * np.abs(x_ref).max()
    ng = jl[0].node_grid
    err = np.linalg.norm(x[:ng[0]] - x_true) / np.linalg.norm(x_true)
    assert err < 1e-8


def test_replicated_fallback():
    """n = 15 (odd): no level is distributed; the same math on one device
    (the reference's test_dist_mg_replicated_fallback)."""
    n = 15
    levels = tdm.build_dist_hierarchy(DOMAIN, n, 3, 8, dtype=np.float64)
    assert not any(lv.distributed for lv in levels)
    b, x_true = _manufactured(levels)
    ng = levels[0].node_grid
    u, res = tdm.solve_poisson_dist(DOMAIN, n, 3,
                                    make_mesh(8, ("z",), device="cpu"),
                                    b[:ng[0]].reshape(-1), dtype=np.float64,
                                    tol=1e-10, maxiter=100)
    assert res.converged
    err = np.linalg.norm(u - x_true.reshape(-1)) / np.linalg.norm(x_true)
    assert err < 1e-8
