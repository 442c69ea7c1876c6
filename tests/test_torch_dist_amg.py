"""Port parity, the distributed interval-aggregation AMG
(tpufem_torch.dist.amg) against the JAX package's tpufem.dist.amg, float64
on host meshes of 2 and 4 shards: the sharded W-cycle equals the
single-device cycle of the same padded system within 1e-10 (the
reference's own criterion, tests/test_dist_amg.py:57); the host hierarchy
(every level's partition, the interval scales, the static metadata,
coarse_inv) equals the JAX package's exactly; a JAX-built one carried
across (convert.py) solves the same; the sharded AMG-PCG takes the JAX
package's single-device AMG-PCG count on the padded system; a system at
or below coarse_n builds no level."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpufem.dist import amg as jdamg
from tpufem.solve.cg import cg as jax_cg

from tpufem_torch.assemble.dense import assemble_vector
from tpufem_torch.assemble.ell import assemble_ell
from tpufem_torch.assemble.local import element_load, p1_stiffness
from tpufem_torch.convert import dist_amg_hierarchy_from_numpy
from tpufem_torch.dist import amg as damg
from tpufem_torch.dist.mesh import make_mesh
from tpufem_torch.fem.elements import P1Triangle
from tpufem_torch.fem.quadrature import triangle_rule
from tpufem_torch.mesh.adjacency import ell_pattern, reverse_cuthill_mckee
from tpufem_torch.mesh.rectangle import perturbed_rectangle_mesh
from tpufem_torch.solve.bc import apply_dirichlet_ell
from tpufem_torch.solve.cg import cg
from tpufem_torch.solve.poisson import model_problem_2d
from tpufem_torch.sparse.ell import reorder_ell

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def jax_gather(monkeypatch):
    monkeypatch.setenv("TPUFEM_BAND_DISPATCH", "0")


@functools.lru_cache(maxsize=None)
def _system(n):
    """The RCM-ordered, Dirichlet-eliminated P1 model problem on the
    perturbed n x n square (the reference test's system), assembled by
    the port: (data, cols, b) numpy."""
    mesh = perturbed_rectangle_mesh(-3, 3, -3, 3, n, n, jitter=0.25, seed=0)
    pat = ell_pattern(mesh.conn, mesh.num_nodes, pad_to=8)
    ec = torch.as_tensor(mesh.element_coords())
    A = assemble_ell(pat, p1_stiffness(ec, P1Triangle()))
    b = assemble_vector(mesh.conn, element_load(
        ec, P1Triangle(), triangle_rule(5), model_problem_2d()[0]),
        mesh.num_nodes)
    A, b = apply_dirichlet_ell(A, b, torch.as_tensor(mesh.node_flags != 0))
    perm = reverse_cuthill_mckee(A.cols.numpy())
    data, cols = reorder_ell(A.data, A.cols, perm)
    return data, cols, b.numpy()[perm]


@pytest.mark.parametrize("shards", [2, 4])
def test_dist_cycle_matches_single_device(shards):
    data, cols, _ = _system(24)
    h = damg.build_dist_amg(data, cols, shards, coarse_n=40, keep_base=True)
    assert len(h.level_arrays) >= 2        # recursion and W visits
    for st in h.static[:-1]:
        assert st.local_rows % st.s == 0   # the shard-local invariant
    r = np.zeros(h.np_rows)
    r[:h.n] = np.random.default_rng(0).standard_normal(h.n)
    z = damg.dist_amg_apply(h, r, make_mesh(shards, ("rows",),
                                            device="cpu")).numpy()
    z_base = h.base.apply(torch.as_tensor(r)).numpy()
    np.testing.assert_allclose(z, z_base, rtol=1e-10, atol=1e-12)


def _assert_same(hj, ht):
    assert len(hj.level_arrays) == len(ht.level_arrays)
    for aj, at in zip(hj.level_arrays, ht.level_arrays):
        for x, y in zip(aj, at):
            np.testing.assert_array_equal(y, np.asarray(x))
    for x, y in zip(hj.fine_arrays, ht.fine_arrays):
        np.testing.assert_array_equal(y, np.asarray(x))
    assert tuple(hj.static) == tuple(tuple(st) for st in ht.static)
    np.testing.assert_array_equal(ht.coarse_inv, np.asarray(hj.coarse_inv))
    for f in ("fine_halo", "smoother_degree", "smoother_ratio", "gamma",
              "n", "np_rows", "num_shards"):
        assert getattr(ht, f) == getattr(hj, f), f


def test_same_host_hierarchy_and_reference_count():
    """The port's host hierarchy equals the JAX package's; its sharded
    AMG-PCG on 4 shards takes the JAX single-device AMG-PCG count on the
    padded system (the reference's test allows one apart), its x within
    1e-8; the carried JAX hierarchy solves identically."""
    data, cols, b = _system(24)
    hj = jdamg.build_dist_amg(data, cols, 4, coarse_n=40, keep_base=True)
    ht = damg.build_dist_amg(data, cols, 4, coarse_n=40)
    _assert_same(hj, ht)
    assert ht.gamma == 2                    # the reference's W default
    mesh = make_mesh(4, ("rows",), device="cpu")
    x, res = damg.dist_amg_pcg(ht, b, mesh, tol=1e-10, maxiter=100)
    assert res.converged
    Ap = hj.base.levels[0].A
    bp = jnp.asarray(np.pad(b, (0, hj.np_rows - hj.n)))
    ref = jax.jit(lambda v: jax_cg(Ap.matvec, v, tol=1e-10, maxiter=100,
                                   M=hj.base.apply))(bp)
    assert bool(ref.converged) and res.iterations == int(ref.iterations)
    np.testing.assert_allclose(x.numpy(), np.asarray(ref.x)[:hj.n],
                               rtol=0, atol=1e-8)
    x2, res2 = damg.dist_amg_pcg(dist_amg_hierarchy_from_numpy(hj), b, mesh,
                                 tol=1e-10, maxiter=100)
    assert res2.iterations == res.iterations
    np.testing.assert_array_equal(x2.numpy(), x.numpy())


def test_zero_levels_tiny_system():
    """A system at or below coarse_n: no level, the preconditioner is the
    replicated dense inverse, the solve converges at once."""
    data, cols, b = _system(12)
    h = damg.build_dist_amg(data, cols, 4)
    assert h.level_arrays == () and h.base is None
    x, res = damg.dist_amg_pcg(h, b, make_mesh(4, ("rows",), device="cpu"),
                               tol=1e-10, maxiter=20)
    assert res.converged and res.iterations <= 3
    from tpufem_torch.sparse.ell import ELLMatrix
    A = ELLMatrix(torch.as_tensor(data), torch.as_tensor(cols))
    ref = cg(A.matvec, torch.as_tensor(b), tol=1e-12, maxiter=2000)
    np.testing.assert_allclose(x.numpy(), ref.x.numpy(), rtol=0, atol=1e-8)
