"""Port parity, the multi-device path (tpufem_torch.dist) against the JAX
package's tpufem.dist on the conftest's 8 virtual CPU devices: the mesh's
collectives against ppermute / psum / all_gather under jax.shard_map, the
row padding, the halo stencil matvec and CG, the ELL / BCSR partitions
and solvers, the sharded leapfrog, the 2D ("z", "y") CG and the port's
dry run.  Inputs come from seeded numpy generators; fp64 throughout."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as JP

from tpufem.assemble.dense import assemble_vector as j_assemble_vector
from tpufem.assemble.local import element_load as j_element_load
from tpufem.assemble.local import p1_stiffness as j_p1_stiffness
from tpufem.assemble.stencil import assemble_stencil as j_assemble_stencil
from tpufem.dist import cg as jdcg
from tpufem.dist import dynamics as jdyn
from tpufem.dist import ell as jdell
from tpufem.dist import partition as jpart
from tpufem.dist import stencil as jdst
from tpufem.dist import stencil2d as jd2
from tpufem.dist.multigrid import _analytic_level
from tpufem.fem.elements import P1Triangle as JP1Triangle
from tpufem.fem.quadrature import triangle_rule as j_triangle_rule
from tpufem.mesh.rectangle import rectangle_mesh as j_rectangle_mesh
from tpufem.solve.bc import apply_dirichlet_stencil as j_apply_dirichlet
from tpufem.solve.poisson import model_problem_2d as j_model_problem_2d
from tpufem.sparse.stencil import StencilMatrix as JStencilMatrix
from tpufem.sparse.stencil import stencil_pattern as j_stencil_pattern

from tpufem_torch.convert import bcsr_partition_from_numpy, \
    ell_partition_from_numpy
from tpufem_torch.dist import cg as tdcg
from tpufem_torch.dist import dynamics as tdyn
from tpufem_torch.dist import ell as tdell
from tpufem_torch.dist import mesh as tm
from tpufem_torch.dist import partition as tpart
from tpufem_torch.dist import stencil as tdst
from tpufem_torch.dist import stencil2d as td2
from tpufem_torch.dist.dryrun import dryrun_multichip
from tpufem_torch.sparse.stencil import StencilMatrix

# several pytest workers share the CPU: one intra-op thread each keeps
# the many small tensor ops from oversubscribing it
torch.set_num_threads(1)


def _jmesh(cpu_devices, axis="rows"):
    return JaxMesh(np.array(cpu_devices[:8]), (axis,))


def _tmesh(axis="rows", n=8):
    return tm.make_mesh(n, (axis,), device="cpu")


def _t(a):
    return torch.as_tensor(np.asarray(a))


@functools.lru_cache(maxsize=None)
def _poisson_system(n=20):
    """(data [K, NN], b [NN], offsets) of the 2D model problem with its
    Dirichlet rows eliminated, from the JAX package (fp64)."""
    mesh = j_rectangle_mesh(-3, 3, -3, 3, n, n)
    ec = jnp.asarray(mesh.element_coords())
    el = JP1Triangle()
    A = j_assemble_stencil(j_stencil_pattern(mesh.conn, mesh.num_nodes),
                           j_p1_stiffness(ec, el))
    f, _ = j_model_problem_2d()
    b = j_assemble_vector(mesh.conn, j_element_load(ec, el,
                                                    j_triangle_rule(5), f),
                          mesh.num_nodes)
    A, b = j_apply_dirichlet(A, b, jnp.asarray(mesh.node_flags != 0))
    return np.asarray(A.data), np.asarray(b), tuple(A.offsets), mesh


# -- the mesh and its collectives (exact) ------------------------------------

def test_collectives_match_shard_map(cpu_devices):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(8 * 5)
    perm = [(i, (i + 1) % 8) for i in range(8)]
    part = [(i, i - 1) for i in range(2, 8)]        # shards 0, 7 get zeros

    @functools.partial(jax.shard_map, mesh=_jmesh(cpu_devices),
                       in_specs=JP("rows"),
                       out_specs=(JP("rows"), JP("rows"), JP(), JP(),
                                  JP("rows")), check_vma=False)
    def ref(v):
        return (jax.lax.ppermute(v, "rows", perm),
                jax.lax.ppermute(v[:2], "rows", part),
                jax.lax.psum(jnp.vdot(v, v), "rows"),
                jax.lax.all_gather(v, "rows", axis=0, tiled=True),
                jnp.full(v.shape[:1], jax.lax.axis_index("rows"), v.dtype))

    r_ring, r_part, r_sum, r_all, r_idx = (np.asarray(a) for a in ref(x))
    mesh = _tmesh()
    xs = tm.shard(x, mesh, tm.P("rows"))
    assert tm.ppermute(xs, "rows", perm).unshard().numpy().tolist() \
        == r_ring.tolist()
    assert tm.ppermute(xs[:2], "rows", part).unshard().numpy().tolist() \
        == r_part.tolist()
    dots = tm.smap(lambda v: torch.dot(v, v), xs)
    assert np.isclose(float(tm.psum(dots, "rows")), float(r_sum), rtol=1e-15)
    # psum adds in shard order, in the vectors' dtype
    want = dots.shards[0]
    for s in dots.shards[1:]:
        want = want + s
    assert float(tm.psum(dots, "rows")) == float(want)
    assert tm.all_gather(xs, "rows").numpy().tolist() == r_all.tolist()
    assert np.repeat(tm.axis_index(mesh, "rows"), 5).tolist() \
        == r_idx.tolist()
    # ring halos: neighbours' end slabs, zeros at the global ends
    lo, hi = tm.ring_halos(xs[:1], xs[-1:], "rows")
    blocks = x.reshape(8, 5)
    assert [float(s[0]) for s in lo.shards] == [0.0] + blocks[:-1, -1].tolist()
    assert [float(s[0]) for s in hi.shards] == blocks[1:, 0].tolist() + [0.0]


def test_mesh_2d_shard_unshard_and_psum():
    mesh = tm.make_mesh((4, 2), ("z", "y"), device="cpu")
    assert mesh.shape == {"z": 4, "y": 2} and mesh.size == 8
    x = torch.arange(8 * 6 * 3, dtype=torch.float64).reshape(8, 6, 3)
    xs = tm.shard(x, mesh, tm.P("z", "y", None))
    assert xs.local_shape == (2, 3, 3)
    assert torch.equal(xs.unshard(), x)
    assert torch.equal(xs.shards[3], x[2:4, 3:6])       # coords (1, 1)
    sums = tm.smap(lambda v: v.sum(), xs)
    assert float(tm.psum(sums, ("z", "y"))) == float(x.sum())
    with pytest.raises(NotImplementedError, match="every mesh axis"):
        tm.psum(sums, "z")


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no CUDA device")
def test_mesh_runs_on_the_card_unless_asked():
    # the default is the card: without one the constructor raises, it
    # never silently builds a host mesh
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.make_mesh(4)
    assert tm.make_mesh(4, device="cpu").device_list == [
        torch.device("cpu")] * 4


def test_pad_rows_matches_jax():
    data, b, offsets, _ = _poisson_system()
    diag_k = offsets.index(0)
    for shards in (8, 7, 1):
        jd, jb, jn = jpart.pad_rows(jnp.asarray(data), jnp.asarray(b),
                                    offsets, shards, diag_k)
        td, tb, tn = tpart.pad_rows(_t(data), _t(b), offsets, shards, diag_k)
        assert tn == jn and tpart.padded_size(441, shards) \
            == jpart.padded_size(441, shards)
        assert np.array_equal(td.numpy(), np.asarray(jd))
        assert np.array_equal(tb.numpy(), np.asarray(jb))


# -- halo stencil matvec and CG ----------------------------------------------

def test_sharded_stencil_matvec_matches_jax(cpu_devices):
    data, _, offsets, _ = _poisson_system()
    data_p, _, n = jpart.pad_rows(jnp.asarray(data), jnp.ones(441), offsets,
                                  8, offsets.index(0))
    x = np.random.default_rng(1).standard_normal(data_p.shape[1])

    @functools.partial(jax.shard_map, mesh=_jmesh(cpu_devices),
                       in_specs=(JP(None, "rows"), JP("rows")),
                       out_specs=JP("rows"))
    def mv(d, v):
        return jdst.sharded_stencil_matvec(d, v, offsets, "rows")

    ref = np.asarray(mv(data_p, jnp.asarray(x)))
    mesh = _tmesh()
    y = tdst.sharded_stencil_matvec(
        tm.shard(_t(data_p), mesh, tm.P(None, "rows")),
        tm.shard(_t(x), mesh, tm.P("rows")), offsets, "rows").unshard()
    # the same products in the same order: within 1e-12 of max|y|
    assert np.abs(y.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()


def test_stencil_cg_and_solve_match_jax(cpu_devices):
    data, b, offsets, _ = _poisson_system()
    jx, jres = jdcg.distributed_stencil_solve(
        JStencilMatrix(jnp.asarray(data), offsets), jnp.asarray(b),
        _jmesh(cpu_devices), tol=1e-11, maxiter=3000)
    mesh = _tmesh()
    tx, tres = tdcg.distributed_stencil_solve(
        StencilMatrix(_t(data), offsets), _t(b), mesh, tol=1e-11,
        maxiter=3000)
    assert tres.converged and bool(jres.converged) and not tres.diverged
    # fp64: the same count, x within 1e-10 of max|x|
    assert tres.iterations == int(jres.iterations)
    jx = np.asarray(jx)
    assert np.abs(tx.numpy() - jx).max() <= 1e-10 * np.abs(jx).max()
    # stencil_cg_sharded on the padded system, without the Jacobi scaling
    data_p, b_p, n = tpart.pad_rows(_t(data), _t(b), offsets, 8,
                                    offsets.index(0))
    res = tdcg.stencil_cg_sharded(data_p, offsets, b_p, mesh, tol=1e-11,
                                  maxiter=3000, diag_precondition=False)
    jres2 = jdcg.stencil_cg_sharded(
        jnp.asarray(data_p.numpy()), offsets, jnp.asarray(b_p.numpy()),
        _jmesh(cpu_devices), tol=1e-11, maxiter=3000,
        diag_precondition=False)
    assert res.converged and res.iterations == int(jres2.iterations)
    jx2 = np.asarray(jres2.x)
    assert np.abs(res.x.unshard().numpy() - jx2).max() \
        <= 1e-10 * np.abs(jx2).max()


def test_thin_stripe_raises_as_the_reference(cpu_devices):
    from tpufem.fem.elements import P1Tetrahedron
    from tpufem.mesh.box import box_mesh

    # 343 nodes, halo 57: stripes of 43 rows at 8 shards, 6 at 64
    mesh = box_mesh(0, 1, 0, 1, 0, 1, 6, 6, 6)
    A = j_assemble_stencil(j_stencil_pattern(mesh.conn, mesh.num_nodes),
                           j_p1_stiffness(jnp.asarray(mesh.element_coords()),
                                          P1Tetrahedron()))
    data, offsets = np.asarray(A.data), tuple(A.offsets)
    match = "thinner than the stencil halo"
    with pytest.raises(ValueError, match=match):
        jdcg.distributed_stencil_solve(A, jnp.ones(343), _jmesh(cpu_devices))
    for shards in (8, 64):
        with pytest.raises(ValueError, match=match):
            tdcg.distributed_stencil_solve(
                StencilMatrix(_t(data), offsets),
                torch.ones(343, dtype=torch.float64), _tmesh(n=shards))
    with pytest.raises(ValueError, match="not divisible"):
        tdcg.stencil_cg_sharded(_t(data), offsets, torch.ones(343),
                                _tmesh(n=8))


# -- ELL and BCSR partitions and solvers -------------------------------------

def _banded_ell(n=1000, k=8, band=60, seed=3):
    rng = np.random.default_rng(seed)
    cols = np.clip(np.arange(n)[:, None]
                   + rng.integers(-band, band + 1, size=(n, k)),
                   0, n - 1).astype(np.int32)
    cols[:, 0] = np.arange(n)
    # symmetric positive definite: diagonally dominant, symmetrised
    A = np.zeros((n, n))
    np.add.at(A, (np.repeat(np.arange(n), k), cols.reshape(-1)),
              rng.uniform(-1, 0, size=n * k))
    A = A + A.T
    A[np.arange(n), np.arange(n)] = np.abs(A).sum(1) + 1.0
    nz = np.abs(A) > 0
    width = nz.sum(1).max()
    data = np.zeros((n, width))
    cols = np.tile(np.arange(n)[:, None], (1, width)).astype(np.int32)
    for i in range(n):
        c = np.nonzero(nz[i])[0]
        c = np.concatenate([[i], c[c != i]])
        cols[i, :c.size] = c
        data[i, :c.size] = A[i, c]
    return data, cols, A


def test_ell_partition_and_solve_match_jax(cpu_devices):
    data, cols, A = _banded_ell()
    jp = jdell.ell_partition(data, cols, 8)
    tp = tdell.ell_partition(data, cols, 8)
    assert ell_partition_from_numpy(jp)._asdict().keys() == tp._asdict(
        ).keys()
    for name in ("data", "rel", "inv_diag"):
        assert np.array_equal(getattr(tp, name), getattr(jp, name)), name
    assert (tp.halo, tp.n, tp.local_rows, tp.num_shards) == (
        jp.halo, jp.n, jp.local_rows, jp.num_shards)
    b = np.random.default_rng(4).standard_normal(data.shape[0])
    mesh = _tmesh()
    x = np.random.default_rng(5).standard_normal(tp.data.shape[0])
    y = tdell.sharded_ell_matvec(
        tm.shard(_t(tp.data), mesh, tm.P("rows", None)),
        tm.shard(_t(tp.rel), mesh, tm.P("rows", None)),
        tm.shard(_t(x), mesh, tm.P("rows")), tp.halo, "rows").unshard()
    ref = A @ x[:data.shape[0]]
    assert np.abs(y.numpy()[:data.shape[0]] - ref).max() \
        <= 1e-12 * np.abs(ref).max()
    jx, jres = jdell.distributed_ell_solve(data, cols, b,
                                           _jmesh(cpu_devices), tol=1e-10)
    tx, tres = tdell.distributed_ell_solve(data, cols, b, mesh, tol=1e-10)
    assert tres.converged and tres.iterations == int(jres.iterations)
    assert np.abs(tx.numpy() - np.asarray(jx)).max() \
        <= 1e-10 * np.abs(np.asarray(jx)).max()
    # the converted JAX partition runs the same solve
    res = tdell.ell_cg_sharded(ell_partition_from_numpy(jp),
                               np.pad(b, (0, tp.data.shape[0] - tp.n)),
                               mesh, tol=1e-10)
    assert res.iterations == tres.iterations


def test_bcsr_partition_and_solve_match_jax(cpu_devices):
    from tpufem.fem.space import VectorFunctionSpace
    from tpufem.mesh.adjacency import ell_pattern
    from tpufem.solve.elasticity import elasticity_forms
    from tpufem.sparse.bcsr import apply_dirichlet_bcsr, assemble_bcsr

    mesh2 = j_rectangle_mesh(0.0, 1.0, 0.0, 1.0, 12, 12)
    V = VectorFunctionSpace(mesh2, degree=1)
    wf = elasticity_forms(V, 1.2, 0.7, lambda x: jnp.stack(
        [jnp.sin(x[..., 0]), x[..., 1] ** 2], axis=-1))
    ec = jnp.asarray(mesh2.element_coords())
    A = assemble_bcsr(ell_pattern(V.scalar_dof_conn, V.num_scalar_dofs,
                                  pad_to=8), wf.element_matrices(ec),
                      block_size=2)
    b = j_assemble_vector(V.dof_conn, wf.element_vectors(ec), V.num_dofs)
    A, b = apply_dirichlet_bcsr(A, b, jnp.asarray(V.dof_flags))
    data, cols = np.asarray(A.data), np.asarray(A.cols)

    jp = jdell.bcsr_partition(data, cols, 8)
    tp = tdell.bcsr_partition(data, cols, 8)
    for name in ("data", "rel", "inv_diag"):
        assert np.array_equal(getattr(tp, name), getattr(jp, name)), name
    assert tp[3:] == jp[3:]
    jx, jres = jdell.distributed_bcsr_solve(A, b, _jmesh(cpu_devices),
                                            tol=1e-11, maxiter=4000)
    mesh = _tmesh()
    tA = type("A", (), dict(data=_t(data), cols=_t(cols)))
    tx, tres = tdell.distributed_bcsr_solve(tA, _t(b), mesh, tol=1e-11,
                                            maxiter=4000)
    assert tres.converged and tres.iterations == int(jres.iterations)
    assert np.abs(tx.numpy() - np.asarray(jx)).max() <= 1e-10 * np.abs(
        np.asarray(jx)).max()
    res = tdell.bcsr_cg_sharded(bcsr_partition_from_numpy(jp), np.pad(
        np.asarray(b), (0, (tp.data.shape[0] - tp.n) * 2)), mesh, tol=1e-11,
        maxiter=4000)
    assert res.iterations == tres.iterations


# -- dynamics, the 2D decomposition, the dry run ------------------------------

def test_leapfrog_matches_jax(cpu_devices):
    data, _, offsets, mesh2 = _poisson_system(24)
    nn = mesh2.num_nodes
    bc = mesh2.node_flags != 0
    c = mesh2.coords
    u0 = np.where(bc, 0.0, np.sin(np.pi * (c[:, 0] + 3) / 6)
                  * np.sin(np.pi * (c[:, 1] + 3) / 6))
    data_p, u0_p, _ = jpart.pad_rows(jnp.asarray(data), jnp.asarray(u0),
                                     offsets, 8, offsets.index(0))
    npad = u0_p.shape[0]
    mL = np.concatenate([np.full(nn, 0.5), np.ones(npad - nn)])
    bc_p = np.concatenate([bc, np.ones(npad - nn, bool)])
    ref = jdyn.leapfrog_wave_sharded(data_p, offsets, jnp.asarray(mL), u0_p,
                                     jnp.zeros(npad), 1e-3, 25,
                                     _jmesh(cpu_devices),
                                     bc_mask=jnp.asarray(bc_p))
    res = tdyn.leapfrog_wave_sharded(_t(data_p), offsets, _t(mL), _t(u0_p),
                                     torch.zeros(npad, dtype=torch.float64),
                                     1e-3, 25, _tmesh(), bc_mask=_t(bc_p))
    e, e_ref = res.energy.numpy(), np.asarray(ref.energy)
    # energies within 1e-12 (relative), trajectories within 1e-12 of max|u|
    assert np.abs(e - e_ref).max() <= 1e-12 * np.abs(e_ref).max()
    u_ref = np.asarray(ref.u)
    assert np.abs(res.u.unshard().numpy() - u_ref).max() \
        <= 1e-12 * np.abs(u_ref).max()
    assert np.abs(e - e[0]).max() / abs(e[0]) < 1e-12


def test_grid_cg_2d_matches_jax(cpu_devices):
    data, mask, offsets_grid = _analytic_level((-3.0, 3.0), 15, 3,
                                               np.float64)
    data = np.asarray(data)
    x_true = np.where(np.asarray(mask), 0.0,
                      np.random.default_rng(1).standard_normal(
                          data.shape[1:]))
    xp = np.pad(x_true, 1)
    b = sum(data[k] * xp[1 + dz:17 + dz, 1 + dy:17 + dy, 1 + dx:17 + dx]
            for k, (dz, dy, dx) in enumerate(offsets_grid))
    jmesh = JaxMesh(np.array(cpu_devices[:8]).reshape(4, 2), ("z", "y"))
    ref = jd2.solve_grid_cg_2d(data, offsets_grid, b, jmesh, tol=1e-10,
                               maxiter=2000)
    mesh = tm.make_mesh((4, 2), ("z", "y"), device="cpu")
    res = td2.solve_grid_cg_2d(data, offsets_grid, b, mesh, tol=1e-10,
                               maxiter=2000)
    assert res.converged and res.iterations == int(ref.iterations)
    x_ref = np.asarray(ref.x)
    assert np.abs(res.x.unshard().numpy() - x_ref).max() \
        <= 1e-10 * np.abs(x_ref).max()
    # its matvec against the plain shifted sum
    y = td2.grid_stencil_matvec_2d(
        tm.shard(_t(data), mesh, tm.P(None, "z", "y", None)),
        tm.shard(_t(x_true), mesh, tm.P("z", "y", None)), offsets_grid,
        "z", "y").unshard().numpy()
    assert np.abs(y - b).max() <= 1e-12 * np.abs(b).max()


def test_dryrun_multichip_on_the_host():
    out = dryrun_multichip(8, device="cpu")
    # the reference's counts on its 8-device CPU mesh (MULTICHIP_r05.json)
    assert out["stencil_cg"]["iterations"] == 40
    assert out["dist_mg"]["iterations"] == 13
    assert out["dist_assembly"]["iterations"] == 31
    assert out["dist_amg"]["iterations"] == 24
    assert out["dist_bcsr"]["iterations"] == 72
    assert out["dist_dynamics"]["drift"] < 1e-5
