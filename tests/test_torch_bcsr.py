"""Port parity, the BCSR layer: the box mesh and the vector spaces equal to
the JAX package's; BCSR assembly, Dirichlet elimination, the matrix's
products, diagonal blocks and dense form and block-Jacobi at 1e-12
(float64, CPU); the banded block plan equal to ``bcsr_band_plan``'s; B12's
plain version (static and per_block) against the Pallas kernel in
interpret mode; the gather form against the JAX BCSRMatrix."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpufem.fem.space import VectorFunctionSpace as JaxVectorSpace
from tpufem.mesh import box as jax_box
from tpufem.mesh.adjacency import ell_pattern as jax_ell_pattern
from tpufem.mesh.rectangle import perturbed_rectangle_mesh as jax_perturbed
from tpufem.solve.precond import block_jacobi as jax_block_jacobi
from tpufem.sparse import bcsr as jax_bcsr
from tpufem.sparse import ell_pallas as jax_ep

from tpufem_torch.convert import bcsr_band_plan_from_numpy, bcsr_from_numpy
from tpufem_torch.fem.space import VectorFunctionSpace
from tpufem_torch.mesh import box
from tpufem_torch.mesh.adjacency import ell_pattern
from tpufem_torch.mesh.rectangle import perturbed_rectangle_mesh
from tpufem_torch.solve.precond import block_jacobi
from tpufem_torch.sparse import bcsr as port_bcsr
from tpufem_torch.sparse import ell_cuda
from tpufem_torch.sparse.bcsr import (BCSRMatrix, apply_dirichlet_bcsr,
                                      assemble_bcsr)

# several pytest workers share the CPU: one intra-op thread each keeps
# the many small tensor ops from oversubscribing it
torch.set_num_threads(1)


def _close(a, ref, rtol=1e-12):
    a, ref = np.asarray(a), np.asarray(ref)
    assert a.shape == ref.shape
    assert np.abs(a - ref).max() <= rtol * max(np.abs(ref).max(), 1e-300)


@pytest.mark.parametrize("make", ["box_mesh", "BoxMesh", "unit_cube_mesh"])
@pytest.mark.parametrize("cells", [(1, 1, 1), (3, 4, 5)])
def test_box_mesh_equals_jax(make, cells):
    bounds = () if make == "unit_cube_mesh" else (-1.0, 2.0, 0.0, 1.0, -3.0,
                                                  0.5)
    ref = getattr(jax_box, make)(*bounds, *cells)
    got = getattr(box, make)(*bounds, *cells)
    for name in ("coords", "conn", "node_flags"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got.cell_type == ref.cell_type == "tetrahedron"
    s, r = got.structured, ref.structured
    assert (s.node_grid, s.cell_grid) == (r.node_grid, r.cell_grid)
    np.testing.assert_array_equal(s.type_node_offsets, r.type_node_offsets)
    with pytest.raises(ValueError):
        box.box_mesh(0, 1, 0, 1, 0, 1, 0, 1, 1)


def _meshes(dim):
    if dim == 2:
        return (jax_perturbed(-1, 1, -1, 1, 9, 8, jitter=0.2, seed=4),
                perturbed_rectangle_mesh(-1, 1, -1, 1, 9, 8, jitter=0.2,
                                         seed=4))
    return (jax_box.box_mesh(-1, 1, -1, 1, -1, 1, 3, 2, 3),
            box.box_mesh(-1, 1, -1, 1, -1, 1, 3, 2, 3))


@pytest.mark.parametrize("dim", [2, 3])
def test_vector_space_equals_jax(dim):
    jm, tm = _meshes(dim)
    ref, got = JaxVectorSpace(jm), VectorFunctionSpace(tm)
    assert got.num_components == ref.num_components == dim
    for name in ("dof_conn", "dof_flags", "scalar_dof_conn"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    assert (got.num_dofs, got.local_dofs, got.num_scalar_dofs) == (
        ref.num_dofs, ref.local_dofs, ref.num_scalar_dofs)


def _system(dim, seed=0):
    """Random symmetric element blocks [NE, nl*b, nl*b] on a small mesh,
    the node pattern, and both packages' assembled BCSR matrices."""
    jm, tm = _meshes(dim)
    V = VectorFunctionSpace(tm)
    rng = np.random.default_rng(seed)
    nd = V.local_dofs
    G = rng.standard_normal((tm.num_elements, nd, nd))
    Ke = G @ G.transpose(0, 2, 1) + nd * np.eye(nd)
    pat = ell_pattern(V.scalar_dof_conn, V.num_scalar_dofs, pad_to=8)
    jpat = jax_ell_pattern(V.scalar_dof_conn, V.num_scalar_dofs, pad_to=8)
    A = assemble_bcsr(pat, torch.as_tensor(Ke), dim)
    R = jax_bcsr.assemble_bcsr(jpat, jnp.asarray(Ke), dim)
    return V, A, R, rng


@pytest.mark.parametrize("dim", [2, 3])
def test_assemble_and_dirichlet_match_jax(dim):
    V, A, R, rng = _system(dim)
    np.testing.assert_array_equal(A.cols.numpy(), np.asarray(R.cols))
    np.testing.assert_array_equal(A.diag_pos.numpy(), np.asarray(R.diag_pos))
    _close(A.data.numpy(), R.data)
    assert A.shape == R.shape and A.block_size == R.block_size == dim
    b = rng.standard_normal(V.num_dofs)
    g = rng.standard_normal(V.num_dofs)
    for bcv in (None, g):
        A2, b2 = apply_dirichlet_bcsr(A, torch.as_tensor(b), V.dof_flags,
                                      None if bcv is None
                                      else torch.as_tensor(bcv))
        R2, c2 = jax_bcsr.apply_dirichlet_bcsr(
            R, jnp.asarray(b), jnp.asarray(V.dof_flags),
            None if bcv is None else jnp.asarray(bcv))
        _close(A2.data.numpy(), R2.data)
        _close(b2.numpy(), c2)
    # the given matrix is not modified
    _close(A.data.numpy(), R.data)


@pytest.mark.parametrize("dim", [2, 3])
def test_bcsr_matrix_matches_jax(dim):
    """Dispatch (banded plan iff the node bandwidth is <= 4096), products,
    diagonal blocks, dense form and block-Jacobi against the JAX
    BCSRMatrix (its gather form on the CPU)."""
    V, A, R, rng = _system(dim, seed=1)
    x = rng.standard_normal(V.num_dofs)
    _close(A.matvec(torch.as_tensor(x)).numpy(), R.matvec(jnp.asarray(x)))
    assert A._band is not None                   # a small mesh is banded
    _close((A @ torch.as_tensor(x)).numpy(), R @ jnp.asarray(x))
    G = BCSRMatrix(A.data, A.cols, A.diag_pos)
    G._band = None                               # the gather form
    _close(G.matvec(torch.as_tensor(x)).numpy(), R.matvec(jnp.asarray(x)))
    np.testing.assert_array_equal(A.diagonal_blocks().numpy(),
                                  np.asarray(R.diagonal_blocks()))
    np.testing.assert_array_equal(A.to_dense().numpy(),
                                  np.asarray(R.to_dense()))
    M = block_jacobi(A.diagonal_blocks())
    Mj = jax_block_jacobi(R.diagonal_blocks())
    _close(M(torch.as_tensor(x)).numpy(), Mj(jnp.asarray(x)))
    # the component-major apply of the banded elasticity solve ([b, n])
    Mc = block_jacobi(A.diagonal_blocks(), component_major=True)
    x_cm = torch.as_tensor(x.reshape(-1, dim).T.copy())
    _close(Mc(x_cm).T.reshape(-1).numpy(), Mj(jnp.asarray(x)))
    with pytest.raises(ValueError, match="diag_pos"):
        BCSRMatrix(A.data, A.cols).diagonal_blocks()


def test_wide_band_takes_the_gather_form_and_a_failed_plan_raises(
        monkeypatch):
    n, k, b = 5000, 4, 2
    rng = np.random.default_rng(2)
    cols = np.sort(rng.integers(0, n, (n, k)), axis=1).astype(np.int32)
    cols[:, 0] = np.arange(n)
    data = rng.standard_normal((n, k, b, b))
    x = rng.standard_normal(n * b)
    A = BCSRMatrix(torch.as_tensor(data), torch.as_tensor(cols))
    ref = jax_bcsr.BCSRMatrix(jnp.asarray(data), jnp.asarray(cols))
    _close(A.matvec(torch.as_tensor(x)).numpy(), ref.matvec(jnp.asarray(x)))
    assert A._band is None
    # no quiet fallback: a plan that cannot be built raises

    def broken(*args, **kwargs):
        raise MemoryError("plan")

    monkeypatch.setattr(port_bcsr, "bcsr_band_plan", broken)
    B = BCSRMatrix(torch.as_tensor(data[:300]),
                   torch.as_tensor(np.minimum(cols[:300], 299)))
    with pytest.raises(MemoryError):
        B.matvec(torch.as_tensor(x[:600]))


def _random_bcsr(seed, nr, k, band, b):
    rng = np.random.default_rng(seed)
    cols = np.clip(np.arange(nr)[:, None]
                   + rng.integers(-band, band + 1, size=(nr, k)),
                   0, nr - 1).astype(np.int32)
    return rng.standard_normal((nr, k, b, b)), cols, rng


# (rows, slots, half bandwidth, block rows): R = 256 stores int16 windows,
# R = 11008 (3R > 32767) int32 ones; "int16-k16" has the 3D elasticity
# path's 16 slots (B12's K = 16 instance on the card)
_CASES = {"int16": (1000, 8, 200, 256), "int32": (11500, 4, 300, 11008),
          "int16-k16": (200, 16, 60, 128)}


@pytest.mark.parametrize("case,b,per_block", [
    (case, b, per_block) for per_block in (False, True)
    for case, b in (("int16", 2), ("int16", 3), ("int32", 2))]
    + [("int16-k16", 3, False)])   # the per_block twin takes 12 s more
def test_band_plan_and_plain_kernel_match_pallas(case, b, per_block):
    """The port's banded block plan equals JAX's bcsr_band_plan, and B12's
    plain version (the wrapper's CPU path) equals the TPU kernel,
    interpreted, at 1e-12."""
    nr, k, band, R = _CASES[case]
    data, cols, rng = _random_bcsr(5, nr, k, band, b)
    ref_plan, ref_dt = jax_ep.bcsr_band_plan(data, cols, block_rows=R,
                                             per_block=per_block)
    plan, data_t = ell_cuda.bcsr_band_plan(torch.as_tensor(data), cols,
                                           block_rows=R, per_block=per_block)
    np.testing.assert_array_equal(data_t, ref_dt)
    np.testing.assert_array_equal(plan.rel, ref_plan.rel)
    assert plan.rel.dtype == ref_plan.rel.dtype
    np.testing.assert_array_equal(plan.data_t, ref_plan.data_t)
    assert plan.d_lists == ref_plan.d_lists
    assert plan.segments == ref_plan.segments
    if per_block:
        np.testing.assert_array_equal(plan.dtab, ref_plan.dtab)
    x = rng.standard_normal((b, nr))
    y_ref = jax_ep.bcsr_matvec_pallas(
        ref_plan, jnp.asarray(ref_dt), jnp.asarray(ref_plan.rel),
        jnp.asarray(x), interpret=True, per_block=per_block)
    before = ell_cuda.bcsr_matvec_cuda.launches
    y = ell_cuda.bcsr_matvec_cuda(plan, torch.as_tensor(data_t),
                                  torch.as_tensor(plan.rel),
                                  torch.as_tensor(x), per_block=per_block)
    assert ell_cuda.bcsr_matvec_cuda.launches == before     # plain on CPU
    _close(y.numpy(), y_ref)
    # the JAX plan carried over runs the same product
    pl2, dt2, rel2 = bcsr_band_plan_from_numpy(ref_plan, ref_dt)
    assert torch.equal(ell_cuda.bcsr_matvec_cuda(pl2, dt2, rel2,
                                                 torch.as_tensor(x),
                                                 per_block=per_block), y)


@pytest.mark.parametrize("b", [2, 3])
def test_gather_form_matches_jax_and_the_banded_plain(b):
    data, cols, rng = _random_bcsr(6, 900, 8, 100, b)
    x = rng.standard_normal(900 * b)
    ref = jax_bcsr.BCSRMatrix(jnp.asarray(data), jnp.asarray(cols)).matvec(
        jnp.asarray(x))
    y = ell_cuda.bcsr_gather_matvec_cuda(torch.as_tensor(data),
                                         torch.as_tensor(cols),
                                         torch.as_tensor(x))
    _close(y.numpy(), ref)
    # the banded plain version adds in the same order: the same bits
    plan, data_t = ell_cuda.bcsr_band_plan(data, cols, block_rows=256)
    yb = ell_cuda.bcsr_band_matvec_plain(
        plan, torch.as_tensor(data_t), torch.as_tensor(plan.rel),
        torch.as_tensor(x).reshape(900, b).T)
    assert torch.equal(yb.T.reshape(-1), y)
    # x padded to NP gives the same y
    xp = torch.cat([torch.as_tensor(x).reshape(900, b).T,
                    torch.zeros((b, plan.np_rows - 900),
                                dtype=torch.float64)], 1)
    assert torch.equal(ell_cuda.bcsr_band_matvec_plain(
        plan, torch.as_tensor(data_t), torch.as_tensor(plan.rel), xp), yb)


def test_bcsr_from_numpy_carries_the_jax_matrix():
    data, cols, rng = _random_bcsr(7, 600, 8, 60, 3)
    diag_pos = np.zeros(600, np.int32)
    ref_plan, ref_dt = jax_ep.bcsr_band_plan(data, cols, block_rows=256)
    A = bcsr_from_numpy(data, cols, diag_pos,
                        band=bcsr_band_plan_from_numpy(ref_plan, ref_dt))
    assert A._band[0].block_rows == 256 and A.diag_pos.dtype == torch.int32
    x = rng.standard_normal(1800)
    _close(A.matvec(torch.as_tensor(x)).numpy(),
           jax_bcsr.BCSRMatrix(jnp.asarray(data), jnp.asarray(cols)).matvec(
               jnp.asarray(x)))
    with pytest.raises(ValueError):
        bcsr_from_numpy(data[:, :4], cols)
    with pytest.raises(ValueError, match="does not fit"):
        bcsr_from_numpy(data[:300], cols[:300] % 300,
                        band=bcsr_band_plan_from_numpy(ref_plan, ref_dt))


def _order_case(seed, nr, k, b):
    """fp32 blocks and x spread over eight decades with random signs, so
    that each product's rounding and each sum's order show in the bits."""
    rng = np.random.default_rng(seed)
    spread = lambda shape: (rng.choice([-1.0, 1.0], shape)
                            * 10.0 ** rng.uniform(-4, 4, shape))
    data = spread((nr, k, b, b)).astype(np.float32)
    cols = rng.integers(0, nr, (nr, k)).astype(np.int32)
    x = spread(nr * b).astype(np.float32)
    return data, cols, x


@pytest.mark.parametrize("b, k", [(2, 8), (3, 16)])
def test_gather_plain_sums_slot_then_component(b, k):
    """B12g's plain version sums y[i, c] slot k outer, then source component
    d, each product and each sum rounded to fp32 on its own: a numpy loop
    in that order gives the same bits, and the inputs are such that the
    other order (d outer) and a pairwise sum do not."""
    nr = 500
    data, cols, x = _order_case(11 + k, nr, k, b)
    xb = x.reshape(nr, b)
    ref = np.zeros((nr, b), np.float32)
    for kk in range(k):
        g = xb[cols[:, kk]]
        for d in range(b):
            ref = ref + data[:, kk, :, d] * g[:, d, None]
    y = ell_cuda.bcsr_gather_matvec_plain(torch.as_tensor(data),
                                          torch.as_tensor(cols),
                                          torch.as_tensor(x))
    assert y.dtype == torch.float32
    np.testing.assert_array_equal(y.numpy(), ref.reshape(-1))
    other = np.zeros((nr, b), np.float32)
    for d in range(b):
        for kk in range(k):
            other = other + data[:, kk, :, d] * xb[cols[:, kk], d][:, None]
    assert (other != ref).any()
    pairwise = (data * xb[cols][:, :, None, :]).sum((1, 3), dtype=np.float32)
    assert (pairwise != ref).any()


@pytest.mark.parametrize("k", [1, 3, 7, 8, 16, 24, 32, 64, 160])
@pytest.mark.parametrize("itemsize, b", [(4, 2), (4, 3), (8, 2), (8, 3)],
                         ids=["f32b2", "f32b3", "f64b2", "f64b3"])
def test_gather_tiling_fits_two_stages_in_shared_memory(itemsize, b, k):
    """Every B12g tiling the port picks holds its ring of two buffers
    within a block's 227 KB, leaves room for a second block on the SM, and
    stays within the kernel's 384 threads; each span's region holds its
    bytes at any 16-byte phase, padding included; the tile is the largest
    whose stage fits 24 KB where one does."""
    rows, smem = ell_cuda.bcsr_gather_tiling(itemsize, b, k)
    assert rows in (128, 64, 32, 16, 8, 4) and rows * b <= 384
    assert smem <= 232448 and 2 * (smem + 1024) <= 233472

    def stage(r):
        return (ell_cuda._span_region(r * k * b * b * itemsize)
                + ell_cuda._span_region(r * k * 4))

    assert smem == 2 * stage(rows)
    if stage(rows) <= 24 * 1024 and rows < 128 and 2 * rows * b <= 384:
        assert stage(2 * rows) > 24 * 1024
    vals = rows * k * b * b * itemsize
    region = ell_cuda._span_region(vals)
    # the last byte of a span that starts 15 bytes into a chunk
    last = 15 + vals - 1
    assert (last // 16) * 16 + (last // 128) * 16 + last % 16 < region
    assert region % 16 == 0


def test_gather_tiling_matches_the_measured_tiles():
    """The tiles at the paths' shapes: 128 rows (2D fp32), 64 (2D fp64),
    32 (3D fp32) and 16 (3D fp64)."""
    assert [ell_cuda.bcsr_gather_tiling(i, b, k)[0]
            for i, b, k in ((4, 2, 8), (8, 2, 8), (4, 3, 16), (8, 3, 16))
            ] == [128, 64, 32, 16]
