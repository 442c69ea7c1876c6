"""The fused 3D system build's tiles and plain version (kernels K1 and
B8, ``ops.fused_system_cuda``), and three repairs of the port's surface.

On the CPU: ``fused_tiling`` and ``check_fused_tile`` (the tiles the CUDA
launcher takes, store grids that are not whole tiles); the plain version,
whose terms reach a row in the kernel's order (the sums of the cells
below the row and of its own plane apart), against the JAX package's XLA pipeline and its Pallas kernel in
interpret mode at 1e-12 (float64) on odd boxes; its stripes, joined,
equal to its whole build bit for bit.  The repairs, each held to the JAX
package: ``node_coords_embedded``, the ``TRI7_FP32_*`` tables and
``BCSRMatrix.prime_band_plan(block_rows, segment, cap_k)``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpufem.assemble.planar import (element_coords_bt, element_load_bt,
                                    p1_stiffness_bt)
from tpufem.assemble.structured import (assemble_stencil_structured_bt,
                                        assemble_vector_structured_bt)
from tpufem.assemble.structured import structured_plan as jax_plan
from tpufem.fem import quadrature as jax_quadrature
from tpufem.fem.quadrature import tetrahedron_rule as jax_rule
from tpufem.mesh.box import box_mesh as jax_box_mesh
from tpufem.mesh.rectangle import RectangleMesh as JaxRectangleMesh
from tpufem.ops.fused_system_pallas import build_poisson_system_pallas
from tpufem.ops.fused_system_pallas import \
    node_coords_embedded as jax_node_coords_embedded
from tpufem.solve.bc import apply_dirichlet_stencil
from tpufem.solve.poisson import model_problem_3d_planes as jax_f
from tpufem.sparse.bcsr import BCSRMatrix as JaxBCSRMatrix

from tpufem_torch.assemble.planar import p1_gradients
from tpufem_torch.assemble.structured import structured_plan
from tpufem_torch.fem import quadrature
from tpufem_torch.fem.quadrature import tetrahedron_rule, triangle_rule
from tpufem_torch.mesh.box import box_mesh
from tpufem_torch.mesh.rectangle import RectangleMesh
from tpufem_torch.ops import fused_system_cuda as fs
from tpufem_torch.solve.poisson import model_problem_3d_planes
from tpufem_torch.sparse import ell_cuda
from tpufem_torch.sparse.bcsr import BCSRMatrix

# several pytest workers share the CPU: one intra-op thread each keeps
# the many small tensor ops from oversubscribing it
torch.set_num_threads(1)

_BOXES = {"box5x4x6": ((-3, 2, 0, 3, -2, 1), (5, 4, 6)),
          "cube7": ((-1, 1, -1, 1, -1, 1), (7, 7, 7))}


# -- tiles ---------------------------------------------------------------------

@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("store_grid", [(104, 104, 128), (392, 392, 512),
                                        (26, 104, 128), (16, 100, 128),
                                        (3, 13, 32), (1, 8, 32)])
def test_tiling_is_a_tile_the_launcher_takes(itemsize, store_grid):
    """Every pick is a built tile that fits the card, its grid covers the
    store grid (ragged last tiles in y and z included), and its march is
    1 .. 32 planes, at most the grid's depth."""
    tx, ty, nr, tz, smem, grid = fs.fused_tiling(itemsize, store_grid)
    fs.check_fused_tile(itemsize, tx, nr, tz)
    s0, s1, s2 = store_grid
    assert tx * ty == 256 and (tx, nr) in fs.FUSED_TILES
    assert smem == fs.fused_smem(itemsize, tx, nr) <= 232448
    assert 1 <= tz <= min(32, s0)
    assert grid == (s2 // tx, -(-s1 // ty), -(-s0 // tz))
    assert grid[0] * tx == s2
    assert (grid[1] - 1) * ty < s1 <= grid[1] * ty
    assert (grid[2] - 1) * tz < s0 <= grid[2] * tz


def test_tiling_marches_longer_on_larger_grids():
    """The march grows with the work each SM holds (tz ~ sqrt(2 W)): a
    stripe takes a shorter march than the whole n=96 grid, n=384 the
    longest (32 planes)."""
    tz = {sg: fs.fused_tiling(4, sg)[3]
          for sg in ((26, 104, 128), (104, 104, 128), (392, 392, 512))}
    assert tz[(26, 104, 128)] < tz[(104, 104, 128)] < tz[(392, 392, 512)]
    assert tz[(392, 392, 512)] == 32


def test_tiling_refuses_rows_of_partial_tiles():
    with pytest.raises(ValueError):
        fs.fused_tiling(4, (16, 16, 48))      # 48 columns: no 32-wide tile
    with pytest.raises(ValueError):
        fs.fused_tiling(4, (0, 16, 128))


@pytest.mark.parametrize("itemsize", [4, 8])
def test_shared_memory_of_the_tiles(itemsize):
    """fused_smem counts the block's coordinate ring (3 planes of 3
    coordinates, (ty + 2) rows of tx columns and a 16-byte chunk either
    side) and the 14 values of each of a round's types per cell; fewer
    types a round, less memory."""
    for tx, nr in fs.FUSED_TILES:
        ty = 256 // tx
        ring = 9 * (ty + 2) * (tx + 32 // itemsize)
        cells = (6 // nr) * 14 * (ty + 1) * (tx + 1)
        assert fs.fused_smem(itemsize, tx, nr) == (ring + cells) * itemsize
    assert fs.fused_smem(itemsize, 16, 3) < fs.fused_smem(itemsize, 16, 1)


@pytest.mark.parametrize("tile", [(64, 1, 4), (32, 3, 4), (16, 1, 4),
                                  (32, 1, 0)])
def test_a_tile_without_a_kernel_raises(tile):
    with pytest.raises(ValueError):
        fs.check_fused_tile(4, *tile)


def test_a_tile_that_does_not_fit_raises():
    # 64 columns, all 6 types at once, fp64: 249,504 B > 232,448 B
    assert fs.fused_smem(8, 64, 1) > 232448
    with pytest.raises(ValueError):
        fs.check_fused_tile(8, 64, 1, 4)


# -- the plain version, reordered -----------------------------------------------

def _boxes(name):
    bounds, cells = _BOXES[name]
    jm = jax_box_mesh(*bounds, *cells)
    tm = box_mesh(*bounds, *cells)
    jp, tp = jax_plan(jm, embed=True), structured_plan(tm, embed=True)
    return jm, jp, tp, jax_node_coords_embedded(jm, jp, np.float64), \
        fs.node_coords_embedded(tm, tp, np.float64)


# the 5 x 4 x 6 box with the quadrature RHS is test_torch_fused_system's
@pytest.mark.parametrize("box", ["cube7"])
@pytest.mark.parametrize("apply_bc", [True, False])
def test_plain_quadrature_build_matches_jax_pipeline(box, apply_bc):
    jm, jp, tp, _, C = _boxes(box)
    X = jnp.asarray(element_coords_bt(jm, np.float64))
    A_ref = assemble_stencil_structured_bt(jp, p1_stiffness_bt(
        X, "tetrahedron"))
    b_ref = assemble_vector_structured_bt(jp, element_load_bt(
        X, "tetrahedron", jax_rule(2), jax_f()))
    if apply_bc:
        bc = jp.embed_field(jnp.asarray(jm.node_flags != 0), fill=False)
        A_ref, b_ref = apply_dirichlet_stencil(A_ref, b_ref, bc)
    A, b = fs.build_poisson_system_plain(tp, torch.as_tensor(C),
                                         model_problem_3d_planes(),
                                         tetrahedron_rule(2),
                                         apply_bc=apply_bc)
    assert A.offsets == tuple(jp.offsets)
    # float64, the same element formulas summed in another order: 1e-12
    np.testing.assert_allclose(A.data.numpy(), np.asarray(A_ref.data),
                               rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_ref), rtol=1e-12,
                               atol=1e-12)


# the 5 x 4 x 6 box with the elimination is test_torch_fused_system's
@pytest.mark.parametrize("box, apply_bc", [("box5x4x6", False),
                                           ("cube7", True)])
def test_plain_interp_build_matches_pallas_kernel(box, apply_bc):
    jm, jp, tp, C_jax, C = _boxes(box)
    A_ref, b_ref = build_poisson_system_pallas(
        jp, jnp.asarray(C_jax), None, jax_f(), jax_rule(2), block_lead=2,
        apply_bc=apply_bc, rhs_mode="interp", interpret=True)
    A, b = fs.build_poisson_system_plain(tp, torch.as_tensor(C),
                                         model_problem_3d_planes(),
                                         tetrahedron_rule(2),
                                         apply_bc=apply_bc,
                                         rhs_mode="interp")
    np.testing.assert_allclose(A.data.numpy(), np.asarray(A_ref.data),
                               rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_ref), rtol=1e-12,
                               atol=1e-12)


def _stripes(C, depths):
    """[(C_ext, zbase)] of consecutive z-stripes of the given depths: each
    stripe's planes with one neighbour plane either side, zeros past the
    grid's ends."""
    zero = torch.zeros_like(C[:, :1])
    out, z = [], 0
    for d in depths:
        lo = C[:, z - 1:z] if z > 0 else zero
        hi = C[:, z + d:z + d + 1] if z + d < C.shape[1] else zero
        out.append((torch.cat([lo, C[:, z:z + d], hi], 1), z))
        z += d
    return out


@pytest.mark.parametrize("box", sorted(_BOXES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rhs_mode", ["quadrature", "interp"])
@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_plain_stripes_equal_the_whole_build(box, dtype, rhs_mode, shards):
    _, _, tp, _, C = _boxes(box)
    C = torch.as_tensor(C).to(dtype)
    f, rule = model_problem_3d_planes(), tetrahedron_rule(2)
    A, b = fs.build_poisson_system_plain(tp, C, f, rule, rhs_mode=rhs_mode)
    depths = [len(p) for p in np.array_split(np.arange(C.shape[1]), shards)]
    parts = [fs.build_poisson_stripe_plain(tp, Cx, z, f, rule,
                                           rhs_mode=rhs_mode)
             for Cx, z in _stripes(C, depths)]
    rest = tp.store_grid[1] * tp.store_grid[2]
    assert all(d.shape[1] == r.shape[0] == depth * rest
               for (d, r), depth in zip(parts, depths))
    assert torch.equal(torch.cat([d for d, _ in parts], 1), A.data)
    assert torch.equal(torch.cat([r for _, r in parts]), b)


def _stiffness_by_hand(tp, C, groups, apart):
    """The raw stiffness planes, each row's terms added group by group
    (``groups``: lists of za values, e.g. [[1], [0]]), in (t, a, b) order
    within a group; ``apart``: each group summed from 0 and the sums
    added, else one running sum."""
    info = tp.info
    m = info.cell_grid
    out = None
    acc = torch.zeros((tp.width,) + tuple(tp.store_grid), dtype=C.dtype)
    for group in groups:
        if apart:
            acc = torch.zeros_like(acc)
        for t in range(info.num_types):
            offs = info.type_node_offsets[t]
            Xt = [[C[d][tuple(slice(1 + int(o[ax]), 1 + int(o[ax]) + m[ax])
                              for ax in range(3))] for d in range(3)]
                  for o in offs]
            G, det = p1_gradients(Xt)
            vol = det.abs() * (1.0 / 6.0)
            for a in range(4):
                if int(offs[a][0]) not in group:
                    continue
                rows = tuple(slice(1 + int(offs[a][ax]),
                                   1 + int(offs[a][ax]) + m[ax])
                             for ax in range(3))
                for b in range(4):
                    k = int(tp.entry_k[t, a, b])
                    acc[k][rows] += sum(G[a][d] * G[b][d]
                                        for d in range(3)) * vol
        out = acc if out is None or not apart else out + acc
    return out.reshape(tp.width, -1)


def test_plain_rows_sum_the_two_planes_apart():
    """A row sums the (t, a) terms of the cells on the plane below it
    (za = 1) and those of its own plane (za = 0) apart and adds the two
    sums: what K1's march gives.  One running sum over the same order
    rounds some rows of a jittered fp32 box otherwise, so the check tells
    them apart."""
    tm = box_mesh(-1, 1, -1, 1, -1, 1, 6, 6, 6)
    tp = structured_plan(tm, embed=True)
    rng = np.random.default_rng(5)
    ng = tuple(tp.info.node_grid)
    coords = np.moveaxis(tm.coords.reshape(ng + (3,)), -1, 0)
    interior = np.zeros(ng, bool)
    interior[1:-1, 1:-1, 1:-1] = True
    coords = coords + np.where(interior, rng.uniform(-0.03, 0.03,
                                                     coords.shape), 0.0)
    C = torch.as_tensor(fs.node_coords_embedded_from_grid(coords, tp,
                                                          np.float32))
    A, _ = fs.build_poisson_system_plain(tp, C, model_problem_3d_planes(),
                                         tetrahedron_rule(2), apply_bc=False)
    assert torch.equal(A.data, _stiffness_by_hand(tp, C, [[1], [0]], True))
    assert not torch.equal(A.data,
                           _stiffness_by_hand(tp, C, [[1], [0]], False))


# -- C4: node_coords_embedded ----------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("dim", [2, 3])
def test_node_coords_embedded_equals_jax(dim, dtype):
    if dim == 3:
        jm, tm = (jax_box_mesh(-3, 2, 0, 3, -2, 1, 5, 4, 6),
                  box_mesh(-3, 2, 0, 3, -2, 1, 5, 4, 6))
    else:
        jm, tm = (JaxRectangleMesh(-3, 2, 0, 3, 7, 5),
                  RectangleMesh(-3, 2, 0, 3, 7, 5))
    ref = jax_node_coords_embedded(jm, jax_plan(jm, embed=True), dtype)
    got = fs.node_coords_embedded(tm, structured_plan(tm, embed=True),
                                  dtype)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    assert "node_coords_embedded" in fs.__all__


# -- C5: the reference's float32 tables of the 7-point triangle rule -----------

@pytest.mark.parametrize("name", ["TRI7_FP32_W", "TRI7_FP32_R",
                                  "TRI7_FP32_S", "TRI7_FP32_T"])
def test_tri7_tables_equal_jax(name):
    got, ref = getattr(quadrature, name), getattr(jax_quadrature, name)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    assert name in quadrature.__all__


def test_tri7_rule_reproduces_the_tables():
    """The exact degree-5 rule gives the reference's float32 constants to
    fp32 (tests/test_quadrature.py's property, on the port's copy)."""
    rule = triangle_rule(5)
    np.testing.assert_allclose(rule.weights, quadrature.TRI7_FP32_W,
                               atol=6e-9)
    np.testing.assert_allclose(rule.points[:, 0], quadrature.TRI7_FP32_R,
                               atol=6e-8)
    np.testing.assert_allclose(rule.points[:, 1], quadrature.TRI7_FP32_S,
                               atol=6e-8)
    t = 1 - rule.points.sum(axis=1)
    np.testing.assert_allclose(t, quadrature.TRI7_FP32_T, atol=2e-7)


# -- C6: BCSRMatrix.prime_band_plan(block_rows, segment, cap_k) ----------------

def _banded_bcsr(nr=20000, k=8, b=3, seed=0):
    """A random block matrix with a banded node pattern (half bandwidth
    300): 20,000 block rows, so the block size the K * b * b cap picks
    differs from the uncapped one."""
    rng = np.random.default_rng(seed)
    cols = np.clip(np.arange(nr)[:, None] + rng.integers(-300, 301, (nr, k)),
                   0, nr - 1).astype(np.int32)
    cols[:, 0] = np.arange(nr)
    data = rng.standard_normal((nr, k, b, b))
    return data, cols


@pytest.fixture(scope="module")
def banded():
    data, cols = _banded_bcsr()
    return data, cols, np.random.default_rng(1).standard_normal(
        data.shape[0] * data.shape[2])


def test_prime_band_plan_cap_k_picks_the_jax_block_size(banded):
    data, cols, _ = banded
    picked = {}
    for cap_k in (False, True):
        ref = JaxBCSRMatrix(jnp.asarray(data), jnp.asarray(cols))
        ref.prime_band_plan(cap_k=cap_k)
        got = BCSRMatrix(torch.as_tensor(data), torch.as_tensor(cols))
        got.prime_band_plan(cap_k=cap_k)
        assert got._band[0].block_rows == ref._band[0].block_rows
        picked[cap_k] = got._band[0].block_rows
    assert picked[True] < picked[False]


def test_prime_band_plan_unsegmented_matches_jax_plan(banded):
    data, cols, _ = banded
    ref = JaxBCSRMatrix(jnp.asarray(data), jnp.asarray(cols))
    ref.prime_band_plan(segment=False)
    got = BCSRMatrix(torch.as_tensor(data), torch.as_tensor(cols))
    got.prime_band_plan(segment=False)
    plan, rplan = got._band[0], ref._band[0]
    assert plan.block_rows == rplan.block_rows
    assert plan.segments == rplan.segments
    np.testing.assert_array_equal(plan.rel, rplan.rel)
    np.testing.assert_array_equal(got._band[2].numpy(),
                                  np.asarray(ref._band[2]))


@pytest.mark.parametrize("segment", [True, False])
@pytest.mark.parametrize("cap_k", [False, True])
def test_prime_band_plan_products_equal_the_gather_product(banded, segment,
                                                           cap_k):
    data, cols, x = banded
    A = BCSRMatrix(torch.as_tensor(data), torch.as_tensor(cols))
    A.prime_band_plan(segment=segment, cap_k=cap_k)
    y = A.matvec(torch.as_tensor(x))
    ref = ell_cuda.bcsr_gather_matvec_cuda(torch.as_tensor(data),
                                           torch.as_tensor(cols),
                                           torch.as_tensor(x))
    assert torch.equal(y, ref)
