"""The tiles of the structured builds B13 (``ops.assemble_cuda``) and B7
(``ops.fused_system_cuda``'s 2D kernel), and the order of B13's march.

On the CPU: ``assemble_tiling`` and ``fused_2d_tiling`` pick tiles the
CUDA launchers take, which fit shared memory and cover every store row
(ragged last tiles and bands included; B7's overlapping tiles complete
every column once); a tile without a kernel raises.
B13's generated header carries exactly the za = 1 (type, local row)
pairs from a step to the next, and its two term lists, replayed on the
CPU, sum every stencil plane in the plain version's order: bit for bit
its planes."""
import re

import numpy as np
import pytest
import torch

from tpufem_torch.assemble.planar import p1_stiffness_bt
from tpufem_torch.assemble.structured import _padded, structured_plan
from tpufem_torch.mesh.box import box_mesh
from tpufem_torch.ops import assemble_cuda as ac
from tpufem_torch.ops import fused_system_cuda as fs

# several pytest workers share the CPU: one intra-op thread each
torch.set_num_threads(1)

_SMEM_PER_BLOCK = 232448


# -- B13 tiles -----------------------------------------------------------------

@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("store_grid", [(104, 104, 128), (392, 392, 512),
                                        (16, 16, 128), (8, 16, 128),
                                        (13, 21, 64), (1, 8, 128)])
def test_assemble_tiling_is_a_tile_the_launcher_takes(itemsize, store_grid):
    """Every pick is a built tile that fits the card, its grid covers the
    store grid (ragged last tiles in y and z included), and its march is
    1 .. 64 planes, at most the grid's depth."""
    tx, ty, tz, smem, grid = ac.assemble_tiling(itemsize, store_grid)
    ac.check_assemble_tile(itemsize, tx, ty, tz)
    s0, s1, s2 = store_grid
    assert (tx, ty) in ac.ASSEMBLE_TILES
    assert smem == ac.assemble_smem(itemsize, tx, ty) <= _SMEM_PER_BLOCK
    assert 1 <= tz <= min(64, s0)
    assert grid == (s2 // tx, -(-s1 // ty), -(-s0 // tz))
    assert grid[0] * tx == s2
    assert (grid[1] - 1) * ty < s1 <= grid[1] * ty
    assert (grid[2] - 1) * tz < s0 <= grid[2] * tz


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("store_grid", [(104, 104, 128), (16, 104, 128),
                                        (392, 392, 512)])
def test_assemble_tiling_minimises_waves_times_steps(itemsize, store_grid):
    """The march is the one of 1 .. 64 planes whose waves of blocks times
    its steps (tz + 1) are fewest, the longest of equals: at n=96 fp32 21
    planes, 260 blocks in one wave of 264."""
    tx, ty, tz, _, grid = ac.assemble_tiling(itemsize, store_grid)
    s0 = store_grid[0]
    slots = 132 * ac._blocks_per_sm(itemsize, tx, ty)
    cols = grid[0] * grid[1]

    def cost(t):
        return -(-cols * -(-s0 // t) // slots) * (t + 1)

    assert all(cost(tz) < cost(t) or (cost(tz) == cost(t) and tz >= t)
               for t in range(1, min(64, s0) + 1))
    if (itemsize, store_grid) == (4, (104, 104, 128)):
        assert (tz, grid) == (21, (2, 26, 5)) and slots == 264


@pytest.mark.parametrize("itemsize", [4, 8])
def test_assemble_smem_of_the_tiles(itemsize):
    """10 stiffness entries for each of 6 types of each of the (ty + 1) x
    (tx + 1) cells; every built tile fits a block, and an SM holds at
    least one."""
    for tx, ty in ac.ASSEMBLE_TILES:
        smem = ac.assemble_smem(itemsize, tx, ty)
        assert smem == 60 * (ty + 1) * (tx + 1) * itemsize <= _SMEM_PER_BLOCK
        assert ac._blocks_per_sm(itemsize, tx, ty) >= 1


@pytest.mark.parametrize("check, tile", [
    (ac.check_assemble_tile, (16, 16, 4)),
    (ac.check_assemble_tile, (64, 4, 0)),
    (ac.check_assemble_tile, (64, 8, 4)),
    (fs.check_fused_2d_tile, (32, 4)), (fs.check_fused_2d_tile, (128, 4)),
    (fs.check_fused_2d_tile, (64, 0))],
    ids=["b13-16x16", "b13-tz0", "b13-64x8", "b7-32", "b7-128",
         "b7-rows0"])
def test_a_tile_without_a_kernel_raises(check, tile):
    with pytest.raises(ValueError, match="tile"):
        check(4, *tile)


@pytest.mark.parametrize("tiling, store_grid", [
    (ac.assemble_tiling, (16, 16, 48)), (ac.assemble_tiling, (0, 16, 128)),
    (fs.fused_2d_tiling, (0, 128))])
def test_tiling_refuses_partial_or_empty_grids(tiling, store_grid):
    with pytest.raises(ValueError):
        tiling(4, store_grid)


# -- B7 tiles ------------------------------------------------------------------

@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("store_grid", [(1032, 1152), (16, 128), (32, 128),
                                        (208, 256), (4104, 4224), (3, 128)])
def test_fused_2d_tiling_is_a_tile_the_launcher_takes(itemsize, store_grid):
    """Every pick is a built tile that fits the card; its tiles of tx - 1
    columns (and column 0) cover every store column, the last one ragged,
    and its bands every store row, the last one ragged."""
    tx, rows, smem, grid = fs.fused_2d_tiling(itemsize, store_grid)
    fs.check_fused_2d_tile(itemsize, tx, rows)
    s0, s1 = store_grid
    assert tx in fs.FUSED_2D_TILES and 1 <= rows <= s0
    assert smem == fs.fused_2d_smem(itemsize, tx) <= _SMEM_PER_BLOCK
    assert grid == (-(-(s1 - 1) // (tx - 1)), 1, -(-s0 // rows))
    assert (grid[0] - 1) * (tx - 1) < s1 - 1 <= grid[0] * (tx - 1)
    assert (grid[2] - 1) * rows < s0 <= grid[2] * rows


def _b7_columns(s1, tx):
    """The store columns B7's tiles complete, as the kernel assigns them:
    thread j of tile b has column b (tx - 1) + j, which it completes if it
    lies in the grid and j > 0 or b = 0."""
    cols = []
    for b in range(-(-(s1 - 1) // (tx - 1))):
        for j in range(tx):
            sx = b * (tx - 1) + j
            if sx < s1 and (j > 0 or b == 0):
                cols.append(sx)
    return cols


@pytest.mark.parametrize("s1", [128, 256, 1152, 4224])
@pytest.mark.parametrize("tx", fs.FUSED_2D_TILES)
def test_fused_2d_tiles_complete_every_column_once(s1, tx):
    assert _b7_columns(s1, tx) == list(range(s1))


def test_fused_2d_tiling_at_the_paths_shapes():
    """n=1024 (1032 x 1152 store rows): tiles of 64 cells completing 63
    columns, bands of 5 rows in fp32, 3 in fp64; a grid shorter than a
    band takes one band."""
    assert fs.fused_2d_tiling(4, (1032, 1152)) == (
        64, 5, fs.fused_2d_smem(4, 64), (19, 1, 207))
    assert fs.fused_2d_tiling(8, (1032, 1152))[:2] == (64, 3)
    assert fs.fused_2d_tiling(4, (3, 128))[1] == 3


@pytest.mark.parametrize("itemsize", [4, 8])
def test_fused_2d_smem_of_the_tiles(itemsize):
    """A ring of 3 cell rows of 9 values for each of 2 types of each of the
    tx cells."""
    for tx in fs.FUSED_2D_TILES:
        smem = fs.fused_2d_smem(itemsize, tx)
        assert smem == 3 * 2 * 9 * tx * itemsize <= _SMEM_PER_BLOCK


# -- B13's march order ---------------------------------------------------------

def _plan(dims):
    return structured_plan(box_mesh(-1, 2, 0, 1, -2, 0, *dims), embed=True)


def _macro_calls(header, name):
    """[(kind, args)] of the macro list ``name`` in a generated header."""
    line = next(ln for ln in header.splitlines()
                if ln.startswith(f"#define {name}("))
    body = line.split(")", 1)[1]
    return [(m[0], tuple(int(v) for v in m[1].split(",")))
            for m in re.findall(r"([SC])\(([^)]*)\)", body)]


def test_assemble_header_carries_the_za1_pairs():
    """The early list holds exactly the 12 (type, local row) pairs whose
    entry_shift z component is 2 (the cells one plane below the row), in
    (t, a) order, each with its 4 entries; the late list holds every
    za = 0 term and each carried value once."""
    plan = _plan((4, 4, 4))
    header = ac.tables_header(plan)
    early = _macro_calls(header, "TPUFEM_ASM_FOR_EARLY")
    late = _macro_calls(header, "TPUFEM_ASM_FOR_LATE")
    pairs = []
    for _, args in early:
        if args[:2] not in pairs:
            pairs.append(args[:2])
    want = [(t, a) for t in range(6) for a in range(4)
            if plan.entry_shift[t, a, 0, 0] == 2]
    assert len(want) == 12 and pairs == want
    assert len(early) == 48
    carried = int(re.search(r"TPUFEM_ASM_CARRIED (\d+)", header)[1])
    kept = [args[-1] for kind, args in early if kind == "C"]
    assert kept == list(range(carried)) and carried == 14
    assert sorted(args[-1] for kind, args in late if kind == "C") == kept
    assert sum(kind == "S" for kind, _ in late) == 48
    assert sum(kind == "S" for kind, _ in early) == 48 - carried


def _replay(plan, X_emb):
    """B13's node phase replayed on whole planes from its generated header,
    read as csrc/assemble.cu reads it: the prefix sums and carried values
    of the za = 1 terms (early S(t, a, b, ya, xa, k), C(t, a, b, ya, xa,
    i)), then the late terms (S(t, a, b, ya, xa, k), C(k, ya, xa, i)); a
    cell outside the grid is skipped."""
    cg, sg = plan.info.cell_grid, plan.store_grid
    X = X_emb[:, :, :, :cg[0], 1:1 + cg[1], 1:1 + cg[2]]
    Ke = p1_stiffness_bt(X, "tetrahedron")
    ones = torch.ones(cg, dtype=torch.bool)

    def term(t, a, b, za, ya, xa):
        shift = (1 + za, 1 + ya, 1 + xa)
        return (_padded(Ke[t, a, b], shift, cg, sg),
                _padded(ones, shift, cg, sg))

    header = ac.tables_header(plan)
    acc = torch.zeros((plan.width,) + tuple(sg), dtype=X_emb.dtype)
    kept = {}
    for kind, (t, a, b, ya, xa, j) in _macro_calls(header,
                                                   "TPUFEM_ASM_FOR_EARLY"):
        v, m = term(t, a, b, 1, ya, xa)
        if kind == "S":
            acc[j] = torch.where(m, acc[j] + v, acc[j])
        else:
            kept[j] = (v, m, (t, a, b, ya, xa))
    for kind, args in _macro_calls(header, "TPUFEM_ASM_FOR_LATE"):
        if kind == "S":
            t, a, b, ya, xa, k = args
            v, m = term(t, a, b, 0, ya, xa)
        else:
            t, a, b, ya, xa, k, i = args
            v, m, cell = kept[i]
            assert (t, a, b, ya, xa) == cell
        acc[k] = torch.where(m, acc[k] + v, acc[k])
    return acc.reshape(plan.width, -1)


@pytest.mark.parametrize("dims", [(5, 4, 6), (9, 3, 4)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_assemble_march_order_is_the_plain_order(dims, dtype):
    """Replayed from the header's lists, the march's sums equal the plain
    version's stencil planes bit for bit, on boxes whose cells are not
    cubes (every entry distinct from its neighbours')."""
    mesh = box_mesh(-1, 2, 0, 1, -2, 0, *dims)
    plan = structured_plan(mesh, embed=True)
    rng = np.random.default_rng(sum(dims))
    X = ac.element_coords_bt_embedded(mesh, plan, dtype=dtype)
    cg = plan.info.cell_grid
    # jitter every cell's coordinates on its own: distinct entries per cell
    cells = (slice(None),) * 3 + (slice(0, cg[0]),) + tuple(
        slice(1, 1 + c) for c in cg[1:])
    X[cells] += rng.uniform(-0.02, 0.02, X[cells].shape).astype(dtype)
    X = torch.as_tensor(X)
    assert torch.equal(_replay(plan, X),
                       ac.assemble_stencil_plain(plan, X).data)
