"""The tile planner of the staged const stencil kernel B5, which B5b's route
launches too (tpufem_torch.ops.stencil_cuda.const_tiling, const_smem and
const_store_grid): the tiles cover the store grids of the multigrid
hierarchies, the staged planes fit the shared memory the launcher asks
for, the tiles of the paths' finest levels are pinned and fill a wave, and
the store grid derived from a level's flat offsets is the plan's.  Pure
Python: runs without a card."""
import functools

import pytest

from tpufem_torch.assemble.structured import structured_plan
from tpufem_torch.ops import stencil_cuda
from tpufem_torch.ops.stencil_cuda import (const_blocks_per_sm, const_smem,
                                           const_store_grid, const_tiling)
from tpufem_torch.solve.multigrid import _light_grid

_SMEM_PER_BLOCK = 232448      # a block's shared memory on the H100
_SMEM_PER_SM = 233472         # an SM's, 1 KB of it reserved per block
_SMS = 132
# (vector, code) item sizes: fp32, bf16 code under fp32 vectors, fp64
_TYPES = [(4, 4), (4, 2), (8, 8)]
# every level of the paths' hierarchies: 3D n = 8 ... 384, 2D n = 8 ... 1024
_LEVELS = ([(3, n) for n in (8, 12, 16, 24, 48, 64, 96, 192, 384)]
           + [(2, n) for n in (8, 16, 32, 64, 128, 256, 512, 1024)])


@functools.lru_cache(maxsize=None)
def _plan(n, dim):
    return structured_plan(_light_grid((-3.0, 3.0), n, dim,
                                       with_coords=False)[0], embed=True)


@pytest.mark.parametrize("dim,n", _LEVELS)
@pytest.mark.parametrize("itemsize,code_itemsize", _TYPES)
def test_tiles_cover_the_store_grid(dim, n, itemsize, code_itemsize):
    """The grid of tiles covers the store grid (128 columns a tile; 3D: ty
    rows by tz planes; 2D: tz bands of ty rows) with no tile wholly
    outside it, the rows are ones the launcher has a kernel for, and the
    planes or bands are 1 to 32."""
    plan = _plan(n, dim)
    k = len(plan.offsets)
    ty, tz, smem, grid = const_tiling(k, itemsize, tuple(plan.store_grid),
                                      code_itemsize)
    assert ty in stencil_cuda.CONST_TILE_ROWS
    assert smem == const_smem(k, itemsize, ty, code_itemsize)
    sg = tuple(plan.store_grid)
    assert sg[-1] % 128 == 0 and grid[0] * 128 == sg[-1]
    if dim == 3:
        tiles = ((grid[1], ty, sg[1]), (grid[2], tz, sg[0]))
    else:
        assert grid[1] == 1
        tiles = ((grid[2], tz * ty, sg[0]),)
    for count, tile, extent in tiles:
        assert count * tile >= extent > (count - 1) * tile
    assert 1 <= tz <= 32 and max(grid[1], grid[2]) <= 65535


@pytest.mark.parametrize("k", [15, 7])
@pytest.mark.parametrize("itemsize,code_itemsize", _TYPES)
def test_staged_planes_fit_the_shared_memory_asked_for(k, itemsize,
                                                       code_itemsize):
    """The bytes the launcher asks for are the staged planes: x and code,
    four planes (3D; three bands in 2D) each of ty + 2 rows by 128 columns
    and a 16-byte chunk either side (the code in its own type and chunk),
    four such planes of the masked x (two in 2D), and b's two ty x 128
    tiles.  Every tile the launcher has a kernel for fits a block; the
    picked one leaves room for the blocks per SM the planner counts (at
    least two), within an SM's threads."""
    nr, nm = (4, 4) if k == 15 else (3, 2)
    for ty in range(1, 17):
        ry = ty + 2
        want = (((nr + nm) * ry * (128 + 32 // itemsize) + 2 * ty * 128)
                * itemsize
                + nr * ry * (128 + 32 // code_itemsize) * code_itemsize)
        assert const_smem(k, itemsize, ty, code_itemsize) == want
    for ty in stencil_cuda.CONST_TILE_ROWS:
        assert const_smem(k, itemsize, ty, code_itemsize) <= _SMEM_PER_BLOCK
    ty = stencil_cuda._CONST_ROWS[itemsize]
    blocks = const_blocks_per_sm(k, itemsize, ty, code_itemsize)
    assert blocks >= 2
    assert blocks * (const_smem(k, itemsize, ty, code_itemsize)
                     + 1024) <= _SMEM_PER_SM
    assert blocks * 256 <= 2048


@pytest.mark.parametrize("dim,n,itemsize,want", [
    (3, 96, 4, (8, 4, 73472, (1, 13, 26))),
    (3, 96, 8, (6, 8, 113664, (1, 18, 13))),
    (3, 384, 4, (8, 32, 73472, (4, 49, 13))),
    (3, 384, 8, (6, 32, 113664, (4, 66, 13))),
    (2, 1024, 4, (8, 3, 51712, (9, 1, 43))),
    (2, 1024, 8, (6, 6, 79872, (9, 1, 29)))])
def test_tiles_of_the_paths_are_pinned(dim, n, itemsize, want):
    """The tiles of 3D level 96 (the main and nu2 paths), 3D level 384
    (B5b's, the scale path) and 2D level 1024 (the 2d paths), the fastest
    or within 5% of the fastest in the tile sweep on the H100 (PERF.md
    section 6): (rows, planes or bands, shared memory bytes, grid)."""
    plan = _plan(n, dim)
    assert const_tiling(len(plan.offsets), itemsize,
                        tuple(plan.store_grid)) == want


@pytest.mark.parametrize("dim,n", [(3, 64), (3, 96), (3, 192), (2, 512),
                                   (2, 1024)])
@pytest.mark.parametrize("itemsize,code_itemsize", _TYPES)
def test_tiles_fit_one_wave_with_the_fewest_planes(dim, n, itemsize,
                                                   code_itemsize):
    """The picked tile's blocks fit in one wave, the blocks the card holds
    at once (132 SMs, each with as many blocks as its shared memory and
    threads allow), unless even 32 planes a block leave more; one plane
    (band) fewer a block would not fit; at level 96 and 2D level 1024 the
    wave is more than half full."""
    plan = _plan(n, dim)
    k, sg = len(plan.offsets), tuple(plan.store_grid)
    ty, tz, _, grid = const_tiling(k, itemsize, sg, code_itemsize)
    at_once = _SMS * const_blocks_per_sm(k, itemsize, ty, code_itemsize)
    assert grid[0] * grid[1] * grid[2] <= at_once or tz == 32
    if tz > 1:
        fewer = stencil_cuda._const_grid(k, sg, ty, tz - 1)
        assert fewer[0] * fewer[1] * fewer[2] > at_once
    if n in (96, 1024):
        assert 2 * grid[0] * grid[1] * grid[2] > at_once


@pytest.mark.parametrize("dim,n", [(3, 8), (3, 24), (3, 96), (3, 192),
                                   (3, 384), (2, 8), (2, 128), (2, 1024)])
def test_store_grid_derived_from_offsets_is_the_plans(dim, n):
    """The flat offsets and the row count give the plan's store grid, and
    the plan's own store grid passes the check."""
    plan = _plan(n, dim)
    sg = tuple(plan.store_grid)
    assert const_store_grid(plan.offsets, plan.num_store_rows) == sg
    assert const_store_grid(list(plan.offsets), plan.num_store_rows,
                            list(sg)) == sg


# the Kuhn split's steps; the other split of the cube mirrors x
_STEPS3 = ((-1, -1, -1), (-1, -1, 0), (-1, 0, -1), (-1, 0, 0), (0, -1, -1),
           (0, -1, 0), (0, 0, -1), (0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
           (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1))


def _foreign(case):
    """(offsets, rows, store grid or None) that must raise."""
    p3, p2 = _plan(16, 3), _plan(16, 2)
    o3, n3, o2, n2 = p3.offsets, p3.num_store_rows, p2.offsets, \
        p2.num_store_rows
    s0, s1, s2 = p3.store_grid
    return {
        # the same rows on another grid than the offsets'
        "3D grid mismatch": (o3, n3, (s1, s0 * 2, s2 // 2)),
        "2D grid mismatch": (o2, n2, (p2.store_grid[0] // 2, 256)),
        "3D grid for 2D offsets": (o2, n2, (1,) + tuple(p2.store_grid)),
        # rows that are not whole planes or rows
        "3D partial plane": (o3, n3 + 128, None),
        "2D partial row": (o2, n2 + 1, None),
        # other stencils: another order, the other split of the cell, the
        # 27-point box, another count
        "3D reversed": (tuple(reversed(o3)), n3, None),
        "3D other split": (tuple(sorted(dz * s1 * s2 + dy * s2 - dx
                                        for dz, dy, dx in _STEPS3)), n3,
                           None),
        "27-point box": (tuple(dz * s1 * s2 + dy * s2 + dx
                               for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                               for dx in (-1, 0, 1)), n3, None),
        "2D five-point": ((-128, -1, 0, 1, 128), n2, None),
        "2D other split": (tuple(sorted(dy * 128 - dx for dy, dx in (
            (-1, 0), (-1, 1), (0, -1), (0, 0), (0, 1), (1, -1), (1, 0)))),
            n2, None),
    }[case]


@pytest.mark.parametrize("case", [
    "3D grid mismatch", "2D grid mismatch", "3D grid for 2D offsets",
    "3D partial plane", "2D partial row", "3D reversed", "3D other split",
    "27-point box", "2D five-point", "2D other split"])
def test_mismatched_or_foreign_offsets_raise(case):
    offsets, rows, store_grid = _foreign(case)
    with pytest.raises(ValueError):
        const_store_grid(offsets, rows, store_grid)


def test_tiling_refuses_rows_off_128_columns():
    """The kernel's tile is 128 store columns: a grid whose rows are not
    whole tiles is refused."""
    with pytest.raises(ValueError):
        const_tiling(15, 4, (16, 16, 96))
    with pytest.raises(ValueError):
        const_tiling(7, 4, (16, 200))
