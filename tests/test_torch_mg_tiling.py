"""The tile planner of the tiled transfer kernels K3 and K4
(tpufem_torch.ops.mg_transfer_cuda.transfer_tiling): the tiles cover the
store grids the multigrid hierarchies give, the staged planes fit the
shared memory the launcher asks for, and the tiles of the paths' finest
level pairs are pinned.  Pure Python: runs without a card."""
import pytest

from tpufem_torch.assemble.structured import structured_plan
from tpufem_torch.ops import mg_transfer_cuda
from tpufem_torch.ops.mg_transfer_cuda import transfer_smem, transfer_tiling
from tpufem_torch.solve.multigrid import _light_grid

_SMEM_PER_BLOCK = 232448      # a block's shared memory on the H100


def _pair(n):
    """(fine store grid, coarse store grid, coarse node grid) of n -> n/2."""
    fine, coarse = (structured_plan(_light_grid((-3.0, 3.0), m, 3,
                                                with_coords=False)[0],
                                    embed=True) for m in (n, n // 2))
    return (tuple(fine.store_grid), tuple(coarse.store_grid),
            tuple(coarse.info.node_grid))


@pytest.mark.parametrize("n", [8, 12, 16, 24, 48, 64, 96, 192, 384])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("kernel", ["K3", "K4"])
def test_tiles_cover_the_store_grid(kernel, itemsize, n):
    """The grid of tiles covers the store grid the kernel tiles (K4 the
    fine one in 128 columns, K3 the coarse one in 64) with no tile wholly
    outside it, the rows are ones the launcher has a kernel for, and the
    coarse nodes map into the fine grid's rows."""
    fine_sg, coarse_sg, coarse_ng = _pair(n)
    ty, tz, smem, grid = transfer_tiling(kernel, itemsize, fine_sg,
                                         coarse_sg, coarse_ng)
    assert ty in mg_transfer_cuda.TILE_ROWS[kernel]
    sg, cols = (fine_sg, 128) if kernel == "K4" else (coarse_sg, 64)
    assert sg[2] % cols == 0 and grid[0] * cols == sg[2]
    for count, tile, extent in ((grid[1], ty, sg[1]), (grid[2], tz, sg[0])):
        assert count * tile >= extent > (count - 1) * tile
    assert all(2 * nc + 1 < nf for nc, nf in zip(coarse_ng, fine_sg))
    assert grid[0] * grid[1] * grid[2] < 2 ** 31


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("kernel", ["K3", "K4"])
def test_staged_planes_fit_the_shared_memory_asked_for(kernel, itemsize):
    """The bytes the launcher asks for are the staged planes of the tile
    with its halo: K4 code (3), e (2) and masked e' (3) over ty + 2 rows
    of 128 columns and a 16-byte chunk either side, r (2) and e' (2) over
    the ty x 128 core; K3 e (2), code (2) and masked e (3) over 2 ty + 3
    rows of 132, r (2) over 2 ty + 1 rows of 132, the ty x 64 coarse
    codes, 4 residual planes of 2 ty + 1 rows of 130 and 2 planes of
    their one-byte interior flags.  Every tile the launcher has a kernel
    for fits a block; the picked one leaves room for three blocks on an
    SM in fp32 (the kernels' launch bounds) and two in fp64."""
    for ty in range(1, 17):
        if kernel == "K4":
            row = 128 + 2 * 16 // itemsize
            want = (8 * (ty + 2) * row + 4 * ty * 128) * itemsize
        else:
            er, qr = 2 * ty + 3, 2 * ty + 1
            flags = 2 * qr * 130
            want = ((7 * er * 132 + 2 * qr * 132 + 64 * ty + 4 * qr * 130)
                    * itemsize + (flags + 15) // 16 * 16)
        assert transfer_smem(kernel, itemsize, ty) == want
    for ty in mg_transfer_cuda.TILE_ROWS[kernel]:
        assert transfer_smem(kernel, itemsize, ty) <= _SMEM_PER_BLOCK
    ty = mg_transfer_cuda._ROWS[kernel][itemsize]
    blocks = 3 if itemsize == 4 else 2
    assert blocks * (transfer_smem(kernel, itemsize, ty) + 1024) <= 233472


@pytest.mark.parametrize("n,itemsize,k4,k3", [
    (96, 4, (8, 4, 59904, (1, 13, 26)), (4, 2, 72256, (2, 14, 28))),
    (96, 8, (4, 8, 67072, (1, 26, 13)), (3, 4, 113792, (2, 19, 14))),
    (384, 4, (8, 32, 59904, (4, 49, 13)), (4, 16, 72256, (4, 50, 13))),
    (384, 8, (4, 32, 67072, (4, 98, 13)), (3, 16, 113792, (4, 67, 13)))])
def test_tiles_of_the_paths_are_pinned(n, itemsize, k4, k3):
    """The tiles of 96 -> 48 and 384 -> 192, the fastest or within 3% of
    the fastest in the tile sweep on the H100 (PERF.md section 6): (rows,
    planes, shared memory bytes, grid)."""
    pair = _pair(n)
    assert transfer_tiling("K4", itemsize, *pair) == k4
    assert transfer_tiling("K3", itemsize, *pair) == k3


def test_k3_counts_only_blocks_that_hold_coarse_nodes():
    """At 96 -> 48 the coarse store rows are 128 wide and 49 hold nodes:
    K3's second column of tiles writes only zeros, so in fp32 (4 coarse
    rows a tile) four planes a block leave 13 x 13 = 169 working blocks,
    short of the 198 (three for every two SMs) that two planes give (13 x
    25 = 325), though the whole grid would hold 2 x 14 x 14 = 392."""
    fine_sg, coarse_sg, coarse_ng = _pair(96)
    assert coarse_sg == (56, 56, 128) and coarse_ng == (49, 49, 49)
    assert mg_transfer_cuda._MIN_BLOCKS == 198
    assert mg_transfer_cuda._working(1, 49, 64, 2) == 1
    assert mg_transfer_cuda._working(1, 49, 4, 14) == 13
    assert mg_transfer_cuda._working(1, 49, 2, 28) == 25
    assert transfer_tiling("K3", 4, fine_sg, coarse_sg, coarse_ng)[1] == 2
