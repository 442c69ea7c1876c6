"""The designs of the banded SpMV kernels B12 (``bcsr_band_tiling``) and
B10 (``ell_multi_tiling``) on the CPU: every design either chooser can
pick fits its kernel's limits (threads a block, whole warps, 227 KB of
shared memory), the picks at the paths' shapes are the ones the sweep
(``scripts/kernel_ab.py --tiles``) measured fastest, and B10's row
alignment allows a vector access only where every row of X and Y starts
on it.  The kernels themselves run on the card (tests/test_torch_cuda.py).
"""
import pytest
import torch

from tpufem_torch.sparse import ell_cuda

_SMEM = 232448 - 1024   # shared memory a block may stage (227 KB, less
                        # 1 KB kept for the kernels' static part)
_BAND_THREADS = 384     # bcsr_spmv's __launch_bounds__
_MULTI_THREADS = 256    # ell_spmv_multi's __launch_bounds__


@pytest.mark.parametrize("tile", ell_cuda.BCSR_TILE_ROWS)
def test_bcsr_band_tiles_fit_the_kernel(tile):
    """Every tile B12's sweep times is 1 to 384 rows, one thread each (the
    kernel's __launch_bounds__; the launch refuses a tile past it,
    tests/test_torch_cuda.py); the pick is one of them."""
    assert 1 <= tile <= _BAND_THREADS
    assert ell_cuda.bcsr_band_tiling() in ell_cuda.BCSR_TILE_ROWS


def test_bcsr_band_tiling_matches_the_measured_tiles():
    """384 rows: the fastest (or within 1% of it) at each of the elasticity
    paths' four shapes and types in the sweep, so every shape takes it."""
    assert ell_cuda.bcsr_band_tiling() == 384


@pytest.mark.parametrize("q", [2, 3, 4, 5, 8, 9, 16])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_ell_multi_designs_fit_the_kernel(itemsize, q):
    """Whole warps, at most 256 threads a block, the staged X rows within
    227 KB; the pick is one of them."""
    designs = ell_cuda.ell_multi_designs(itemsize, q)
    assert designs
    for threads, window in designs:
        assert threads % 32 == 0 and 32 <= threads <= _MULTI_THREADS
        assert 0 <= window * q * itemsize <= _SMEM
    assert tuple(ell_cuda.ell_multi_tiling(itemsize, q)) in {
        tuple(d) for d in designs}


def test_ell_multi_tiling_matches_the_measured_designs():
    """The designs of the unstructured path's q = 3 block and of
    ``chip_smoke.py``'s q = 8 check, (threads, staged X rows): the fastest
    of each sweep; any other q or type takes (256, 0)."""
    assert {q: ell_cuda.ell_multi_tiling(4, q) for q in (3, 8)} == {
        3: (256, 2560), 8: (256, 0)}
    assert ell_cuda.ell_multi_tiling(8, 3) == (256, 0)


@pytest.mark.parametrize("dtype,q,shift,align", [
    (torch.float32, 4, 0, 16), (torch.float32, 8, 0, 16),
    (torch.float32, 2, 0, 8), (torch.float32, 6, 0, 8),
    (torch.float32, 3, 0, 4), (torch.float32, 4, 1, 4),
    (torch.float32, 4, 2, 8), (torch.float64, 2, 0, 16),
    (torch.float64, 3, 0, 8), (torch.float64, 2, 1, 8)])
def test_row_alignment_allows_vector_access_only_where_rows_start(
        dtype, q, shift, align):
    """B10 takes 16- or 8-byte accesses of a row only where every row of X
    and of Y starts on that boundary: the rows' pitch q * itemsize and both
    base pointers (a view ``shift`` elements into its storage)."""
    n = 10
    buf = torch.empty(n * q + 4, dtype=dtype)
    assert buf.data_ptr() % 16 == 0
    X = buf[shift:shift + n * q].view(n, q)
    Y = torch.empty((n, q), dtype=dtype)
    assert ell_cuda._row_align(X.element_size(), q, X, Y) == align
    assert ell_cuda._row_align(X.element_size(), q, Y, X) == align


@pytest.mark.parametrize("b", [2, 3, 4, 5, 6])
@pytest.mark.parametrize("k", [1, 4, 8, 16, 25, 64, 128, 512])
@pytest.mark.parametrize("rows", [705, 6189, 491_401])
def test_bcsr_band_design(b, k, rows):
    """B12 takes its unrolled instance only for b = 2, 3 with K = 8 or 16
    (the elasticity operators); the AMG levels and transfers take b
    threads a row for b = 2, 3 on fewer than 65,536 rows (the 982k
    hierarchy's coarse levels), a thread a row otherwise (b = 4 to 6 and
    the fine transfers): scripts/bcsr_amg_ab.py's fastest."""
    design = ell_cuda.bcsr_band_design(b, k, rows)
    if b <= 3 and k in (8, 16):
        assert design == "unrolled"
    else:
        assert design == ("out" if b <= 3 and rows < 65536 else "loop")


@pytest.mark.parametrize("rows,tile", [
    (0, 32), (1, 32), (705, 32), (6189, 32), (54_771, 224),
    (68_921, 288), (491_401, 384), (10 ** 7, 384)])
def test_bcsr_loop_tiling(rows, tile):
    """The run-time loop's block rows: whole warps, 32 to 384 (the
    kernel's bound), two blocks per SM where the rows allow, 384 on the
    large levels (the unrolled instance's tile)."""
    got = ell_cuda.bcsr_loop_tiling(rows)
    assert got == tile and got % 32 == 0 and 32 <= got <= _BAND_THREADS


@pytest.mark.parametrize("itemsize,b,k,rows", [
    (4, 2, 8, 128), (4, 3, 16, 32), (8, 6, 64, 4), (8, 6, 128, 2),
    (8, 6, 256, 1), (4, 6, 128, 4)])
def test_bcsr_gather_tiling_takes_fewer_rows_for_fat_blocks(itemsize, b, k,
                                                            rows):
    """B12g's tile: the most rows whose staged tile fits 24 KB, else 4
    rows, and 2 or 1 where two buffers of 4 would not fit 227 KB (the fat
    6 x 6 AMG levels); past one row of about 390 fp64 6 x 6 slots it
    raises."""
    got, smem = ell_cuda.bcsr_gather_tiling(itemsize, b, k)
    assert got == rows and smem <= _SMEM + 1024
    with pytest.raises(ValueError, match="fits shared memory"):
        ell_cuda.bcsr_gather_tiling(8, 6, 400)
