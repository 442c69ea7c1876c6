"""B9's plan and forms on the host: the banded plan keeps only the slot
planes that hold a nonzero and records each row's length (the slot after
its last nonzero), which on the native Galerkin hierarchies of a small P2
rectangle and a P2-tet box (widths max(4K, 24) a level) is the longest
row; the plain product on the trimmed plan equals the one on the
untrimmed plan bit for bit for finite x (fp32 and fp64, int16 and int32
windows, rows of length 0 and K), and differs only where x holds a NaN at
a padding column; the form chooser (ell_band_design) and B9g's tile
chooser (ell_gather_tiling) as pure functions; the AMG-PCG count of a
small P2 system on trimmed plans equals the JAX package's."""
import functools

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from tpufem_torch.convert import band_plan_from_numpy
from tpufem_torch.fem.space import FunctionSpace
from tpufem_torch.forms import language as tl
from tpufem_torch.forms.weakform import WeakForm
from tpufem_torch.mesh.adjacency import reverse_cuthill_mckee
from tpufem_torch.mesh.box import box_mesh
from tpufem_torch.mesh.rectangle import rectangle_mesh
from tpufem_torch.solve.amg import build_amg
from tpufem_torch.solve.bc import apply_dirichlet_ell
from tpufem_torch.solve.cg import cg
from tpufem_torch.sparse import ell_cuda as ec
from tpufem_torch.sparse.ell import ELLMatrix, reorder_ell

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """One BLAS thread a test, as one torch thread: numpy's OpenBLAS
    threads spin against the other workers on the shared CPU (a 729 x 729
    inverse takes seconds on eight, 0.07 s on one)."""
    with threadpool_limits(1, user_api="blas"):
        yield


@functools.lru_cache(maxsize=None)
def _p2_hierarchy(kind, n):
    """(A_p, b_p, hierarchy) of the RCM-ordered P2 Poisson system on the
    n x n rectangle (Dirichlet) or the n^3 box of tetrahedra (pure
    Neumann plus a mass term), greedy strength-0.08 AMG, coarse_n 60."""
    if kind == "rect":
        V = FunctionSpace(rectangle_mesh(-3, 3, -3, 3, n, n), degree=2)
        a = lambda u, v: tl.dot(tl.grad(u), tl.grad(v))
    else:
        V = FunctionSpace(box_mesh(-3, 3, -3, 3, -3, 3, n, n, n), degree=2)
        a = lambda u, v: tl.dot(tl.grad(u), tl.grad(v)) + u * v
    X = tl.SpatialCoordinate(V)
    A, b = WeakForm(V, device="cpu").build(
        a, lambda v: (9 - X[0] ** 2) * v).assemble(format="ell")
    if kind == "rect":
        A, b = apply_dirichlet_ell(A, b, torch.as_tensor(V.dof_flags))
    perm = reverse_cuthill_mckee(A.cols.numpy())
    data_p, cols_p = reorder_ell(A.data, A.cols, perm)
    A_p = ELLMatrix(torch.as_tensor(data_p), torch.as_tensor(cols_p))
    return A_p, b[torch.as_tensor(perm)], build_amg(
        A_p, aggregation="greedy", strength=0.08, coarse_n=60)


def _longest(data):
    """Per row the slot after its last nonzero value, in the matrix's own
    slot numbering."""
    nz = np.asarray(data) != 0
    k = nz.shape[1]
    return np.where(nz.any(1), k - np.argmax(nz[:, ::-1], axis=1), 0)


@pytest.mark.parametrize("kind,n", [("rect", 40), ("box", 6)])
def test_row_lengths_on_galerkin_hierarchies(kind, n):
    _, _, h = _p2_hierarchy(kind, n)
    widths = [lv.A.data.shape[1] for lv in h.levels]
    assert len(widths) >= 2
    for w0, w1 in zip(widths, widths[1:]):
        assert w1 == max(4 * w0, 24)            # the native Galerkin width
    for lv in h.levels:
        for M in (lv.A, lv.Qp, lv.Qr):
            if M is None:
                continue
            plan = ec.ell_band_plan(M.data, M.cols)
            lens = _longest(M.data)
            assert plan.width == lens.max() < M.data.shape[1] or (
                plan.width == lens.max() == M.data.shape[1])
            np.testing.assert_array_equal(plan.row_len[:plan.n], lens)
            assert not plan.row_len[plan.n:].any()
            assert plan.data_t.shape == plan.rel.shape == (plan.width,
                                                           plan.np_rows)
            assert len(plan.d_lists) == plan.width
    A0 = h.levels[0].A
    assert ec.ell_band_plan(A0.data, A0.cols).width < A0.data.shape[1]


def _untrimmed(data, cols, R):
    """The plan of every K slot plane (as the reference keeps them)."""
    n, K = data.shape
    nb = -(-n // R)
    NP = nb * R
    dp = np.zeros((NP, K))
    dp[:n] = data
    cp = np.concatenate([cols, np.broadcast_to(
        np.arange(n, NP, dtype=np.int32)[:, None], (NP - n, K))])
    rel = cp.astype(np.int64) - ((np.arange(NP) // R - 1) * R)[:, None]
    idx = np.int16 if 3 * R <= 32767 else np.int32
    return band_plan_from_numpy(
        rel.T.astype(idx), dp.T, n=n, np_rows=NP, block_rows=R,
        d_lists=((),) * K, width=K)[0]


def _padded_case(seed, n=900, K=12, band=60):
    """Rows of 0 ... K nonzeros (every fifth empty, one full), zeros and
    self columns after them, the last three planes all zero."""
    g = np.random.default_rng(seed)
    cols = np.clip(np.arange(n)[:, None] + g.integers(-band, band + 1,
                                                      (n, K)),
                   0, n - 1).astype(np.int32)
    lens = g.integers(0, K - 2, n)
    lens[::5] = 0
    lens[7] = K - 3
    data = g.standard_normal((n, K))
    pad = np.arange(K)[None, :] >= lens[:, None]
    data[pad] = 0
    cols[pad] = np.broadcast_to(np.arange(n, dtype=np.int32)[:, None],
                                (n, K))[pad]
    return data, cols, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("R", [128, 11008], ids=["int16", "int32"])
def test_trimmed_plan_product_bit_equal(dtype, R):
    data, cols, g = _padded_case(1)
    data[3] = g.standard_normal(data.shape[1])       # a row of length K
    data[3, -3:] = 0
    trimmed = ec.ell_band_plan(data, cols, block_rows=R)
    full = _untrimmed(data, cols, R)
    assert trimmed.rel.dtype == full.rel.dtype == (np.int16 if R == 128
                                                   else np.int32)
    assert (trimmed.width, full.width) == (data.shape[1] - 3, data.shape[1])
    assert trimmed.row_len[3] == trimmed.width
    assert (trimmed.row_len[:900:5] == 0).all()
    x = torch.as_tensor(g.standard_normal(900)).to(dtype)
    args = [(p, torch.as_tensor(p.data_t).to(dtype), torch.as_tensor(p.rel))
            for p in (trimmed, full)]
    y, y_full = (ec.ell_band_matvec_plain(*a, x) for a in args)
    assert torch.equal(y, y_full)
    assert torch.equal(y, ec.ell_gather_matvec_plain(
        torch.as_tensor(data).to(dtype), torch.as_tensor(cols), x))


def test_nan_at_a_padding_column_no_longer_reaches_y():
    """The one difference: x non-finite at a column that only padding in
    the dropped planes reaches (here column n - 1, from row 5's last three
    slots) reaches y on the untrimmed plan and not on the trimmed one."""
    data, cols, g = _padded_case(2)
    n, K = data.shape
    kept = cols[:, :K - 3]
    kept[kept == n - 1] = n - 2
    data[n - 1, :K - 3] = g.standard_normal(K - 3)      # no padding there
    cols[5, K - 3:] = n - 1
    trimmed = ec.ell_band_plan(data, cols, block_rows=512)
    full = _untrimmed(data, cols, 512)
    x = torch.as_tensor(g.standard_normal(n))
    x[n - 1] = float("nan")
    y, y_full = (ec.ell_band_matvec_plain(p, torch.as_tensor(p.data_t),
                                          torch.as_tensor(p.rel), x)
                 for p in (trimmed, full))
    assert y_full[5].isnan() and not y.isnan().any()
    same = ~y_full.isnan()
    assert torch.equal(y[same], y_full[same])


@pytest.mark.parametrize("form", ["split", "sliced"])
@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("R", [128, 11008], ids=["int16", "int32"])
def test_prepared_rows_replay_the_plain_product(form, compact, R):
    """The rows "split" and "sliced" read (ell_band_prepare, here on the
    host), replayed slot by slot: each computed row's slots up to its
    length in whole groups of 4, summed in order, give the plain product
    bit for bit.  "split": packed row after row (offsets multiples of 4);
    "sliced": sorted by length within windows, group g of position j at
    (((j / 32) G + g) 32 + j % 32) 4.  With ``compact`` only the non-empty
    rows are computed, and the bitmap marks them."""
    data, cols, g = _padded_case(3)
    n = data.shape[0]
    plan = ec.ell_band_plan(data, cols, block_rows=R)
    plan = plan._replace(form=ec.EllForm(form, compact, 4))
    d_t, rel = torch.as_tensor(plan.data_t), torch.as_tensor(plan.rel)
    dv = ec.ell_band_prepare(plan, d_t, rel)
    assert dv.fits(plan, d_t, rel) and dv.nbytes() > 0
    vals, pos = dv.data.numpy(), dv.rel.numpy().astype(np.int64)
    if form == "split":
        ptr = dv.length.numpy()
        rows = dv.live.numpy() if compact else np.arange(n)
        groups = np.diff(ptr) // 4
        assert (ptr % 4 == 0).all()
        slots = [np.arange(ptr[j], ptr[j + 1]) for j in range(rows.size)]
    else:
        rows, groups = dv.live.numpy(), dv.length.numpy()
        window = np.arange(rows.size) // ec._SLICE_WINDOW
        assert (np.diff(groups)[np.diff(window) == 0] <= 0).all()
        slots = [(((j // 32 * dv.groups + np.arange(groups[j]))[:, None] * 32
                   + j % 32) * 4 + np.arange(4)).ravel()
                 for j in range(rows.size)]
    assert (groups == (plan.row_len[rows] + 3) // 4).all()
    assert sorted(rows) == (list(np.flatnonzero(plan.row_len[:n]))
                            if compact else list(range(n)))
    if compact:
        bits = dv.bits.numpy().view(np.uint32)
        on = (bits[np.arange(n) // 32] >> (np.arange(n) % 32)) & 1
        np.testing.assert_array_equal(on, plan.row_len[:n] > 0)
    x = torch.as_tensor(g.standard_normal(n))
    y = torch.zeros(n, dtype=torch.float64)
    for i, idx in zip(rows, slots):
        base = (i // R - 1) * R
        acc = torch.zeros((), dtype=torch.float64)
        for e in idx:
            acc = acc + torch.as_tensor(vals[e]) * x[base + pos[e]]
        y[i] = acc
    assert torch.equal(y, ec.ell_band_matvec_plain(plan, d_t, rel, x))
    d_t.mul_(1.0)                           # a new version: stale
    assert not dv.fits(plan, d_t, rel)
    assert ec.ell_band_prepare(plan, d_t, rel).fits(plan, d_t, rel)


@pytest.mark.parametrize("form", ["rows", "split", "sliced"])
def test_layout_goes_with_its_matrix(form):
    """B9's layout is held by its ELLMatrix alone (nothing caches it): the
    matrix prepares it once, again only where its banded cache or the
    cache's arrays change, and it is freed with the matrix."""
    import gc
    import weakref

    data, cols, _ = _padded_case(4)
    A = ELLMatrix(torch.as_tensor(data), torch.as_tensor(cols))
    A.prime_band_plan(128)
    assert A._layout is None                    # the CPU takes no layout
    plan, d_t, rel = A._band
    A._band = (plan._replace(form=ec.EllForm(form, False, 4)), d_t, rel)
    lay = A._band_layout(A._band)
    assert A._band_layout(A._band) is lay and lay.fits(*A._band)
    if form == "rows":                          # the row lengths alone
        assert lay.nbytes() == 4 * plan.n and lay.data is d_t
    d_t.add_(0.0)                               # its arrays changed
    again = A._band_layout(A._band)
    assert again is not lay and again.fits(*A._band)
    gone = weakref.ref(again)
    del A, lay, again, plan, d_t, rel
    gc.collect()
    assert gone() is None


def test_an_all_zero_matrix_keeps_one_plane():
    data = np.zeros((300, 5))
    cols = np.broadcast_to(np.arange(300, dtype=np.int32)[:, None],
                           (300, 5)).copy()
    plan = ec.ell_band_plan(data, cols)
    assert plan.width == 1 and not plan.row_len.any()
    assert plan.form == ec.EllForm("rows", False, 1)
    y = ec.ell_band_matvec_plain(plan, torch.as_tensor(plan.data_t),
                                 torch.as_tensor(plan.rel),
                                 torch.ones(300, dtype=torch.float64))
    assert torch.equal(y, torch.zeros(300, dtype=torch.float64))


def _lengths(rows, lo, hi, live=1.0, seed=0):
    g = np.random.default_rng(seed)
    lens = g.integers(lo, hi + 1, rows)
    lens[g.random(rows) >= live] = 0
    return lens


@pytest.mark.parametrize("lens,form", [
    (np.full(1_002_001, 7), ("rows", False, 1)),          # P1: even rows
    (np.where(_lengths(1_030_301, 0, 99) < 4,             # hex fine A
              _lengths(1_030_301, 8, 18, seed=1), 27), ("rows", False, 1)),
    (_lengths(146_227, 19, 31), ("sliced", False, 1)),    # p2 level 1
    (_lengths(1_002_001, 9, 19), ("sliced", False, 1)),   # p2 fine A
    (_lengths(19_840, 40, 50), ("split", False, 32)),     # p2 level 2
    (_lengths(314, 30, 95), ("split", False, 4)),         # p2 level 4
    (_lengths(87_435, 100, 198), ("sliced", False, 1)),   # P2-tet level 1
    (_lengths(1_002_001, 20, 35, live=0.15), ("sliced", True, 1)),  # Qr
    (_lengths(146_227, 40, 66, live=0.14), ("split", True, 32)),    # Qr 1
    (np.r_[np.zeros(11_535, int), _lengths(19, 1000, 8163)],
     ("split", True, 1)),                                 # P2-tet Qr
    (np.zeros(1_002_001, int), ("rows", False, 1)),       # no nonzero
    (np.full(5_000, 7), ("split", False, 64)),            # short rows
], ids=["p1", "hex", "p2level1", "p2", "level2", "level4", "tet1", "qr", "qr1",
        "long-qr", "zero", "short"])
def test_band_design(lens, form):
    got = ec.ell_band_design(lens)
    assert got == ec.EllForm(*form)
    assert ec.ell_band_design(lens.copy()) == got          # pure
    if got.name == "split":
        lanes = ec._SPLIT_THREADS // got.tile_rows
        assert 4 <= lanes <= 256
        assert got.compact == (2 * np.count_nonzero(lens) < lens.size)


@pytest.mark.parametrize("itemsize,k,rows,tile", [
    (4, 8, 1_002_001, (0, 0)), (8, 80, 1_030_301, (-4, 0)),
    (4, 80, 1_030_301, (0, 0)), (8, 32, 1_030_301, (0, 16)),
    (4, 32, 1_030_301, (0, 0)), (8, 30, 1_030_301, (0, 0)),
    (8, 16, 1_030_301, (0, 0)), (8, 32, 3001, (64, 32)),
    (8, 80, 1000, (16, 80)), (4, 80, 1000, (16, 80)),
    (8, 6144, 300, (1, 4095)), (8, 6144, 1_000_000, (1, 4095)),
    (4, 1, 10, (32, 1))])
def test_gather_tiling(itemsize, k, rows, tile):
    assert ec.ell_gather_tiling(itemsize, k, rows) == tile
    tile_rows, chunk = tile
    if tile_rows > 0:
        assert tile_rows * (chunk | 1) * itemsize <= ec._SPLIT_SMEM
        assert ec._SPLIT_THREADS // tile_rows * itemsize >= 32
    elif chunk:                 # staged: whole groups of 4, 48 KB at most
        assert k % 4 == 0 and chunk % 4 == 0
        assert ec.ell_stage_smem(itemsize, chunk) <= 48 * 1024
    elif tile_rows < 0:         # lanes a row: 128 bytes a load of a row
        assert 4 * -tile_rows * itemsize >= 128


def test_split_chunk():
    assert ec.ell_split_chunk(8, 4, 95) == 95
    assert ec.ell_split_chunk(8, 4, 6144) == 1023
    assert ec.ell_split_chunk(4, 128, 50) == 50
    assert ec.ell_split_chunk(8, 64, 80) == 63
    assert ec.ell_split_chunk(8, 128, 1) == 1
    # fewer blocks than SMs: a long row's slots in one pass
    assert ec.ell_split_chunk(8, 1, 8163, blocks=19) == 8163
    assert ec.ell_split_chunk(8, 1, 30000, blocks=19) == 24575


def test_amg_pcg_count_on_trimmed_plans_equals_jax(monkeypatch):
    """A 20 x 20 P2 rectangle (1681 DOFs): every level operator on its
    trimmed banded plan (the plain product on the CPU) takes the JAX
    package's PCG count to 1e-9."""
    import jax

    import tpufem.sparse.ell as jax_ell_mod
    from amg_systems import p2_system
    from tpufem.solve import amg as jamg
    from tpufem.solve.cg import cg as jax_cg

    monkeypatch.setattr(jax_ell_mod, "_AUTO_BAND_MAX", -1)
    monkeypatch.setenv("TPUFEM_BAND_DISPATCH", "0")
    Aj, bj = p2_system(20)
    hj = jamg.build_amg(Aj, aggregation="greedy", strength=0.08,
                        coarse_n=60)
    ref = jax_cg(Aj.matvec, bj, tol=1e-9, maxiter=100, M=jax.jit(hj.apply))
    Ap = ELLMatrix(torch.as_tensor(np.asarray(Aj.data)),
                   torch.as_tensor(np.asarray(Aj.cols)))
    h = build_amg(Ap, aggregation="greedy", strength=0.08, coarse_n=60)
    Ap.prime_band_plan()
    trimmed = 0
    for lv in h.levels:
        for M in (lv.A, lv.Qp, lv.Qr):
            if M is not None:
                M.prime_band_plan()
                trimmed += M._band[0].width < M.data.shape[1]
    assert trimmed >= 2
    res = cg(Ap.matvec, torch.as_tensor(np.asarray(bj)), tol=1e-9,
             maxiter=100, M=h.apply)
    assert res.converged and bool(ref.converged)
    assert res.iterations == int(ref.iterations)
