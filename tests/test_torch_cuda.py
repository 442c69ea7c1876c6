"""CUDA kernels K1-K4 (the tiled K3 and K4 over every level pair and
tile shape), B3-B5 (the staged B5 over every level, tile shape and type
pair), B5b, B7, B8, the ELL kernels B9-B11, the BCSR kernel
B12, the fused assembly B13, the block sum B14 and SAXPY B15 against their
plain PyTorch versions on the card; the weak-form frontend's scatters
(boundary slots, COO, matrix-free products) bit for bit across runs, and
its entry points on B9; the physics solvers on B9 (the dual products of
Newton-Krylov) and B10 (the modal path's fp64 absolute-column form).

Every test here needs an NVIDIA GPU with nvcc (sm_90a) and skips without
one.  This file imports neither JAX nor the JAX package, so it runs on a
machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from tpufem_torch.assemble.structured import structured_plan
from tpufem_torch.fem.quadrature import tetrahedron_rule
from tpufem_torch.mesh.box import _KUHN_TETS
from tpufem_torch.mesh.core import StructuredInfo
from tpufem_torch.ops import fused_system_cuda, mg_transfer_cuda, stencil_cuda
from tpufem_torch.ops.stencil_cuda import (const_stencil_apply,
                                           const_stencil_apply_plain,
                                           stencil_fused_apply,
                                           stencil_fused_apply_plain)
from tpufem_torch.ops.fused_system_cuda import (
    build_poisson_system, build_poisson_system_plain,
    node_coords_embedded_from_grid)
from tpufem_torch.ops.mg_transfer_cuda import (
    const_prolong_add_smooth_embedded, const_prolong_add_smooth_plain,
    const_residual_restrict_embedded, const_residual_restrict_plain)
from tpufem_torch.ops.stencil_cuda import stencil_apply, stencil_apply_plain
from tpufem_torch.solve.bc import constrained_operator
from tpufem_torch.solve.multigrid import build_poisson_multigrid
from tpufem_torch.sparse.stencil import StencilMatrix
from tpufem_torch.solve.poisson import RhsFunction, model_problem_3d_planes
from tpufem_torch.solve.structured_fast import solve_poisson_fast

pytestmark = pytest.mark.cuda

# Tolerances: where a kernel and its plain version compute the same sums
# in another order or with FMA contraction, fields agree to a few ulps of
# the largest entry; fp64 dots are accumulated in fp64 on both sides.  A
# kernel that adds in its plain version's order with each product and sum
# rounded on its own (every build among them: K1, B7, B8, B13) is held to
# it bit for bit (torch.equal).
_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# (coefficient type, vector type) pairs of the general stencil kernel
_DATA_VEC = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
             (torch.float64, torch.float64)]
_DTYPES = [torch.float32, torch.float64]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card, see the module "
                    "docstring)")
    return torch.device("cuda")


def _close(a, b, dtype):
    b = b.double()
    err = (a.double() - b).abs().max().item()
    assert err <= _TOL[dtype] * max(b.abs().max().item(), 1.0), err


def _noncubic_plan():
    info = StructuredInfo(node_grid=(7, 5, 6), cell_grid=(6, 4, 5),
                          type_node_offsets=np.asarray(_KUHN_TETS))
    plan = structured_plan(info, embed=True)
    lo, h = np.array([-3.0, 0.0, -2.0]), np.array([0.9, 0.75, 0.5])
    ng = info.node_grid
    coords = np.stack([np.broadcast_to(
        (lo[d] + h[d] * np.arange(ng[2 - d])).reshape(
            [-1 if ax == 2 - d else 1 for ax in range(3)]), ng)
        for d in range(3)])
    return plan, coords


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("rhs_mode", ["quadrature", "interp"])
@pytest.mark.parametrize("apply_bc", [True, False])
def test_fused_system_kernel_matches_plain(dev, dtype, rhs_mode, apply_bc):
    """K1 equals its plain version bit for bit (no fused multiply-add,
    the plain version's order) on the non-cubic box."""
    plan, coords = _noncubic_plan()
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    C = torch.as_tensor(node_coords_embedded_from_grid(coords, plan, np_dt),
                        device=dev)
    f, rule = model_problem_3d_planes(), tetrahedron_rule(2)
    A, b = build_poisson_system(plan, C, f, rule, apply_bc=apply_bc,
                                rhs_mode=rhs_mode)
    Ap, bp = build_poisson_system_plain(plan, C, f, rule, apply_bc=apply_bc,
                                        rhs_mode=rhs_mode)
    torch.cuda.synchronize()
    assert torch.equal(A.data, Ap.data)
    assert torch.equal(b, bp)


def _box_coords(n, dtype, dev, jitter):
    """(plan, C on the card) of the uniform box of (-3, 3)^3 with n cells a
    side, its interior nodes jittered by +-jitter h (default_rng(n))."""
    from tpufem_torch.solve.multigrid import _light_grid

    info, coords, bc = _light_grid((-3.0, 3.0), n)
    plan = structured_plan(info, embed=True)
    h = 6.0 / n
    pert = np.random.default_rng(n).uniform(-jitter * h, jitter * h,
                                            coords.shape)
    coords = coords + np.where(~np.broadcast_to(bc, coords.shape), pert, 0.0)
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    return plan, torch.as_tensor(node_coords_embedded_from_grid(
        coords, plan, np_dt), device=dev)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("rhs_mode", ["quadrature", "interp"])
@pytest.mark.parametrize("n", [8, 33, 64])
@pytest.mark.parametrize("jitter", [0.0, 0.15], ids=["uniform", "jittered"])
def test_fused_system_kernel_bit_equal_on_boxes(dev, dtype, rhs_mode, n,
                                                jitter):
    """K1 on uniform and jittered boxes: planes and RHS equal to the plain
    version's bit for bit; the picked tiles leave ragged last tiles in y
    (fp64: 16 rows) and z at these sizes."""
    plan, C = _box_coords(n, dtype, dev, jitter)
    f, rule = model_problem_3d_planes(), tetrahedron_rule(2)
    before = fused_system_cuda.build_poisson_system.launches
    A, b = build_poisson_system(plan, C, f, rule, rhs_mode=rhs_mode)
    assert fused_system_cuda.build_poisson_system.launches == before + 1
    Ap, bp = build_poisson_system_plain(plan, C, f, rule, rhs_mode=rhs_mode)
    torch.cuda.synchronize()
    assert torch.equal(A.data, Ap.data)
    assert torch.equal(b, bp)


def _forced_fused_tiling(tx, nr, tz):
    return lambda itemsize, store_grid: (tx, 256 // tx, nr, tz, 0, None)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("tile", [(tx, nr, tz)
                                  for tx, nr in fused_system_cuda.FUSED_TILES
                                  for tz in (1, 5, 32)])
@pytest.mark.parametrize("n", [6, 33])
def test_fused_system_kernel_bit_equal_over_tiles(dev, monkeypatch, dtype,
                                                  tile, n):
    """Every built tile and marches of 1, 5 and 32 planes give the plain
    version's planes and RHS bit for bit: ragged last tiles in y (16-row
    tiles on 40-row grids) and z, a march longer than the grid."""
    plan, C = _box_coords(n, dtype, dev, 0.15)
    f, rule = model_problem_3d_planes(), tetrahedron_rule(2)
    Ap, bp = build_poisson_system_plain(plan, C, f, rule)
    monkeypatch.setattr(fused_system_cuda, "fused_tiling",
                        _forced_fused_tiling(*tile))
    A, b = build_poisson_system(plan, C, f, rule)
    torch.cuda.synchronize()
    assert torch.equal(A.data, Ap.data)
    assert torch.equal(b, bp)


@pytest.mark.parametrize("tile", [(64, 1, 4), (16, 1, 4), (32, 1, 0)])
def test_fused_system_refused_tile_raises(dev, monkeypatch, tile):
    """A tile the launcher has no kernel for raises before the launch, and
    the C launcher refuses it too."""
    plan, C = _box_coords(8, torch.float32, dev, 0.0)
    f, rule = model_problem_3d_planes(), tetrahedron_rule(2)
    monkeypatch.setattr(fused_system_cuda, "fused_tiling",
                        _forced_fused_tiling(*tile))
    with pytest.raises(ValueError, match="tile"):
        build_poisson_system(plan, C, f, rule)
    monkeypatch.setattr(fused_system_cuda, "check_fused_tile",
                        lambda *a: None)
    with pytest.raises(RuntimeError, match="fused_system"):
        build_poisson_system(plan, C, f, rule)


def test_fused_smem_matches_the_launcher(dev):
    """The planner's shared memory per block is the launcher's for every
    built tile; a tile without a kernel gives -1."""
    plan, _ = _noncubic_plan()
    lib = fused_system_cuda._lib(plan, tetrahedron_rule(2),
                                 model_problem_3d_planes().c_expr)
    for itemsize in (4, 8):
        for tx, nr in fused_system_cuda.FUSED_TILES:
            assert lib.tpufem_fused_smem(itemsize, tx, nr) == \
                fused_system_cuda.fused_smem(itemsize, tx, nr)
        assert lib.tpufem_fused_smem(itemsize, 64, 1) == -1


def test_fused_system_kernel_needs_c_expr(dev):
    plan, coords = _noncubic_plan()
    C = torch.as_tensor(node_coords_embedded_from_grid(coords, plan,
                                                       np.float32),
                        device=dev)
    f = RhsFunction(model_problem_3d_planes().fn)       # no C expression
    with pytest.raises(ValueError):
        build_poisson_system(plan, C, f, tetrahedron_rule(2))


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("with_dot", [False, True])
def test_stencil_kernel_matches_plain(dev, dtype, with_dot):
    plan, coords = _noncubic_plan()
    C = torch.as_tensor(node_coords_embedded_from_grid(coords, plan,
                                                       np.float64),
                        device=dev, dtype=dtype)
    A, _ = build_poisson_system(plan, C, model_problem_3d_planes(),
                                tetrahedron_rule(2))
    g = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn(plan.num_store_rows, generator=g, dtype=dtype).to(dev)
    out = stencil_apply(A.data, x, plan.offsets, with_dot=with_dot)
    ref = stencil_apply_plain(A.data, x, plan.offsets, with_dot=with_dot)
    torch.cuda.synchronize()
    if with_dot:
        (out, d), (ref, d_ref) = out, ref
        assert abs(d.item() - d_ref.item()) <= 1e-4 * max(abs(d_ref.item()),
                                                          1.0)
    _close(out, ref, dtype)


@pytest.mark.parametrize("n", [8, 12])
@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("with_dot", [False, True])
def test_transfer_kernels_match_plain(dev, n, dtype, with_dot):
    lv = build_poisson_multigrid((-3.0, 3.0), n, dtype=dtype, coarse_max=4,
                                 operator="const", device=dev)
    lf, lc = lv[0], lv[1]
    g = torch.Generator(device="cpu").manual_seed(n)

    def rand(level):
        v = torch.randn(level.plan.num_store_rows, generator=g, dtype=dtype)
        return torch.where(level.code.cpu() != 0, v, 0.0).to(dev)

    r, e, ec = rand(lf), rand(lf), rand(lc)
    args = (lf.weights, lf.code, lc.code, r, e, lf.plan, lc.plan)
    _close(const_residual_restrict_embedded(*args),
           const_residual_restrict_plain(*args), dtype)
    args = (lf.weights, lf.code, ec, r, e, lf.plan, lc.plan)
    out = const_prolong_add_smooth_embedded(*args, with_dot=with_dot)
    ref = const_prolong_add_smooth_plain(*args, with_dot=with_dot)
    torch.cuda.synchronize()
    if with_dot:
        (out, d), (ref, d_ref) = out, ref
        assert abs(d.item() - d_ref.item()) <= 1e-4 * max(abs(d_ref.item()),
                                                          1.0)
    _close(out, ref, dtype)


def _transfer_pair(dev, n, dtype, seed, pair=0):
    """Level pair ``pair`` of the const hierarchy of n and random r, e (fine)
    and ec (coarse), zero where the code is 0, on the card."""
    lv = build_poisson_multigrid((-3.0, 3.0), n, dtype=dtype, coarse_max=4,
                                 operator="const", device=dev)
    lf, lc = lv[pair], lv[pair + 1]
    g = torch.Generator(device="cpu").manual_seed(seed)

    def rand(level):
        v = torch.randn(level.plan.num_store_rows, generator=g, dtype=dtype)
        return torch.where(level.code.cpu() != 0, v, 0.0).to(dev)

    return lf, lc, rand(lf), rand(lf), rand(lc)


def _transfers(lf, lc, r, e, ec):
    """K3's rc and K4's y, and K4's (y, dot), on one level pair."""
    rc = const_residual_restrict_embedded(lf.weights, lf.code, lc.code, r, e,
                                          lf.plan, lc.plan)
    a4 = (lf.weights, lf.code, ec, r, e, lf.plan, lc.plan)
    y = const_prolong_add_smooth_embedded(*a4)
    yd = const_prolong_add_smooth_embedded(*a4, with_dot=True)
    torch.cuda.synchronize()
    return rc, y, yd


@pytest.mark.parametrize("n", [8, 12, 16, 24, 64, 96])
@pytest.mark.parametrize("dtype", _DTYPES)
def test_tiled_transfers_match_plain_on_every_level_pair(dev, n, dtype):
    """K3 and K4 (with and without the dot) against their plain versions
    on every level pair of the const hierarchy of n."""
    pairs = len(build_poisson_multigrid((-3.0, 3.0), n, dtype=dtype,
                                        coarse_max=4, operator="const",
                                        device=dev)) - 1
    for pair in range(pairs):
        lf, lc, r, e, ec = _transfer_pair(dev, n, dtype, n + pair, pair)
        rc, y, (yd, d) = _transfers(lf, lc, r, e, ec)
        _close(rc, const_residual_restrict_plain(
            lf.weights, lf.code, lc.code, r, e, lf.plan, lc.plan), dtype)
        a4 = (lf.weights, lf.code, ec, r, e, lf.plan, lc.plan)
        ref, d_ref = const_prolong_add_smooth_plain(*a4, with_dot=True)
        _close(y, ref, dtype)
        assert torch.equal(y, yd)
        assert abs(d.item() - d_ref.item()) <= 1e-4 * max(abs(d_ref.item()),
                                                          1.0)


def _forced_tiling(kernel, ty, tz):
    """transfer_tiling with (ty, tz) for ``kernel`` and the planner's pick
    for the other one."""
    picked = mg_transfer_cuda.transfer_tiling

    def tiling(k, itemsize, fine_sg, coarse_sg, coarse_ng):
        if k != kernel:
            return picked(k, itemsize, fine_sg, coarse_sg, coarse_ng)
        sg, cols = (fine_sg, 128) if k == "K4" else (coarse_sg, 64)
        return (ty, tz, mg_transfer_cuda.transfer_smem(k, itemsize, ty),
                (sg[2] // cols, -(-sg[1] // ty), -(-sg[0] // tz)))

    return tiling


@pytest.mark.parametrize("kernel,ty,tz", [
    ("K4", 6, 5), ("K4", 4, 7), ("K4", 8, 1), ("K4", 4, 200),
    ("K3", 3, 5), ("K3", 4, 3), ("K3", 2, 1), ("K3", 2, 100)])
@pytest.mark.parametrize("dtype", _DTYPES)
def test_tiled_transfers_bit_equal_over_tiles(dev, monkeypatch, dtype,
                                              kernel, ty, tz):
    """At 96 -> 48 (fine store 104 x 104 x 128, coarse 56 x 56 x 128) a
    tile whose rows or planes do not divide the store grid (K4 6 rows, K3
    3), one plane per block or one range for the whole grid gives the
    picked tile's fields bit for bit, and the dot within 1e-4."""
    lf, lc, r, e, ec = _transfer_pair(dev, 96, dtype, 7)
    ref = _transfers(lf, lc, r, e, ec)
    monkeypatch.setattr(mg_transfer_cuda, "transfer_tiling",
                        _forced_tiling(kernel, ty, tz))
    rc, y, (yd, d) = _transfers(lf, lc, r, e, ec)
    assert torch.equal(rc, ref[0])
    assert torch.equal(y, ref[1]) and torch.equal(yd, ref[2][0])
    assert abs(d.item() - ref[2][1].item()) <= 1e-4 * abs(ref[2][1].item())


@pytest.mark.parametrize("off", ["code", "r", "e", "ec", "all"])
@pytest.mark.parametrize("dtype", _DTYPES)
def test_tiled_transfers_on_views_off_16_bytes(dev, dtype, off):
    """K3 and K4 on contiguous views that start off a 16-byte boundary (the
    planes then staged element by element) give the aligned call's fields
    bit for bit, and the dot within 1e-4."""
    lf, lc, r, e, ec = _transfer_pair(dev, 24, dtype, 11)
    ref = _transfers(lf, lc, r, e, ec)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        v = buf[1:]
        v.copy_(t)
        assert v.data_ptr() % 16 != 0
        return v

    code = lf.code
    if off in ("code", "all"):
        lf = dataclasses.replace(lf, code=shifted(lf.code))
    if off in ("r", "all"):
        r = shifted(r)
    if off in ("e", "all"):
        e = shifted(e)
    if off in ("ec", "all"):
        ec = shifted(ec)
    rc, y, (yd, d) = _transfers(lf, lc, r, e, ec)
    assert torch.equal(lf.code, code)
    assert torch.equal(rc, ref[0]) and torch.equal(y, ref[1])
    assert torch.equal(yd, ref[2][0])
    assert abs(d.item() - ref[2][1].item()) <= 1e-4 * abs(ref[2][1].item())


@pytest.mark.parametrize("kernel,ty", [("K3", 5), ("K4", 3)])
def test_tiled_transfer_refused_tile_raises(dev, monkeypatch, kernel, ty):
    """A tile whose rows the launcher has no kernel for is refused at
    launch and raises."""
    lf, lc, r, e, ec = _transfer_pair(dev, 24, torch.float64, 1)
    assert ty not in mg_transfer_cuda.TILE_ROWS[kernel]
    monkeypatch.setattr(mg_transfer_cuda, "transfer_tiling",
                        _forced_tiling(kernel, ty, 2))
    with pytest.raises(RuntimeError, match="residual_restrict"
                       if kernel == "K3" else "prolong_add_smooth"):
        _transfers(lf, lc, r, e, ec)


@pytest.mark.parametrize("n", [12, 96])
@pytest.mark.parametrize("dtype", _DTYPES)
def test_residual_restrict_writes_every_coarse_row(dev, monkeypatch, n,
                                                   dtype):
    """K3 writes 0 on every coarse padding and Dirichlet row, also where
    its output's memory held NaN before the call."""
    lf, lc, r, e, ec = _transfer_pair(dev, n, dtype, 3)
    monkeypatch.setattr(mg_transfer_cuda, "_new_output",
                        lambda size, **kw: torch.full((size,), float("nan"),
                                                      **kw))
    rc = const_residual_restrict_embedded(lf.weights, lf.code, lc.code, r, e,
                                          lf.plan, lc.plan)
    torch.cuda.synchronize()
    assert not rc.isnan().any()
    assert (rc[lc.code != 1] == 0).all()
    _close(rc, const_residual_restrict_plain(
        lf.weights, lf.code, lc.code, r, e, lf.plan, lc.plan), dtype)


@pytest.mark.parametrize("dtype", _DTYPES)
def test_tiled_transfers_repeat_bit_identical(dev, dtype):
    """Two launches of K3 and K4 on the same inputs give the same rc, y and
    dot bit for bit (the dot's per-block partials sum in a fixed order)."""
    lf, lc, r, e, ec = _transfer_pair(dev, 96, dtype, 5)
    first, second = (_transfers(lf, lc, r, e, ec) for _ in range(2))
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])
    assert torch.equal(first[2][0], second[2][0])
    assert torch.equal(first[2][1], second[2][1])


def test_transfer_smem_matches_the_launcher(dev):
    """The planner's shared memory per block is the launcher's, for every
    kernel, item size and tile rows from 1 to 16."""
    lib = mg_transfer_cuda._lib()
    for kernel in ("K3", "K4"):
        for itemsize in (4, 8):
            for ty in range(1, 17):
                assert lib.tpufem_mg_transfer_smem(
                    int(kernel[1]), itemsize, ty) == \
                    mg_transfer_cuda.transfer_smem(kernel, itemsize, ty)


def test_solve_poisson_fast_cuda_matches_cpu(dev):
    counters = [fused_system_cuda.build_poisson_system, stencil_cuda.
                stencil_apply, mg_transfer_cuda.
                const_residual_restrict_embedded, mg_transfer_cuda.
                const_prolong_add_smooth_embedded]
    before = [c.launches for c in counters]
    kw = dict(tol=1e-10, dtype=torch.float64)
    gpu = solve_poisson_fast((-3.0, 3.0), 16, model_problem_3d_planes(),
                             device=dev, **kw)
    cpu = solve_poisson_fast((-3.0, 3.0), 16, model_problem_3d_planes(),
                             device="cpu", **kw)
    assert gpu.cg.converged and gpu.cg.iterations == cpu.cg.iterations
    u = cpu.u
    assert (gpu.u.cpu() - u).abs().max() <= 1e-9 * u.abs().max()
    assert all(c.launches > b for c, b in zip(counters, before))


def _dot_close(d, d_ref):
    assert abs(d.item() - d_ref.item()) <= 1e-4 * max(abs(d_ref.item()), 1.0)


@pytest.mark.parametrize("data_vec", _DATA_VEC, ids=str)
@pytest.mark.parametrize("epilogue,with_dot", [("residual", False),
                                               ("smooth", False),
                                               ("smooth", True)])
def test_general_stencil_kernel_matches_plain(dev, data_vec, epilogue,
                                              with_dot):
    dt, vt = data_vec
    lv = build_poisson_multigrid((-3.0, 3.0), 12, dtype=vt, coarse_max=4,
                                 device=dev)[0]
    data = lv.data.to(dt)
    inv_diag = lv.inv_diag.to(dt) if epilogue == "smooth" else None
    g = torch.Generator(device="cpu").manual_seed(1)
    x, b = (torch.randn(lv.plan.num_store_rows, generator=g,
                        dtype=vt).to(dev) for _ in range(2))
    kw = dict(b=b, inv_diag=inv_diag, omega=0.8, with_dot=with_dot)
    before = stencil_fused_apply.launches
    out = stencil_fused_apply(epilogue, data, x, lv.plan.offsets, **kw)
    ref = stencil_fused_apply_plain(epilogue, data, x, lv.plan.offsets, **kw)
    torch.cuda.synchronize()
    assert stencil_fused_apply.launches == before + 1
    if with_dot:
        (out, d), (ref, d_ref) = out, ref
        _dot_close(d, d_ref)
    _close(out, ref, vt)


@pytest.mark.parametrize("code_vec", [(torch.float32, torch.float32),
                                      (torch.bfloat16, torch.float32),
                                      (torch.float64, torch.float64)],
                         ids=str)
@pytest.mark.parametrize("epilogue,with_dot", [("matvec", False),
                                               ("residual", False),
                                               ("smooth", False),
                                               ("smooth", True)])
def test_const_stencil_kernel_matches_plain(dev, code_vec, epilogue,
                                            with_dot):
    ct, vt = code_vec
    lv = build_poisson_multigrid((-3.0, 3.0), 12, dtype=vt, coarse_max=4,
                                 operator="const", device=dev)[0]
    g = torch.Generator(device="cpu").manual_seed(2)
    x, b = (torch.where(lv.code.cpu() != 0, torch.randn(
        lv.plan.num_store_rows, generator=g, dtype=vt), 0.0).to(dev)
            for _ in range(2))
    kw = dict(b=None if epilogue == "matvec" else b, omega=0.8,
              with_dot=with_dot)
    args = (lv.weights, lv.code.to(ct), x, lv.plan.offsets)
    out = const_stencil_apply(epilogue, *args, **kw)
    ref = const_stencil_apply_plain(epilogue, *args, **kw)
    # the code plane's type does not change the kernel's result
    same = const_stencil_apply(epilogue, lv.weights, lv.code, x,
                               lv.plan.offsets, **kw)
    torch.cuda.synchronize()
    if with_dot:
        (out, d), (ref, d_ref), (same, _) = out, ref, same
        _dot_close(d, d_ref)
    _close(out, ref, vt)
    assert torch.equal(out, same)


def test_stencil_matrix_matvec_launches_k2(dev):
    lv = build_poisson_multigrid((-3.0, 3.0), 8, dtype=torch.float64,
                                 device=dev)[0]
    x = torch.randn(lv.plan.num_store_rows, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3)).to(dev)
    before = stencil_cuda.stencil_apply.launches
    y = StencilMatrix(lv.data, lv.plan.offsets).matvec(x)
    assert stencil_cuda.stencil_apply.launches == before + 1
    _close(y, stencil_cuda.stencil_apply_plain(lv.data, x, lv.plan.offsets),
           torch.float64)


def test_constrained_operator_numpy_mask_on_cuda(dev):
    """A host (numpy) mask with vectors on the card: the wrapper follows
    the vectors' device and agrees with the CPU result."""
    lv = build_poisson_multigrid((-3.0, 3.0), 8, dtype=torch.float64,
                                 device="cpu")[0]
    mask = lv.bc_mask.numpy()
    x = torch.randn(lv.plan.num_store_rows, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(4))
    op = constrained_operator(StencilMatrix(lv.data.to(dev),
                                            lv.plan.offsets).matvec, mask)
    ref = constrained_operator(StencilMatrix(lv.data,
                                             lv.plan.offsets).matvec, mask)
    y = op(x.to(dev))
    assert y.device == x.to(dev).device
    _close(y.cpu(), ref(x), torch.float64)


@pytest.mark.parametrize("kw", [dict(precond="general"),
                                dict(precond="general",
                                     g=lambda x, y, z: x + 2 * y + 3 * z)],
                         ids=["general", "general+g"])
def test_solve_poisson_fast_general_cuda_matches_cpu(dev, kw):
    counters = [stencil_cuda.stencil_apply, stencil_cuda.stencil_fused_apply]
    before = [c.launches for c in counters]
    common = dict(tol=1e-10, dtype=torch.float64, **kw)
    gpu = solve_poisson_fast((-3.0, 3.0), 16, model_problem_3d_planes(),
                             device=dev, **common)
    cpu = solve_poisson_fast((-3.0, 3.0), 16, model_problem_3d_planes(),
                             device="cpu", **common)
    assert gpu.cg.converged and gpu.cg.iterations == cpu.cg.iterations
    u = cpu.u
    assert (gpu.u.cpu() - u).abs().max() <= 1e-9 * u.abs().max()
    assert all(c.launches > b for c, b in zip(counters, before))


# -- the third slice: B7, B5 with 7 offsets, B3 and B5b ---------------------

def _grid_2d(n, jitter=0.0):
    """(plan, node coordinates) of the square (-3, 3)^2 with n cells a
    side, its interior nodes jittered by +-jitter h (default_rng(n))."""
    from tpufem_torch.solve.multigrid import _light_grid

    info, coords, bc = _light_grid((-3.0, 3.0), n, 2)
    if jitter:
        h = 6.0 / n
        pert = np.random.default_rng(n).uniform(-jitter * h, jitter * h,
                                                coords.shape)
        coords = coords + np.where(~np.broadcast_to(bc, coords.shape), pert,
                                   0.0)
    return structured_plan(info, embed=True), coords


def _coords_2d(n, dtype, dev, jitter=0.0):
    plan, coords = _grid_2d(n, jitter)
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    return plan, torch.as_tensor(node_coords_embedded_from_grid(
        coords, plan, np_dt), device=dev)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("rhs_mode", ["quadrature", "interp"])
@pytest.mark.parametrize("apply_bc", [True, False])
@pytest.mark.parametrize("n", [8, 24, 200])
def test_fused_system_2d_kernel_matches_plain(dev, dtype, rhs_mode, apply_bc,
                                              n):
    """B7 equals its plain version bit for bit (built with -fmad=false, its
    terms in the plain version's order) and launches once: store grids of
    (16, 128), (32, 128) (x pads 25 nodes to 128 columns) and (208, 256),
    its two column tiles."""
    from tpufem_torch.fem.quadrature import triangle_rule
    from tpufem_torch.solve.poisson import model_problem_2d_planes

    plan, C = _coords_2d(n, dtype, dev)
    f, rule = model_problem_2d_planes(), triangle_rule(2)
    before = fused_system_cuda.build_poisson_system.launches_2d
    A, b = build_poisson_system(plan, C, f, rule, apply_bc=apply_bc,
                                rhs_mode=rhs_mode)
    Ap, bp = build_poisson_system_plain(plan, C, f, rule, apply_bc=apply_bc,
                                        rhs_mode=rhs_mode)
    torch.cuda.synchronize()
    assert fused_system_cuda.build_poisson_system.launches_2d == before + 1
    assert torch.equal(A.data, Ap.data)
    assert torch.equal(b, bp)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("tile", [(tx, rows)
                                  for tx in fused_system_cuda.FUSED_2D_TILES
                                  for rows in (1, 7, 64, 1000)])
def test_fused_system_2d_bit_equal_over_tiles(dev, monkeypatch, dtype, tile):
    """Every built tile and bands of 1, 7, 64 and 1000 rows give the plain
    version's planes and RHS bit for bit on a jittered n=300 grid (304 x
    384 store rows: ragged last bands, a band longer than the grid), with
    the elimination and without."""
    from tpufem_torch.fem.quadrature import triangle_rule
    from tpufem_torch.solve.poisson import model_problem_2d_planes

    plan, C = _coords_2d(300, dtype, dev, 0.15)
    f, rule = model_problem_2d_planes(), triangle_rule(2)
    monkeypatch.setattr(fused_system_cuda, "fused_2d_tiling",
                        lambda itemsize, store_grid: (*tile, 0, None))
    for apply_bc in (True, False):
        A, b = build_poisson_system(plan, C, f, rule, apply_bc=apply_bc)
        Ap, bp = build_poisson_system_plain(plan, C, f, rule,
                                            apply_bc=apply_bc)
        torch.cuda.synchronize()
        assert torch.equal(A.data, Ap.data)
        assert torch.equal(b, bp)


@pytest.mark.parametrize("tile", [(32, 4), (128, 4), (64, 0)])
def test_fused_system_2d_refused_tile_raises(dev, monkeypatch, tile):
    """A B7 tile the launcher has no kernel for raises before the launch,
    and the C launcher refuses it too."""
    from tpufem_torch.fem.quadrature import triangle_rule
    from tpufem_torch.solve.poisson import model_problem_2d_planes

    plan, C = _coords_2d(24, torch.float32, dev)
    f, rule = model_problem_2d_planes(), triangle_rule(2)
    monkeypatch.setattr(fused_system_cuda, "fused_2d_tiling",
                        lambda itemsize, store_grid: (*tile, 0, None))
    with pytest.raises(ValueError, match="tile"):
        build_poisson_system(plan, C, f, rule)
    monkeypatch.setattr(fused_system_cuda, "check_fused_2d_tile",
                        lambda *a: None)
    with pytest.raises(RuntimeError, match="fused_system_2d"):
        build_poisson_system(plan, C, f, rule)


def test_fused_2d_smem_matches_the_launcher(dev):
    """B7's planner counts the launcher's shared memory per block for every
    built tile; a tile without a kernel gives -1."""
    from tpufem_torch.fem.quadrature import triangle_rule
    from tpufem_torch.solve.poisson import model_problem_2d_planes

    plan, _ = _grid_2d(8)
    lib = fused_system_cuda._lib(plan, triangle_rule(2),
                                 model_problem_2d_planes().c_expr)
    for itemsize in (4, 8):
        for tx in fused_system_cuda.FUSED_2D_TILES:
            assert lib.tpufem_fused_2d_smem(itemsize, tx) == \
                fused_system_cuda.fused_2d_smem(itemsize, tx)
        assert lib.tpufem_fused_2d_smem(itemsize, 32) == -1


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("epilogue,with_dot", [("matvec", False),
                                               ("residual", False),
                                               ("smooth", False),
                                               ("smooth", True)])
def test_const_stencil_k7_matches_plain(dev, dtype, epilogue, with_dot):
    lv = build_poisson_multigrid((-3.0, 3.0), 24, 2, dtype=dtype,
                                 operator="const", device=dev)[0]
    assert len(lv.plan.offsets) == 7
    g = torch.Generator(device="cpu").manual_seed(7)
    x, b = (torch.where(lv.code.cpu() != 0, torch.randn(
        lv.plan.num_store_rows, generator=g, dtype=dtype), 0.0).to(dev)
        for _ in range(2))
    kw = dict(b=None if epilogue == "matvec" else b, with_dot=with_dot)
    args = (epilogue, lv.weights, lv.code, x, lv.plan.offsets)
    out = const_stencil_apply(*args, **kw)
    ref = const_stencil_apply_plain(*args, **kw)
    torch.cuda.synchronize()
    if with_dot:
        (out, d), (ref, d_ref) = out, ref
        assert abs(d.item() - d_ref.item()) <= 1e-4 * max(abs(d_ref.item()),
                                                          1.0)
    _close(out, ref, dtype)


def _blocked_case(dev, dtype, n=16):
    """(general level, const level, x, b) on the 3D n grid, in dtype."""
    gen = build_poisson_multigrid((-3.0, 3.0), n, dtype=dtype, levels=1,
                                  device=dev)[0]
    con = build_poisson_multigrid((-3.0, 3.0), n, dtype=dtype, levels=1,
                                  operator="const", device=dev)[0]
    g = torch.Generator(device="cpu").manual_seed(n)
    x, b = (torch.where(con.code.cpu() != 0, torch.randn(
        con.plan.num_store_rows, generator=g, dtype=dtype), 0.0).to(dev)
        for _ in range(2))
    return gen, con, x, b


@pytest.mark.parametrize("data_dt,vec_dt", _DATA_VEC)
@pytest.mark.parametrize("epilogue,with_dot", [("matvec", False),
                                               ("matvec", True),
                                               ("residual", False),
                                               ("smooth", False),
                                               ("smooth", True)])
def test_blocked_stencil_matches_plain_and_flat(dev, data_dt, vec_dt,
                                                epilogue, with_dot):
    gen, _, x, b = _blocked_case(dev, vec_dt)
    data, sg = gen.data.to(data_dt), gen.plan.store_grid
    kw = dict(with_dot=with_dot)
    if epilogue != "matvec":
        kw["b"] = b
    if epilogue == "smooth":
        kw["inv_diag"] = gen.inv_diag.to(data_dt)
    before = stencil_cuda.stencil_blocked_apply.launches
    out = stencil_cuda.stencil_blocked_apply(epilogue, data, x,
                                             gen.plan.offsets, sg, **kw)
    if epilogue == "matvec":
        ref = stencil_apply_plain(data, x, gen.plan.offsets,
                                  with_dot=with_dot)
        flat = stencil_apply(data, x, gen.plan.offsets, with_dot=with_dot)
    else:
        ref = stencil_fused_apply_plain(epilogue, data, x, gen.plan.offsets,
                                        **kw)
        flat = stencil_fused_apply(epilogue, data, x, gen.plan.offsets, **kw)
    torch.cuda.synchronize()
    assert stencil_cuda.stencil_blocked_apply.launches == before + 1
    if with_dot:
        (out, d), (ref, d_ref), (flat, d_flat) = out, ref, flat
        assert abs(d.item() - d_ref.item()) <= 1e-4 * max(abs(d_ref.item()),
                                                          1.0)
    _close(out, ref, vec_dt)
    # the same terms in the same offset order as the flat kernel
    _close(out, flat, vec_dt)


@pytest.mark.parametrize("code_dt,vec_dt", _DATA_VEC)
@pytest.mark.parametrize("epilogue,with_dot", [("matvec", False),
                                               ("residual", False),
                                               ("smooth", False),
                                               ("smooth", True)])
def test_blocked_const_stencil_matches_plain_and_flat(dev, code_dt, vec_dt,
                                                      epilogue, with_dot):
    _, con, x, b = _blocked_case(dev, vec_dt)
    code = con.code.to(code_dt)
    args = (epilogue, con.weights, code, x, con.plan.offsets)
    kw = dict(b=None if epilogue == "matvec" else b, with_dot=with_dot)
    before = stencil_cuda.const_stencil_blocked_apply.launches
    out = stencil_cuda.const_stencil_blocked_apply(*args,
                                                   con.plan.store_grid, **kw)
    ref = const_stencil_apply_plain(*args, **kw)
    flat = const_stencil_apply(*args, **kw)
    torch.cuda.synchronize()
    assert stencil_cuda.const_stencil_blocked_apply.launches == before + 1
    if with_dot:
        (out, d), (ref, d_ref), (flat, _) = out, ref, flat
        assert abs(d.item() - d_ref.item()) <= 1e-4 * max(abs(d_ref.item()),
                                                          1.0)
    _close(out, ref, vec_dt)
    _close(out, flat, vec_dt)
    # the route launches B5's kernel on the same store grid
    assert torch.equal(out, flat)


def test_routed_wrappers_launch_the_blocked_kernels(dev, monkeypatch):
    """With the routing threshold at 0 every 3D call of the embedded
    wrappers goes to B3 / B5b."""
    monkeypatch.setattr(stencil_cuda, "_VMEM_1D_LIMIT", 0)
    gen, con, x, b = _blocked_case(dev, torch.float32)
    counters = (stencil_cuda.stencil_blocked_apply,
                stencil_cuda.const_stencil_blocked_apply,
                stencil_cuda.stencil_apply, stencil_cuda.const_stencil_apply)
    before = [c.launches for c in counters]
    stencil_cuda.stencil_matvec_dot_embedded(gen.data, x, gen.plan)
    stencil_cuda.stencil_smooth_embedded(gen.data, b, x, gen.inv_diag,
                                         gen.plan)
    stencil_cuda.const_smooth_dot_embedded(con.weights, con.code, b, x,
                                           con.plan)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [2, 1, 0, 0]


# -- the tenth slice: B5 (and B5b's route) as one staged kernel -------------

# (code type, vector type) pairs of the const kernel
_CODE_VEC = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
             (torch.float64, torch.float64)]
_CONST_EPILOGUES = [("matvec", False), ("residual", False),
                    ("smooth", False), ("smooth", True)]


def _const_vectors(lv, vec_dt, seed):
    """Random x, b on a const level (zero where the code is 0)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    return tuple(torch.where(lv.code.cpu() != 0, torch.randn(
        lv.plan.num_store_rows, generator=g, dtype=vec_dt), 0.0).to(
        lv.code.device) for _ in range(2))


def _const_case(dev, dim, n, vec_dt, seed):
    """The finest level of the const hierarchy of n (3D or 2D) and random
    x, b on the card."""
    lv = build_poisson_multigrid((-3.0, 3.0), n, dim, dtype=vec_dt,
                                 operator="const", device=dev)[0]
    return (lv, *_const_vectors(lv, vec_dt, seed))


def _const_calls(lv, code, x, b):
    """B5's four epilogues on one level: [y, y, y, (y, dot)]."""
    out = []
    for ep, wd in _CONST_EPILOGUES:
        out.append(const_stencil_apply(
            ep, lv.weights, code, x, lv.plan.offsets,
            b=None if ep == "matvec" else b, with_dot=wd))
    torch.cuda.synchronize()
    return out


def _same_outputs(got, want, dot_exact=True):
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            assert torch.equal(g[0], w[0])
            if dot_exact:
                assert torch.equal(g[1], w[1])
            else:
                _dot_close(g[1], w[1])
        else:
            assert torch.equal(g, w)


@pytest.mark.parametrize("dim,n", [(3, 8), (3, 12), (3, 16), (3, 24),
                                   (3, 64), (3, 96), (2, 64), (2, 128),
                                   (2, 256), (2, 512), (2, 1024)])
@pytest.mark.parametrize("code_vec", _CODE_VEC, ids=str)
def test_tiled_const_stencil_matches_plain_on_every_level(dev, dim, n,
                                                         code_vec):
    """The staged B5 against its plain version on every level of the const
    hierarchy of n, all four epilogues, each launch counted."""
    ct, vt = code_vec
    levels = build_poisson_multigrid((-3.0, 3.0), n, dim, dtype=vt,
                                     operator="const", device=dev)
    for i, lv in enumerate(levels):
        x, b = _const_vectors(lv, vt, n + i)
        code = lv.code.to(ct)
        before = const_stencil_apply.launches
        got = _const_calls(lv, code, x, b)
        assert const_stencil_apply.launches == before + 4
        for (ep, wd), out in zip(_CONST_EPILOGUES, got):
            ref = const_stencil_apply_plain(
                ep, lv.weights, code, x, lv.plan.offsets,
                b=None if ep == "matvec" else b, with_dot=wd)
            if wd:
                (out, d), (ref, d_ref) = out, ref
                _dot_close(d, d_ref)
            _close(out, ref, vt)


def _forced_const_tiling(ty, tz):
    """const_tiling with the tile (ty, tz)."""
    def tiling(k, itemsize, store_grid, code_itemsize=None):
        return (ty, tz, stencil_cuda.const_smem(k, itemsize, ty,
                                                code_itemsize),
                stencil_cuda._const_grid(k, store_grid, ty, tz))

    return tiling


@pytest.mark.parametrize("dim,n,ty,tz", [
    (3, 96, 6, 5), (3, 96, 4, 7), (3, 96, 8, 1), (3, 96, 8, 200),
    (2, 1024, 6, 5), (2, 1024, 8, 1), (2, 1024, 4, 2000), (2, 1024, 4, 7)])
@pytest.mark.parametrize("code_vec", _CODE_VEC, ids=str)
def test_tiled_const_stencil_bit_equal_over_tiles(dev, monkeypatch, dim, n,
                                                  ty, tz, code_vec):
    """A tile whose rows (6 of 104; 2D bands of 6 of 1032) or planes (5, 7;
    2D bands) do not divide the store grid, one plane or band per block or
    one range for the whole grid gives the picked tile's outputs bit for
    bit, and the dot within 1e-4."""
    ct, vt = code_vec
    lv, x, b = _const_case(dev, dim, n, vt, 17)
    code = lv.code.to(ct)
    ref = _const_calls(lv, code, x, b)
    monkeypatch.setattr(stencil_cuda, "const_tiling",
                        _forced_const_tiling(ty, tz))
    _same_outputs(_const_calls(lv, code, x, b), ref, dot_exact=False)


@pytest.mark.parametrize("dim,n", [(3, 12), (3, 96), (2, 64)])
@pytest.mark.parametrize("dtype", _DTYPES)
def test_tiled_const_stencil_writes_every_row(dev, monkeypatch, dim, n,
                                              dtype):
    """Every row is written (padding 0, Dirichlet x), also where the
    output's memory held NaN before the call."""
    lv, x, b = _const_case(dev, dim, n, dtype, 3)
    monkeypatch.setattr(stencil_cuda, "_new_output",
                        lambda size, **kw: torch.full((size,), float("nan"),
                                                      **kw))
    for (ep, wd), out in zip(_CONST_EPILOGUES,
                             _const_calls(lv, lv.code, x, b)):
        out = out[0] if wd else out
        assert not out.isnan().any()
        assert (out[lv.code == 0] == 0).all()    # x and b are 0 there
        ref = const_stencil_apply_plain(ep, lv.weights, lv.code, x,
                                        lv.plan.offsets,
                                        b=None if ep == "matvec" else b)
        _close(out, ref, dtype)
    matvec = _const_calls(lv, lv.code, x, b)[0]
    assert torch.equal(matvec[lv.code == 2], x[lv.code == 2])


@pytest.mark.parametrize("dim,n", [(3, 96), (2, 1024)])
@pytest.mark.parametrize("code_vec", _CODE_VEC, ids=str)
def test_tiled_const_stencil_repeats_bit_identical(dev, dim, n, code_vec):
    """Two launches on the same inputs give the same outputs bit for bit,
    the dot included (per-block partials summed in a fixed order)."""
    ct, vt = code_vec
    lv, x, b = _const_case(dev, dim, n, vt, 5)
    code = lv.code.to(ct)
    first, second = (_const_calls(lv, code, x, b) for _ in range(2))
    _same_outputs(second, first)


@pytest.mark.parametrize("off", ["code", "x", "b", "all"])
@pytest.mark.parametrize("dim,n", [(3, 24), (2, 64)])
@pytest.mark.parametrize("code_vec", _CODE_VEC, ids=str)
def test_tiled_const_stencil_on_views_off_16_bytes(dev, dim, n, code_vec,
                                                   off):
    """Contiguous views that start off a 16-byte boundary (their planes
    then staged element by element; a bf16 code plane two bytes at a time)
    give the aligned call's outputs bit for bit, and the dot within
    1e-4."""
    ct, vt = code_vec
    lv, x, b = _const_case(dev, dim, n, vt, 11)
    code = lv.code.to(ct)
    ref = _const_calls(lv, code, x, b)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        v = buf[1:]
        v.copy_(t)
        assert v.data_ptr() % 16 != 0
        return v

    if off in ("code", "all"):
        code = shifted(code)
    if off in ("x", "all"):
        x = shifted(x)
    if off in ("b", "all"):
        b = shifted(b)
    _same_outputs(_const_calls(lv, code, x, b), ref, dot_exact=False)


@pytest.mark.parametrize("dim,ty", [(3, 5), (3, 2), (2, 1), (2, 7)])
def test_tiled_const_refused_tile_or_grid_raises(dev, monkeypatch, dim, ty):
    """A tile whose rows the launcher has no kernel for is refused at
    launch and raises; so is a store grid that is not the offsets'."""
    lv, x, b = _const_case(dev, dim, 24, torch.float32, 1)
    assert ty not in stencil_cuda.CONST_TILE_ROWS
    sg = tuple(lv.plan.store_grid)
    with pytest.raises(ValueError, match="store grid"):
        const_stencil_apply("matvec", lv.weights, lv.code, x,
                            lv.plan.offsets,
                            store_grid=(sg[0] * 2, sg[1] // 2) + sg[2:])
    monkeypatch.setattr(stencil_cuda, "const_tiling",
                        _forced_const_tiling(ty, 2))
    with pytest.raises(RuntimeError, match="const_smooth"):
        const_stencil_apply("smooth", lv.weights, lv.code, x,
                            lv.plan.offsets, b=b)


def test_const_smem_matches_the_launcher(dev):
    """The planner's shared memory per block is the launcher's, for both
    stencils, the three type pairs and tile rows from 1 to 16."""
    lib = stencil_cuda._const_lib()
    for k in (15, 7):
        for itemsize, code_itemsize in ((4, 4), (4, 2), (8, 8)):
            for ty in range(1, 17):
                assert lib.tpufem_const_smem(k, itemsize, code_itemsize,
                                             ty) == stencil_cuda.const_smem(
                    k, itemsize, ty, code_itemsize)


def _ell_case(dev, dtype, n=3000, k=8, band=300):
    """A random banded ELL matrix [n, k] (half bandwidth ``band``) and a
    vector, made on the CPU from a seed and moved to the card."""
    g = torch.Generator(device="cpu").manual_seed(n + k)
    cols = (torch.arange(n)[:, None] + torch.randint(
        -band, band + 1, (n, k), generator=g)).clamp_(0, n - 1).to(
        torch.int32)
    data = torch.randn((n, k), generator=g, dtype=dtype)
    x = torch.randn(n, generator=g, dtype=dtype)
    return data.to(dev), cols.to(dev), x.to(dev)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("block_rows", [512, 11008], ids=["int16", "int32"])
@pytest.mark.parametrize("per_block", [False, True], ids=["B9", "B11"])
def test_ell_band_kernel_matches_plain(dev, dtype, block_rows, per_block):
    from tpufem_torch.sparse import ell_cuda

    data, cols, x = _ell_case(dev, dtype)
    plan = ell_cuda.ell_band_plan(data, cols, block_rows=block_rows,
                                  per_block=per_block)
    assert plan.rel.dtype == (np.int16 if block_rows == 512 else np.int32)
    d_t, rel = (torch.as_tensor(a, device=dev) for a in (plan.data_t,
                                                          plan.rel))
    before = ell_cuda.ell_matvec_cuda.launches
    y = ell_cuda.ell_matvec_cuda(plan, d_t, rel, x, per_block=per_block)
    ref = ell_cuda.ell_band_matvec_plain(plan, d_t, rel, x)
    torch.cuda.synchronize()
    assert ell_cuda.ell_matvec_cuda.launches == before + 1
    _close(y, ref, dtype)
    _close(y, ell_cuda.ell_gather_matvec_plain(data, cols, x), dtype)


@pytest.mark.parametrize("dtype", _DTYPES)
def test_ell_gather_kernel_matches_plain(dev, dtype):
    from tpufem_torch.sparse import ell_cuda

    data, cols, x = _ell_case(dev, dtype, band=2999)
    before = ell_cuda.ell_gather_matvec_cuda.launches
    y = ell_cuda.ell_gather_matvec_cuda(data, cols, x)
    torch.cuda.synchronize()
    assert ell_cuda.ell_gather_matvec_cuda.launches == before + 1
    _close(y, ell_cuda.ell_gather_matvec_plain(data, cols, x), dtype)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("q", [1, 3, 8])
def test_ell_multi_kernel_matches_plain(dev, dtype, q):
    """B10 on the banded plan, and the gather form's multi-RHS product."""
    from tpufem_torch.sparse import ell_cuda

    data, cols, _ = _ell_case(dev, dtype)
    X = torch.randn((data.shape[0], q), generator=torch.Generator(
        device="cpu").manual_seed(q), dtype=dtype).to(dev)
    plan = ell_cuda.ell_band_plan(data, cols, block_rows=512)
    d_t, rel = (torch.as_tensor(a, device=dev) for a in (plan.data_t,
                                                          plan.rel))
    before = (ell_cuda.ell_matvec_multi_cuda.launches,
              ell_cuda.ell_gather_matvec_multi_cuda.launches)
    Y = ell_cuda.ell_matvec_multi_cuda(plan, d_t, rel, X)
    Yg = ell_cuda.ell_gather_matvec_multi_cuda(data, cols, X)
    torch.cuda.synchronize()
    assert (ell_cuda.ell_matvec_multi_cuda.launches,
            ell_cuda.ell_gather_matvec_multi_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    ref = ell_cuda.ell_band_matvec_multi_plain(plan, d_t, rel, X)
    _close(Y, ref, dtype)
    _close(Yg, ref, dtype)
    for j in range(q):
        _close(Y[:, j], ell_cuda.ell_matvec_cuda(plan, d_t, rel,
                                                 X[:, j].contiguous()), dtype)


# AMG level shapes of B9 (rows, padded width K, longest row, share of
# empty rows; the P2 hierarchy's levels 4 ... 1 and its restrictions, a
# P2-tet coarse level) and ragged row counts
_LEVEL_SHAPES = [(314, 6144, 95, 0.0), (2273, 1536, 71, 0.0),
                 (19840, 384, 50, 0.0), (1001, 320, 195, 0.0),
                 (146227, 96, 31, 0.0), (146227, 66, 66, 0.864),
                 (30011, 35, 35, 0.854), (997, 24, 17, 0.5)]


def _level_case(dev, dtype, rows, k, longest, empty, seed=0):
    """A banded ELL matrix shaped like an AMG level: K padded slots, rows
    of 1 ... ``longest`` nonzeros (a share ``empty`` of rows none), zeros
    and self columns after them; the plan's planes on the card and x."""
    from tpufem_torch.sparse import ell_cuda

    g = np.random.default_rng(seed + rows)
    band = min(rows - 1, 4 * longest)
    cols = np.clip(np.arange(rows)[:, None] + g.integers(
        -band, band + 1, (rows, k)), 0, rows - 1).astype(np.int32)
    lens = g.integers(1, longest + 1, rows)
    lens[g.random(rows) < empty] = 0
    lens[g.integers(0, rows)] = longest
    data = g.standard_normal((rows, k))
    pad = np.arange(k)[None, :] >= lens[:, None]
    data[pad] = 0
    cols[pad] = np.broadcast_to(np.arange(rows, dtype=np.int32)[:, None],
                                (rows, k))[pad]
    plan = ell_cuda.ell_band_plan(data, cols)
    d_t = torch.as_tensor(plan.data_t, device=dev).to(dtype)
    rel = torch.as_tensor(plan.rel, device=dev)
    x = torch.as_tensor(g.standard_normal(rows), device=dev).to(dtype)
    return plan, d_t, rel, x, (torch.as_tensor(data, device=dev).to(dtype),
                               torch.as_tensor(cols, device=dev))


def _forms(plan):
    """Every B9 form on ``plan``: a thread a row on the slot planes or on
    slices of sorted rows, and lanes a row on the packed rows over tile
    rows 1 ... 128, all rows and the non-empty ones alone."""
    from tpufem_torch.sparse.ell_cuda import EllForm

    compact = (False, True) if plan.row_len[:plan.n].any() else (False,)
    return [plan._replace(form=EllForm("rows", False, 1))] + [
        plan._replace(form=EllForm(name, c, t))
        for name, tiles in (("sliced", (1,)),
                            ("split", (1, 2, 4, 8, 16, 32, 64, 128)))
        for t in tiles for c in compact]


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("shape", _LEVEL_SHAPES, ids=str)
def test_ell_band_forms_bit_equal_on_level_shapes(dev, monkeypatch, dtype,
                                                  shape):
    """B9 in each form on the level shapes equals its plain version bit for
    bit (the trimmed plan's K_used is the longest row), writes every row
    of an output that held NaN, and repeats bit for bit; its own form is
    among them."""
    from tpufem_torch.sparse import ell_cuda

    plan, d_t, rel, x, _ = _level_case(dev, dtype, *shape)
    assert plan.width == shape[2] == plan.row_len.max()
    ref = ell_cuda.ell_band_matvec_plain(plan, d_t, rel, x)
    monkeypatch.setattr(ell_cuda, "_new_output",
                        lambda n, **kw: torch.full((n,), float("nan"), **kw))
    for p in [plan] + _forms(plan):
        before = ell_cuda.ell_matvec_cuda.launches
        y = ell_cuda.ell_matvec_cuda(p, d_t, rel, x)
        again = ell_cuda.ell_matvec_cuda(p, d_t, rel, x)
        torch.cuda.synchronize()
        assert ell_cuda.ell_matvec_cuda.launches == before + 2
        assert torch.equal(y, ref), p.form
        assert torch.equal(again, y), p.form


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("block_rows", [512, 11008], ids=["int16", "int32"])
def test_ell_band_forms_ragged_rows(dev, dtype, block_rows):
    """Row counts that no tile divides, int16 and int32 windows, every
    form, rows of length 0 and of the full width: bit for bit."""
    from tpufem_torch.sparse import ell_cuda

    for rows in (1, 3, 130, 1027, 4099):
        g = np.random.default_rng(rows)
        k, band = 9, min(rows - 1, 400)
        cols = np.clip(np.arange(rows)[:, None] + g.integers(
            -band, band + 1, (rows, k)), 0, rows - 1).astype(np.int32)
        data = g.standard_normal((rows, k))
        data[::3] = 0
        data[1::3, 5:] = 0
        plan = ell_cuda.ell_band_plan(data, cols, block_rows=block_rows)
        d_t = torch.as_tensor(plan.data_t, device=dev).to(dtype)
        rel = torch.as_tensor(plan.rel, device=dev)
        x = torch.as_tensor(g.standard_normal(rows), device=dev).to(dtype)
        ref = ell_cuda.ell_band_matvec_plain(plan, d_t, rel, x)
        for p in _forms(plan):
            assert torch.equal(ell_cuda.ell_matvec_cuda(p, d_t, rel, x),
                               ref), (rows, p.form)


@pytest.mark.parametrize("form", [("split", 3), ("split", 256),
                                  ("nested", 4)])
def test_ell_band_refused_form_raises(dev, form):
    """A form the kernel does not take raises; nothing falls back."""
    from tpufem_torch.sparse import ell_cuda

    plan, d_t, rel, x, _ = _level_case(dev, torch.float64, 314, 64, 40, 0.0)
    bad = plan._replace(form=ell_cuda.EllForm(form[0], False, form[1]))
    with pytest.raises(RuntimeError, match="CUDA error"):
        ell_cuda.ell_matvec_cuda(bad, d_t, rel, x)


def test_ell_band_refused_chunk_raises(dev, monkeypatch):
    from tpufem_torch.sparse import ell_cuda

    plan, d_t, rel, x, _ = _level_case(dev, torch.float64, 314, 64, 40, 0.0)
    monkeypatch.setattr(ell_cuda, "ell_split_chunk", lambda *a: 1 << 14)
    with pytest.raises(RuntimeError, match="CUDA error"):
        ell_cuda.ell_matvec_cuda(plan, d_t, rel, x)


@pytest.mark.parametrize("dtype", _DTYPES)
def test_ell_multi_on_the_trimmed_plan(dev, dtype):
    """B10 on a level's trimmed plan equals its plain version bit for
    bit."""
    from tpufem_torch.sparse import ell_cuda

    plan, d_t, rel, _, _ = _level_case(dev, dtype, 2273, 1536, 71, 0.0)
    X = torch.randn((plan.n, 3), generator=torch.Generator(
        device="cpu").manual_seed(3), dtype=dtype).to(dev)
    assert torch.equal(ell_cuda.ell_matvec_multi_cuda(plan, d_t, rel, X),
                       ell_cuda.ell_band_matvec_multi_plain(plan, d_t, rel,
                                                            X))


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("shape", [(1027, 80, 63, 0.0), (3001, 32, 27, 0.1),
                                   (4099, 8, 8, 0.0), (300, 6144, 95, 0.0),
                                   (2001, 7, 7, 0.2)],
                         ids=str)
def test_ell_gather_tiles_bit_equal(dev, monkeypatch, dtype, shape):
    """B9g (absolute columns, row-major) a thread a row and over tile rows
    1 ... 64 and slot chunks that split a row, with padding zeros: bit for
    bit its plain version, every row written over NaN, repeats bit for
    bit."""
    from tpufem_torch.sparse import ell_cuda

    *_, (data, cols) = _level_case(dev, dtype, *shape)
    x = torch.randn(shape[0], generator=torch.Generator(
        device="cpu").manual_seed(1), dtype=dtype).to(dev)
    ref = ell_cuda.ell_gather_matvec_plain(data, cols, x)
    monkeypatch.setattr(ell_cuda, "_new_output",
                        lambda n, **kw: torch.full((n,), float("nan"), **kw))
    k = shape[1]
    tiles = [ell_cuda.ell_gather_tiling(x.element_size(), k, shape[0]),
             (0, 0)] + [(t, c) for t in (1, 4, 16, 64) for c in (k, 7)
                        if (t * (c | 1) * x.element_size()) <= 48 * 1024]
    if k % 4 == 0:              # staged in chunks (0, chunk)
        tiles += [(0, c) for c in (4, 16, 32, k)
                  if ell_cuda.ell_stage_smem(x.element_size(), c)
                  <= 227 * 1024]
    tiles += [(-4, 0), (-8, 0)]     # 4 or 8 lanes a row
    for tile in tiles:
        monkeypatch.setattr(ell_cuda, "ell_gather_tiling",
                            lambda *a, tile=tile: tile)
        y = ell_cuda.ell_gather_matvec_cuda(data, cols, x)
        again = ell_cuda.ell_gather_matvec_cuda(data, cols, x)
        torch.cuda.synchronize()
        assert torch.equal(y, ref), tile
        assert torch.equal(again, y), tile


@pytest.mark.parametrize("tile", [(256, 8), (4, 1 << 14), (3, 8), (0, 6),
                                  (0, 1 << 14)])
def test_ell_gather_refused_tile_raises(dev, monkeypatch, tile):
    from tpufem_torch.sparse import ell_cuda

    data, cols, x = _ell_case(dev, torch.float64)
    monkeypatch.setattr(ell_cuda, "ell_gather_tiling", lambda *a: tile)
    with pytest.raises(RuntimeError, match="CUDA error"):
        ell_cuda.ell_gather_matvec_cuda(data, cols, x)


def test_ell_gather_staged_refuses_ragged_rows(dev, monkeypatch):
    """B9g's staged form takes rows of whole groups of 4 slots: a row of
    7 raises (nothing falls back)."""
    from tpufem_torch.sparse import ell_cuda

    *_, (data, cols) = _level_case(dev, torch.float64, 2001, 7, 7, 0.2)
    x = torch.ones(2001, dtype=torch.float64, device=dev)
    monkeypatch.setattr(ell_cuda, "ell_gather_tiling", lambda *a: (0, 4))
    with pytest.raises(RuntimeError, match="CUDA error"):
        ell_cuda.ell_gather_matvec_cuda(data, cols, x)


def test_ell_stale_layout_raises(dev):
    """A prepared layout is taken while its plan and arrays are as they
    were; after they change it raises."""
    from tpufem_torch.sparse import ell_cuda

    plan, d_t, rel, x, _ = _level_case(dev, torch.float64, 2273, 1536, 71,
                                       0.0)
    lay = ell_cuda.ell_band_prepare(plan, d_t, rel)
    assert torch.equal(ell_cuda.ell_matvec_cuda(plan, d_t, rel, x,
                                                layout=lay),
                       ell_cuda.ell_band_matvec_plain(plan, d_t, rel, x))
    d_t.mul_(2.0)
    with pytest.raises(ValueError, match="layout"):
        ell_cuda.ell_matvec_cuda(plan, d_t, rel, x, layout=lay)


@pytest.mark.parametrize("form", ["rows", "sliced", "split"])
def test_ell_layout_freed_with_its_matrix(dev, form):
    """B9's layout on the card goes with its ELLMatrix: after each of four
    matrices is built, used and dropped, the card's allocated memory is
    where it was after the first (which may also free what came before
    it)."""
    import gc

    from tpufem_torch.sparse import ell_cuda
    from tpufem_torch.sparse.ell import ELLMatrix

    *_, x, (data, cols) = _level_case(dev, torch.float64, 146227, 96, 31,
                                      0.0)
    after = []
    for _ in range(4):
        A = ELLMatrix(data, cols)
        A.prime_band_plan()
        plan, d_t, rel = A._band
        A._band = (plan._replace(form=ell_cuda.EllForm(form, False, 8)),
                   d_t, rel)
        y = A.matvec(x)
        torch.cuda.synchronize()
        assert A._layout is not None and A._layout.fits(*A._band)
        assert torch.equal(y, ell_cuda.ell_band_matvec_plain(*A._band, x))
        del A, y, plan, d_t, rel
        gc.collect()
        after.append(torch.cuda.memory_allocated(dev))
    assert after[1:] == after[:1] * 3


@pytest.mark.parametrize("kw", [dict(), dict(precond="chebyshev",
                                             matvec="pallas")],
                         ids=["jacobi-banded", "chebyshev-pallas"])
def test_solve_poisson_ell_on_the_card(dev, kw):
    """The 64 x 64 verify-recipe solve on the card (fp64): the CPU's
    iteration count and u within 1e-10."""
    from tpufem_torch.mesh.rectangle import RectangleMesh
    from tpufem_torch.solve.poisson import solve_poisson_ell
    from tpufem_torch.sparse import ell_cuda

    mesh = RectangleMesh(-3, 3, -3, 3, 64, 64)
    before = ell_cuda.ell_matvec_cuda.launches
    sol = solve_poisson_ell(mesh, tol=1e-10, **kw)
    ref = solve_poisson_ell(mesh, tol=1e-10, device="cpu", **kw)
    assert sol.u.device.type == "cuda"
    assert ell_cuda.ell_matvec_cuda.launches > before
    assert sol.cg.converged and sol.cg.iterations == ref.cg.iterations
    u, u_ref = sol.u.cpu().numpy(), ref.u.numpy()
    assert np.abs(u - u_ref).max() <= 1e-10 * np.abs(u_ref).max()


def test_ell_assembly_on_the_card_is_deterministic(dev):
    """The sorted accumulation repeats bit for bit on the card (float
    atomics would not) and agrees with the CPU's within fp32 rounding."""
    from tpufem_torch.assemble.ell import assemble_ell
    from tpufem_torch.assemble.local import p1_stiffness
    from tpufem_torch.fem.elements import P1Triangle
    from tpufem_torch.mesh.adjacency import ell_pattern
    from tpufem_torch.mesh.rectangle import perturbed_rectangle_mesh

    mesh = perturbed_rectangle_mesh(-3, 3, -3, 3, 200, 200, seed=4)
    pat = ell_pattern(mesh.conn, mesh.num_nodes, pad_to=8)
    ec = torch.as_tensor(mesh.element_coords(), dtype=torch.float32)
    Ke = p1_stiffness(ec.to(dev), P1Triangle())
    for method in ("scatter", "sort"):
        runs = [assemble_ell(pat, Ke, method=method).data for _ in range(3)]
        assert all(torch.equal(r, runs[0]) for r in runs[1:])
        ref = assemble_ell(pat, p1_stiffness(ec, P1Triangle()),
                           method=method).data
        _close(runs[0].cpu(), ref, torch.float32)


def _bcsr_case(dev, dtype, b, n=2000, k=8, band=300):
    """A random banded BCSR matrix [n, k, b, b] (half bandwidth ``band``)
    and a component-major vector [b, n], made on the CPU from a seed."""
    g = torch.Generator(device="cpu").manual_seed(n + k + b)
    cols = (torch.arange(n)[:, None] + torch.randint(
        -band, band + 1, (n, k), generator=g)).clamp_(0, n - 1).to(
        torch.int32)
    data = torch.randn((n, k, b, b), generator=g, dtype=dtype)
    x = torch.randn((b, n), generator=g, dtype=dtype)
    return data.to(dev), cols.to(dev), x.to(dev)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("b", [2, 3])
@pytest.mark.parametrize("block_rows", [512, 11008], ids=["int16", "int32"])
@pytest.mark.parametrize("per_block", [False, True])
def test_bcsr_band_kernel_matches_plain(dev, dtype, b, block_rows,
                                        per_block):
    """B12 on the banded plan (and its per_block route) equals its plain
    version bit for bit, and the gather form's plain version."""
    from tpufem_torch.sparse import ell_cuda

    data, cols, x = _bcsr_case(dev, dtype, b)
    plan, data_t = ell_cuda.bcsr_band_plan(data, cols, block_rows=block_rows,
                                           per_block=per_block)
    assert plan.rel.dtype == (np.int16 if block_rows == 512 else np.int32)
    d_t, rel = (torch.as_tensor(a, device=dev) for a in (data_t, plan.rel))
    before = (ell_cuda.bcsr_matvec_cuda.launches,
              ell_cuda.bcsr_matvec_cuda.launches_per_block)
    y = ell_cuda.bcsr_matvec_cuda(plan, d_t, rel, x, per_block=per_block)
    ref = ell_cuda.bcsr_band_matvec_plain(plan, d_t, rel, x)
    torch.cuda.synchronize()
    assert (ell_cuda.bcsr_matvec_cuda.launches,
            ell_cuda.bcsr_matvec_cuda.launches_per_block) == (
        before[0] + 1, before[1] + int(per_block))
    assert torch.equal(y, ref)
    g = ell_cuda.bcsr_gather_matvec_plain(data, cols, x.T.reshape(-1))
    assert torch.equal(y, g.reshape(-1, b).T)
    # a transposed view of a node-major vector gives the same product
    xn = x.T.contiguous()
    assert torch.equal(ell_cuda.bcsr_matvec_cuda(plan, d_t, rel, xn.T), y)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("b", [2, 3])
def test_bcsr_gather_kernel_matches_plain(dev, dtype, b):
    """B12's absolute-column mode on a pattern with columns anywhere."""
    from tpufem_torch.sparse import ell_cuda

    data, cols, x = _bcsr_case(dev, dtype, b, band=1999)
    xf = x.T.reshape(-1).contiguous()
    before = ell_cuda.bcsr_gather_matvec_cuda.launches
    y = ell_cuda.bcsr_gather_matvec_cuda(data, cols, xf)
    torch.cuda.synchronize()
    assert ell_cuda.bcsr_gather_matvec_cuda.launches == before + 1
    assert torch.equal(y, ell_cuda.bcsr_gather_matvec_plain(data, cols, xf))


def _gather_rows(dtype, b, k, case):
    """The row counts of the B12g cases: none, one, a tile less or more one
    (B12g's tiling of this shape), the 2D elasticity path's 491,401."""
    from tpufem_torch.sparse import ell_cuda

    tile = ell_cuda.bcsr_gather_tiling(
        torch.empty((), dtype=dtype).element_size(), b, k)[0]
    return {"none": 0, "one": 1, "tile-1": tile - 1, "tile+1": tile + 1,
            "491401": 491401}[case]


def _gather_case(dev, dtype, b, k, nr, numbering, seed):
    """Random data [nr, k, b, b], int32 cols [nr, k] (anywhere, or within
    300 rows of the diagonal) and node-major x [nr b], on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if numbering == "random":
        cols = torch.randint(0, max(nr, 1), (nr, k), generator=g, device=dev)
    else:
        cols = (torch.arange(nr, device=dev)[:, None] + torch.randint(
            -300, 301, (nr, k), generator=g, device=dev)).clamp_(0, nr - 1)
    data = torch.randn((nr, k, b, b), generator=g, device=dev, dtype=dtype)
    x = torch.randn(nr * b, generator=g, device=dev, dtype=dtype)
    return data, cols.to(torch.int32), x


@pytest.mark.parametrize("numbering", ["random", "banded"])
@pytest.mark.parametrize("rows", ["none", "one", "tile-1", "tile+1",
                                  "491401"])
@pytest.mark.parametrize("k", [8, 16])
@pytest.mark.parametrize("b", [2, 3])
@pytest.mark.parametrize("dtype", _DTYPES)
def test_bcsr_gather_kernel_bit_equal_over_tiles(dev, dtype, b, k, rows,
                                                 numbering):
    """B12g equals its plain version bit for bit at every row count that
    fills, misses or overruns its tiles, on both numberings."""
    from tpufem_torch.sparse import ell_cuda

    nr = _gather_rows(dtype, b, k, rows)
    data, cols, x = _gather_case(dev, dtype, b, k, nr, numbering, nr + k)
    before = ell_cuda.bcsr_gather_matvec_cuda.launches
    y = ell_cuda.bcsr_gather_matvec_cuda(data, cols, x)
    torch.cuda.synchronize()
    assert ell_cuda.bcsr_gather_matvec_cuda.launches == before + 1
    assert y.shape == (nr * b,)
    assert torch.equal(y, ell_cuda.bcsr_gather_matvec_plain(data, cols, x))


@pytest.mark.parametrize("k", [7, 16])
@pytest.mark.parametrize("b", [2, 3])
@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("off", ["data", "cols", "x", "all"])
def test_bcsr_gather_kernel_on_views_off_16_bytes(dev, off, dtype, b, k):
    """B12g on contiguous views that start off a 16-byte boundary (the
    staged spans' scalar head and tail, x gathered element by element)
    equals its plain version bit for bit; 7 slots leave rows whose bytes
    are no 16-byte multiple and a slot loop remainder."""
    from tpufem_torch.sparse import ell_cuda

    nr = 3 * ell_cuda.bcsr_gather_tiling(
        torch.empty((), dtype=dtype).element_size(), b, k)[0] + 5
    data, cols, x = _gather_case(dev, dtype, b, k, nr, "random", 3)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        v = buf[1:].view(t.shape)
        v.copy_(t)
        assert v.data_ptr() % 16 != 0
        return v

    if off in ("data", "all"):
        data = shifted(data)
    if off in ("cols", "all"):
        cols = shifted(cols)
    if off in ("x", "all"):
        x = shifted(x)
    y = ell_cuda.bcsr_gather_matvec_cuda(data, cols, x)
    torch.cuda.synchronize()
    assert torch.equal(y, ell_cuda.bcsr_gather_matvec_plain(data, cols, x))


def _band_case(dev, dtype, b, n, k, block_rows, seed):
    """A random banded BCSR matrix of n block rows and k slots (half
    bandwidth 100 or less), its banded plan on the card and a
    component-major x [b, n]."""
    from tpufem_torch.sparse import ell_cuda

    g = torch.Generator(device="cpu").manual_seed(seed)
    band = min(100, max(n - 1, 0))
    cols = (torch.arange(n)[:, None] + torch.randint(
        -band, band + 1, (n, k), generator=g)).clamp_(0, n - 1).to(
        torch.int32)
    data = torch.randn((n, k, b, b), generator=g, dtype=dtype)
    x = torch.randn((b, n), generator=g, dtype=dtype).to(dev)
    plan, data_t = ell_cuda.bcsr_band_plan(data, cols, block_rows=block_rows,
                                           per_block=True)
    d_t, rel = (torch.as_tensor(a, device=dev) for a in (data_t, plan.rel))
    return plan, d_t, rel, x


@pytest.mark.parametrize("n", [1, 31, 1000, 4097])
@pytest.mark.parametrize("k", [8, 16, 5])
@pytest.mark.parametrize("b", [2, 3])
@pytest.mark.parametrize("dtype", _DTYPES)
def test_bcsr_band_kernel_bit_equal_over_designs(dev, monkeypatch, dtype, b,
                                                 k, n):
    """B12 equals its plain version bit for bit in every tile its chooser
    can pick and in odd tiles (1, 33 and 262 rows), at n below one tile and
    off a tile multiple, at the unrolled K = 8 and 16 and at K = 5 (the
    run-time instance), with one launch counted per call."""
    from tpufem_torch.sparse import ell_cuda

    plan, d_t, rel, x = _band_case(dev, dtype, b, n, k, 256, n + k + b)
    ref = ell_cuda.bcsr_band_matvec_plain(plan, d_t, rel, x)
    for tile in sorted(set(ell_cuda.BCSR_TILE_ROWS) | {1, 33, 262}):
        monkeypatch.setattr(ell_cuda, "bcsr_band_tiling",
                            lambda *a, t=tile: t)
        before = ell_cuda.bcsr_matvec_cuda.launches
        y = ell_cuda.bcsr_matvec_cuda(plan, d_t, rel, x)
        torch.cuda.synchronize()
        assert ell_cuda.bcsr_matvec_cuda.launches == before + 1
        assert y.shape == (b, n)
        assert torch.equal(y, ref), tile


@pytest.mark.parametrize("block_rows", [256, 11008], ids=["int16", "int32"])
@pytest.mark.parametrize("b", [2, 3])
@pytest.mark.parametrize("dtype", _DTYPES)
def test_bcsr_band_kernel_layouts(dev, dtype, b, block_rows):
    """B12 on both x layouts of the paths (component-major [b, n], the
    transposed view of a node-major vector), x padded to NP, the per_block
    route, and y written through a transposed view (node-major storage):
    the same bits in every case."""
    from tpufem_torch.sparse import ell_cuda

    n = 2500
    plan, d_t, rel, x = _band_case(dev, dtype, b, n, 16 if b == 3 else 8,
                                   block_rows, 7 * b)
    assert plan.rel.dtype == (np.int16 if block_rows == 256 else np.int32)
    ref = ell_cuda.bcsr_band_matvec_plain(plan, d_t, rel, x)
    xn = x.T.contiguous()
    xp = torch.cat([x, x.new_zeros((b, plan.np_rows - n))], 1)
    before = ell_cuda.bcsr_matvec_cuda.launches_per_block
    for got in (ell_cuda.bcsr_matvec_cuda(plan, d_t, rel, x),
                ell_cuda.bcsr_matvec_cuda(plan, d_t, rel, xn.T),
                ell_cuda.bcsr_matvec_cuda(plan, d_t, rel, xp),
                ell_cuda.bcsr_matvec_cuda(plan, d_t, rel, x,
                                          per_block=True)):
        torch.cuda.synchronize()
        assert torch.equal(got, ref)
    assert ell_cuda.bcsr_matvec_cuda.launches_per_block == before + 1
    yn = torch.full((n, b), float("nan"), dtype=dtype, device=dev)
    ell_cuda._bcsr_launch("bcsr_matvec", d_t, rel, xn.T, yn.T, n, plan.width,
                          (1, b * b * plan.np_rows, plan.np_rows),
                          (1, plan.np_rows), plan.block_rows)
    torch.cuda.synchronize()
    assert torch.equal(yn.T, ref)


@pytest.mark.parametrize("tile", [0, 385])
def test_bcsr_band_refused_tile_raises(dev, monkeypatch, tile):
    """A tile of no rows or past the kernel's 384 threads a block is
    refused at launch, not run."""
    from tpufem_torch.sparse import ell_cuda

    plan, d_t, rel, x = _band_case(dev, torch.float64, 3, 500, 16, 256, 1)
    monkeypatch.setattr(ell_cuda, "bcsr_band_tiling", lambda *a: tile)
    with pytest.raises(RuntimeError, match="CUDA error"):
        ell_cuda.bcsr_matvec_cuda(plan, d_t, rel, x)


def _shifted_rows(t):
    """A copy of t whose storage starts one element past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    v = buf[1:].view(t.shape)
    v.copy_(t)
    assert v.data_ptr() % 16 != 0
    return v


@pytest.mark.parametrize("q", [2, 3, 4, 5, 8, 9])
@pytest.mark.parametrize("dtype", _DTYPES)
def test_ell_multi_kernel_bit_equal(dev, monkeypatch, dtype, q):
    """B10 equals its plain version bit for bit at every q its instances
    cover (2-8 unrolled, 9 at run time), on the banded plan and in the
    absolute-column form, at 3001 rows (off every block size), in each
    design the chooser picks from (block size; X staged in shared memory
    or not: the absolute form's columns span too far to stage), and with X
    off a 16-byte boundary (the scalar accesses); one launch counted per
    call."""
    from tpufem_torch.sparse import ell_cuda

    data, cols, _ = _ell_case(dev, dtype, n=3001)
    X = torch.randn((3001, q), generator=torch.Generator(
        device="cpu").manual_seed(q), dtype=dtype).to(dev)
    plan = ell_cuda.ell_band_plan(data, cols, block_rows=512)
    d_t, rel = (torch.as_tensor(a, device=dev) for a in (plan.data_t,
                                                          plan.rel))
    ref = ell_cuda.ell_band_matvec_multi_plain(plan, d_t, rel, X)
    assert torch.equal(ref, ell_cuda.ell_gather_matvec_multi_plain(
        data, cols, X))
    for design in ell_cuda.ell_multi_designs(X.element_size(), q):
        monkeypatch.setattr(ell_cuda, "ell_multi_tiling",
                            lambda *a, d=design: d)
        for Xv in (X, _shifted_rows(X)):
            before = (ell_cuda.ell_matvec_multi_cuda.launches,
                      ell_cuda.ell_gather_matvec_multi_cuda.launches)
            Y = ell_cuda.ell_matvec_multi_cuda(plan, d_t, rel, Xv)
            Yg = ell_cuda.ell_gather_matvec_multi_cuda(data, cols, Xv)
            torch.cuda.synchronize()
            assert (ell_cuda.ell_matvec_multi_cuda.launches,
                    ell_cuda.ell_gather_matvec_multi_cuda.launches) == (
                before[0] + 1, before[1] + 1)
            assert torch.equal(Y, ref), design
            assert torch.equal(Yg, ref), design


@pytest.mark.parametrize("kw", [dict(matvec="pallas"), dict()],
                         ids=["pallas", "gather"])
@pytest.mark.parametrize("dim", [2, 3])
def test_solve_elasticity_on_the_card(dev, kw, dim):
    """The fp64 body-force solve on the card: the CPU's iteration count and
    u within 1e-10; B12 launched on every iteration."""
    from tpufem_torch.mesh.box import box_mesh
    from tpufem_torch.mesh.rectangle import perturbed_rectangle_mesh
    from tpufem_torch.solve.elasticity import solve_elasticity
    from tpufem_torch.sparse import ell_cuda

    if dim == 2:
        mesh = perturbed_rectangle_mesh(-1, 1, -1, 1, 24, 24, seed=0)
        f = lambda x: torch.stack([0 * x[..., 0] + 1.0,
                                   0 * x[..., 1] - 0.5], -1)
    else:
        mesh = box_mesh(-1, 1, -1, 1, -1, 1, 5, 5, 5)
        f = lambda x: torch.stack([0 * x[..., 0] + 1.0, 0 * x[..., 1] - 0.5,
                                   0 * x[..., 2] + 0.25], -1)
    counters = (ell_cuda.bcsr_matvec_cuda, ell_cuda.bcsr_gather_matvec_cuda)
    before = sum(c.launches for c in counters)
    sol = solve_elasticity(mesh, body_force=f, tol=1e-10, **kw)
    ref = solve_elasticity(mesh, body_force=f, tol=1e-10, device="cpu", **kw)
    assert sol.u.device.type == "cuda"
    assert sum(c.launches for c in counters) - before >= sol.cg.iterations
    assert sol.cg.converged and sol.cg.iterations == ref.cg.iterations
    u, u_ref = sol.u.cpu().numpy(), ref.u.numpy()
    assert np.abs(u - u_ref).max() <= 1e-10 * np.abs(u_ref).max()


def test_elasticity_build_on_the_card_is_deterministic(dev, monkeypatch):
    """Chunked element matrices equal the unchunked ones bit for bit, and
    the sorted BCSR scatter repeats bit for bit on the card."""
    from tpufem_torch.fem.space import VectorFunctionSpace
    from tpufem_torch.forms import weakform
    from tpufem_torch.mesh.adjacency import ell_pattern
    from tpufem_torch.mesh.rectangle import perturbed_rectangle_mesh
    from tpufem_torch.solve.elasticity import elasticity_forms
    from tpufem_torch.sparse.bcsr import assemble_bcsr

    mesh = perturbed_rectangle_mesh(-1, 1, -1, 1, 100, 100, seed=2)
    V = VectorFunctionSpace(mesh)
    wf = elasticity_forms(V, 1.0, 1.0)
    wf.dtype = torch.float32
    ec = torch.as_tensor(mesh.element_coords(), dtype=torch.float32,
                         device=dev)
    Ke = wf.element_matrices(ec)
    # 6 x 6 local DOFs, 7 points, 2 x 2 values, 4 bytes: 4032 per element
    monkeypatch.setattr(weakform, "_CHUNK_BYTES", 777 * 4032)
    assert weakform.chunk_elements(V, wf.quadrature, wf.dtype) == 777
    assert torch.equal(Ke, wf.element_matrices(ec))
    monkeypatch.undo()
    pat = ell_pattern(V.scalar_dof_conn, V.num_scalar_dofs, pad_to=8)
    runs = [assemble_bcsr(pat, Ke, 2).data for _ in range(3)]
    assert all(torch.equal(r, runs[0]) for r in runs[1:])
    ref = assemble_bcsr(pat, wf.element_matrices(ec.cpu()), 2).data
    _close(runs[0].cpu(), ref, torch.float32)


def _assemble_box(dims, dtype, dev):
    """(mesh, plan, X_emb on the card) of the box (-1, 2) x (0, 1) x (-2, 0)
    with dims = (nx, ny, nz) cells."""
    from tpufem_torch.mesh.box import box_mesh
    from tpufem_torch.ops.assemble_cuda import element_coords_bt_embedded

    mesh = box_mesh(-1, 2, 0, 1, -2, 0, *dims)
    plan = structured_plan(mesh, embed=True)
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    return mesh, plan, torch.as_tensor(
        element_coords_bt_embedded(mesh, plan, dtype=np_dt), device=dev)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("dims", [(5, 4, 6), (8, 8, 8), (37, 11, 9)],
                         ids=["box5x4x6", "cube8", "box37x11x9"])
def test_assemble_kernel_matches_plain_and_k1(dev, dtype, dims):
    """B13 equals its plain version bit for bit and launches once, and its
    planes are K1's raw stiffness (apply_bc=False) within the field
    tolerance; 37 x 11 x 9 cells leave ragged tiles in y and z."""
    from tpufem_torch.ops.assemble_cuda import (assemble_stencil_cuda,
                                                assemble_stencil_plain)

    mesh, plan, X = _assemble_box(dims, dtype, dev)
    before = assemble_stencil_cuda.launches
    A = assemble_stencil_cuda(plan, X)
    assert assemble_stencil_cuda.launches == before + 1
    ref = assemble_stencil_plain(plan, X)
    torch.cuda.synchronize()
    assert A.data.device.type == "cuda" and A.offsets == ref.offsets
    assert torch.equal(A.data, ref.data)
    ng = plan.info.node_grid
    coords = np.moveaxis(mesh.coords.reshape(*ng, 3), -1, 0)
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    C = torch.as_tensor(node_coords_embedded_from_grid(coords, plan, np_dt),
                        device=dev)
    K1, _ = build_poisson_system(plan, C, model_problem_3d_planes(),
                                 tetrahedron_rule(2), apply_bc=False)
    _close(A.data, K1.data, dtype)


def _assemble_tiles():
    from tpufem_torch.ops.assemble_cuda import ASSEMBLE_TILES

    return [(tx, ty, tz) for tx, ty in ASSEMBLE_TILES for tz in (1, 3, 32)]


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("tile", _assemble_tiles())
def test_assemble_kernel_bit_equal_over_tiles(dev, monkeypatch, dtype, tile):
    """Every built B13 tile (columns, rows) and marches of 1, 3 and 32
    planes give the plain version's planes bit for bit on the
    37 x 11 x 9 box (16 store planes and rows: ragged last tiles, a march
    longer than the grid)."""
    from tpufem_torch.ops import assemble_cuda

    _, plan, X = _assemble_box((37, 11, 9), dtype, dev)
    ref = assemble_cuda.assemble_stencil_plain(plan, X)
    monkeypatch.setattr(assemble_cuda, "assemble_tiling",
                        lambda itemsize, store_grid: (*tile, 0, None))
    A = assemble_cuda.assemble_stencil_cuda(plan, X)
    torch.cuda.synchronize()
    assert torch.equal(A.data, ref.data)


@pytest.mark.parametrize("tile", [(16, 16, 4), (64, 4, 0)])
def test_assemble_refused_tile_raises(dev, monkeypatch, tile):
    """A B13 tile the launcher has no kernel for raises before the launch,
    and the C launcher refuses it too; the planner's shared memory per
    block is the launcher's for every built tile."""
    from tpufem_torch.ops import assemble_cuda

    _, plan, X = _assemble_box((5, 4, 6), torch.float32, dev)
    monkeypatch.setattr(assemble_cuda, "assemble_tiling",
                        lambda itemsize, store_grid: (*tile, 0, None))
    with pytest.raises(ValueError, match="tile"):
        assemble_cuda.assemble_stencil_cuda(plan, X)
    monkeypatch.setattr(assemble_cuda, "check_assemble_tile",
                        lambda *a: None)
    with pytest.raises(RuntimeError, match="assemble_stencil"):
        assemble_cuda.assemble_stencil_cuda(plan, X)
    lib = assemble_cuda._lib(plan)
    for itemsize in (4, 8):
        for tx, ty in assemble_cuda.ASSEMBLE_TILES:
            assert lib.tpufem_assemble_smem(itemsize, tx, ty) == \
                assemble_cuda.assemble_smem(itemsize, tx, ty)
        assert lib.tpufem_assemble_smem(itemsize, 16, 16) == -1


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("n, block", [(1 << 20, 1 << 17), (1000003, 65536),
                                      (100, 4096)],
                         ids=["blocks", "padded", "tiny"])
def test_reduction_kernel_matches_plain(dev, dtype, n, block):
    from tpufem_torch.ops.reduction import (block_reduce,
                                            block_reduce_plain,
                                            reduction_check)

    g = torch.Generator(device="cpu").manual_seed(n)
    x = torch.rand(n, generator=g, dtype=dtype).to(dev)
    before = block_reduce.launches
    out = block_reduce(x, block)
    assert block_reduce.launches == before + 1
    ref = block_reduce_plain(x, block)
    torch.cuda.synchronize()
    assert out.dim() == 0 and out.dtype == dtype
    assert torch.equal(out, ref)
    assert reduction_check(x, out)["match"]


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("n", [32 * 128 * 128, 1001, 0, 1, 3, 5, 1000003])
def test_saxpy_kernel_matches_plain(dev, dtype, n):
    from tpufem_torch.ops.saxpy_cuda import saxpy, saxpy_plain

    a = torch.tensor([5.1], dtype=dtype, device=dev)
    x = torch.arange(n, dtype=dtype, device=dev)
    y = x * 2.0
    before = saxpy.launches
    out = saxpy(a, x, y)
    assert saxpy.launches == before + 1
    assert torch.equal(out, saxpy_plain(a, x, y))
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    expected = 5.1 * np.arange(n, dtype=np_dt) + 2.0 * np.arange(n,
                                                                dtype=np_dt)
    assert float(np.abs(out.cpu().numpy() - expected).max(initial=0.0)) < 1e-4


@pytest.mark.parametrize("n", [1001, 32 * 128 * 128])
@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("xs, ys", [(1, 1), (3, 3), (1, 0), (0, 3), (1, 3)],
                         ids=["x1y1", "x3y3", "x1", "y3", "x1y3"])
def test_saxpy_kernel_on_views(dev, xs, ys, dtype, n):
    """B15 on the views x[xs:], y[ys:] (a scalar head before x's first
    16-byte boundary; y as vectors where it shares x's phase, element by
    element where not) equals its plain version bit for bit."""
    from tpufem_torch.ops.saxpy_cuda import saxpy, saxpy_plain

    a = torch.tensor([5.1], dtype=dtype, device=dev)
    x = (torch.arange(n + xs, dtype=dtype, device=dev) * 0.7)[xs:]
    y = (torch.arange(n + ys, dtype=dtype, device=dev) * 2.0)[ys:]
    out = saxpy(a, x, y)
    torch.cuda.synchronize()
    assert out.data_ptr() % 16 == x.data_ptr() % 16
    assert torch.equal(out, saxpy_plain(a, x, y))


def test_assemble_slice_on_the_card(dev):
    """The slice at n = 8 on the card (B13, K2 and the MG-PCG on the built
    operator) takes the CPU run's iteration count, solutions within
    1e-10."""
    from tpufem_torch.assemble.planar import element_coords_bt, element_load_bt
    from tpufem_torch.assemble.structured import assemble_vector_structured_bt
    from tpufem_torch.mesh.box import box_mesh
    from tpufem_torch.ops.assemble_cuda import (assemble_stencil_cuda,
                                                element_coords_bt_embedded)
    from tpufem_torch.solve.bc import apply_dirichlet_stencil
    from tpufem_torch.solve.cg import cg
    from tpufem_torch.solve.multigrid import mg_preconditioner

    mesh = box_mesh(-3, 3, -3, 3, -3, 3, 8, 8, 8)
    plan = structured_plan(mesh, embed=True)
    runs = []
    for device in (dev, torch.device("cpu")):
        A = assemble_stencil_cuda(plan, torch.as_tensor(
            element_coords_bt_embedded(mesh, plan, dtype=np.float64),
            device=device))
        X = torch.as_tensor(element_coords_bt(mesh, np.float64),
                            device=device)
        b = assemble_vector_structured_bt(plan, element_load_bt(
            X, "tetrahedron", tetrahedron_rule(3), model_problem_3d_planes()))
        bc = plan.embed_field(torch.as_tensor(mesh.node_flags != 0,
                                              device=device), fill=0)
        A, b = apply_dirichlet_stencil(A, b, bc)
        levels = build_poisson_multigrid((-3.0, 3.0), 8, dtype=torch.float64,
                                         coarse_max=2, top=(A.data, bc),
                                         device=device)
        runs.append(cg(A.matvec, b, tol=1e-10, maxiter=100,
                       M=mg_preconditioner(levels, nu1=1, nu2=1)))
    card, cpu = runs
    assert card.converged and card.iterations == cpu.iterations
    x, x_ref = card.x.cpu().numpy(), cpu.x.numpy()
    assert np.abs(x - x_ref).max() <= 1e-10 * np.abs(x_ref).max()


def _perturbed_noncubic(dtype, dev):
    """The non-cubic plan (store z 16) with its interior nodes jittered by
    up to 0.15 of the smallest spacing (default_rng(0))."""
    plan, coords = _noncubic_plan()
    interior = np.zeros(plan.info.node_grid, bool)
    interior[1:-1, 1:-1, 1:-1] = True
    pert = np.random.default_rng(0).uniform(-0.075, 0.075, coords.shape)
    coords = coords + np.where(interior, pert, 0.0)
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    return plan, torch.as_tensor(node_coords_embedded_from_grid(
        coords, plan, np_dt), device=dev)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("rhs_mode", ["quadrature", "interp"])
@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_stripe_kernel_equals_k1_and_matches_plain(dev, dtype, rhs_mode,
                                                   shards):
    """B8: the sharded build's stripes, joined, equal K1's planes and RHS
    bit for bit (the same kernel body and order), and each stripe equals
    its plain version bit for bit."""
    from tpufem_torch.dist.assembly import build_poisson_system_sharded
    from tpufem_torch.dist.mesh import make_mesh, unshard

    plan, C = _perturbed_noncubic(dtype, dev)
    f, rule = model_problem_3d_planes(), tetrahedron_rule(2)
    A, b = build_poisson_system(plan, C, f, rule, rhs_mode=rhs_mode)
    before = fused_system_cuda.build_poisson_stripe.launches
    data, rhs = build_poisson_system_sharded(
        plan, C, make_mesh(shards, ("z",), device=dev), f, rule,
        rhs_mode=rhs_mode)
    assert fused_system_cuda.build_poisson_stripe.launches == before + shards
    assert torch.equal(unshard(data), A.data)
    assert torch.equal(unshard(rhs), b)
    depth = plan.store_grid[0] // shards
    zero = torch.zeros_like(C[:, :1])
    for i in range(shards):
        z = i * depth
        Cx = torch.cat([C[:, z - 1:z] if i else zero, C[:, z:z + depth],
                        C[:, z + depth:z + depth + 1] if i < shards - 1
                        else zero], 1).contiguous()
        d, r = fused_system_cuda.build_poisson_stripe_plain(
            plan, Cx, z, f, rule, rhs_mode=rhs_mode)
        # with several cards, shard i lies on card i % count
        assert torch.equal(data.shards[i].to(d.device), d)
        assert torch.equal(rhs.shards[i].to(r.device), r)


def test_dist_pipeline_on_the_card_matches_cpu(dev):
    """solve_poisson_dist_general and the distributed MG on a 4-shard mesh
    on the card take the host mesh's iteration counts (fp64)."""
    from tpufem_torch.dist.assembly import solve_poisson_dist_general
    from tpufem_torch.dist.mesh import make_mesh
    from tpufem_torch.dist.multigrid import solve_poisson_dist

    mesh = make_mesh(4, ("z",))
    assert all(d.type == "cuda" for d in mesh.device_list)
    runs = []
    for m, device in ((mesh, dev), (make_mesh(4, ("z",), device="cpu"),
                                     torch.device("cpu"))):
        plan, C = _perturbed_noncubic(torch.float64, device)
        u, res = solve_poisson_dist_general(
            plan, C, m, model_problem_3d_planes(), tetrahedron_rule(2),
            tol=1e-10, maxiter=500)
        b = np.random.default_rng(1).standard_normal(17 ** 3)
        u_mg, res_mg = solve_poisson_dist((-3.0, 3.0), 16, 3, m, b,
                                          dtype=np.float64, tol=1e-10,
                                          maxiter=60)
        runs.append((u, res, u_mg, res_mg))
    (u, res, u_mg, res_mg), (u_c, res_c, u_mg_c, res_mg_c) = runs
    assert res.converged and res.iterations == res_c.iterations
    assert np.abs(u - u_c).max() <= 1e-10 * np.abs(u_c).max()
    assert res_mg.converged and res_mg.iterations == res_mg_c.iterations
    assert np.abs(u_mg - u_mg_c).max() <= 1e-10 * np.abs(u_mg_c).max()


# -- B12 / B12g at the block AMG's block sizes, and the AMG on the card ----

@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("b", [4, 5, 6])
@pytest.mark.parametrize("k", [8, 64])
@pytest.mark.parametrize("block_rows", [512, 11008], ids=["int16", "int32"])
def test_bcsr_band_kernel_wide_blocks(dev, dtype, b, k, block_rows):
    """B12 at b = 4 to 6 (the block AMG's transfers and 6 x 6 coarse
    levels; the run-time-K instance), K = 8 and a fat K = 64: bit for bit
    its plain version and the gather form's."""
    from tpufem_torch.sparse import ell_cuda

    data, cols, x = _bcsr_case(dev, dtype, b, n=1500, k=k)
    plan, data_t = ell_cuda.bcsr_band_plan(data, cols, block_rows=block_rows)
    d_t, rel = (torch.as_tensor(a, device=dev) for a in (data_t, plan.rel))
    before = ell_cuda.bcsr_matvec_cuda.launches
    y = ell_cuda.bcsr_matvec_cuda(plan, d_t, rel, x)
    ref = ell_cuda.bcsr_band_matvec_plain(plan, d_t, rel, x)
    torch.cuda.synchronize()
    assert ell_cuda.bcsr_matvec_cuda.launches == before + 1
    assert torch.equal(y, ref)
    g = ell_cuda.bcsr_gather_matvec_plain(data, cols, x.T.reshape(-1))
    assert torch.equal(y, g.reshape(-1, b).T)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("b", [4, 5, 6])
@pytest.mark.parametrize("k", [8, 64, 128])
def test_bcsr_gather_kernel_wide_blocks(dev, dtype, b, k):
    """B12g at b = 4 to 6, K = 8 and fat K (64, 128: fp64 6 x 6 blocks
    take the 1- and 2-row tiles), randomly numbered and on a band, bit for
    bit its plain version."""
    from tpufem_torch.sparse import ell_cuda

    rows, _ = ell_cuda.bcsr_gather_tiling(
        torch.empty((), dtype=dtype).element_size(), b, k)
    for numbering in ("random", "banded"):
        for nr in (1, rows + 1, 3001):
            data, cols, x = _gather_case(dev, dtype, b, k, nr, numbering,
                                         nr + k + b)
            before = ell_cuda.bcsr_gather_matvec_cuda.launches
            y = ell_cuda.bcsr_gather_matvec_cuda(data, cols, x)
            torch.cuda.synchronize()
            assert ell_cuda.bcsr_gather_matvec_cuda.launches == before + 1
            assert torch.equal(
                y, ell_cuda.bcsr_gather_matvec_plain(data, cols, x))


def _elasticity_system(dev, dim):
    """The Dirichlet-eliminated fp64 elasticity operator (lam = mu = 1) of
    a perturbed 20 x 20 square or a 7^3 box, and its node coordinates."""
    from tpufem_torch.fem.space import VectorFunctionSpace
    from tpufem_torch.mesh.adjacency import ell_pattern
    from tpufem_torch.mesh.box import box_mesh
    from tpufem_torch.mesh.rectangle import perturbed_rectangle_mesh
    from tpufem_torch.solve.elasticity import elasticity_forms
    from tpufem_torch.sparse.bcsr import (BCSRMatrix, apply_dirichlet_bcsr,
                                          assemble_bcsr)

    mesh = (perturbed_rectangle_mesh(-1, 1, -1, 1, 20, 20, jitter=0.2,
                                     seed=0) if dim == 2
            else box_mesh(-1, 1, -1, 1, -1, 1, 7, 7, 7))
    V = VectorFunctionSpace(mesh, degree=1)
    wf = elasticity_forms(V, 1.0, 1.0)
    wf.device = "cpu"
    pat = ell_pattern(V.scalar_dof_conn, V.num_scalar_dofs,
                      pad_to=8 if dim == 2 else 16)
    A = assemble_bcsr(pat, wf.element_matrices(
        torch.as_tensor(mesh.element_coords())), dim)
    A, _ = apply_dirichlet_bcsr(A, torch.zeros(V.num_dofs,
                                               dtype=torch.float64),
                                V.dof_flags)
    return (BCSRMatrix(A.data.to(dev), A.cols.to(dev)),
            BCSRMatrix(A.data, A.cols), mesh.coords)


@pytest.mark.parametrize("dim", [2, 3])
def test_block_amg_on_the_card(dev, dim):
    """build_block_amg on a card matrix primes every coarse level and
    transfer matrix (none left unresolved; the finest by the bandwidth
    rule, here banded), its cycle launches B12 (b = 3 transfers in 2D, 6 x
    6 levels and transfers in 3D) and equals the same hierarchy's cycle on
    the CPU within 1e-12 relative (fp64)."""
    from tpufem_torch.solve.amg_block import build_block_amg
    from tpufem_torch.sparse import ell_cuda

    A_dev, A_cpu, coords = _elasticity_system(dev, dim)
    walls = {}
    h = build_block_amg(A_dev, coords=coords, walls_out=walls)
    hc = build_block_amg(A_cpu, coords=coords)
    assert len(h.levels) >= 1 and walls["gather"] == []
    for lv in h.levels:
        for M in (lv.A, lv.Qp, lv.Qr):
            assert isinstance(M._band, tuple)
    assert h.levels[0].Qp.block_size == (3 if dim == 2 else 6)
    r = torch.randn(A_cpu.shape[0], dtype=torch.float64,
                    generator=torch.Generator().manual_seed(dim))
    before = ell_cuda.bcsr_matvec_cuda.launches
    z = h.apply(r.to(dev))
    torch.cuda.synchronize()
    assert ell_cuda.bcsr_matvec_cuda.launches > before
    zc = hc.apply(r)
    assert (z.cpu() - zc).abs().max() <= 1e-12 * zc.abs().max()


@pytest.mark.parametrize("transfer", ["banded", "gather"])
def test_scalar_amg_on_the_card(dev, transfer):
    """build_amg (greedy, strength 0.08) on a card matrix primes every
    level operator and embedded transfer (with transfer="gather" only the
    rectangular P and P^T ride the gather kernel); apply launches B9 and
    apply_multi B10; both equal the CPU hierarchy's within 1e-12."""
    from tpufem_torch.assemble.ell import assemble_ell
    from tpufem_torch.assemble.local import p1_stiffness
    from tpufem_torch.fem.elements import P1Triangle
    from tpufem_torch.mesh.adjacency import ell_pattern, reverse_cuthill_mckee
    from tpufem_torch.mesh.rectangle import perturbed_rectangle_mesh
    from tpufem_torch.solve.amg import build_amg
    from tpufem_torch.solve.bc import apply_dirichlet_ell
    from tpufem_torch.sparse import ell_cuda
    from tpufem_torch.sparse.ell import ELLMatrix, reorder_ell

    mesh = perturbed_rectangle_mesh(-3, 3, -3, 3, 40, 40, jitter=0.25,
                                    seed=0)
    pat = ell_pattern(mesh.conn, mesh.num_nodes, pad_to=8)
    A = assemble_ell(pat, p1_stiffness(torch.as_tensor(
        mesh.element_coords()), P1Triangle()))
    A, _ = apply_dirichlet_ell(A, torch.zeros(mesh.num_nodes,
                                              dtype=torch.float64),
                               torch.as_tensor(mesh.node_flags != 0))
    data, cols = reorder_ell(A.data, A.cols,
                             reverse_cuthill_mckee(A.cols.numpy()))
    walls = {}
    kw = dict(strength=0.08, coarse_n=100, transfer=transfer)
    h = build_amg(ELLMatrix(torch.as_tensor(data, device=dev),
                            torch.as_tensor(cols, device=dev)),
                  walls_out=walls, **kw)
    hc = build_amg(ELLMatrix(torch.as_tensor(data), torch.as_tensor(cols)),
                   **kw)
    assert len(h.levels) >= 2
    assert walls["gather"] == ([] if transfer == "banded" else [
        f"{m}{i}" for i in range(len(h.levels)) for m in "PR"])
    for lv in h.levels:
        for M in (lv.A, lv.Qp, lv.Qr):
            assert M is None or isinstance(M._band, tuple)
    before_g = ell_cuda.ell_gather_matvec_cuda.launches
    g = torch.Generator().manual_seed(0)
    R = torch.randn((data.shape[0], 3), dtype=torch.float64, generator=g)
    before = (ell_cuda.ell_matvec_cuda.launches,
              ell_cuda.ell_matvec_multi_cuda.launches)
    z = h.apply(R[:, 0].contiguous().to(dev))
    Z = h.apply_multi(R.to(dev))
    torch.cuda.synchronize()
    assert ell_cuda.ell_matvec_cuda.launches > before[0]
    assert ell_cuda.ell_matvec_multi_cuda.launches > before[1]
    assert (ell_cuda.ell_gather_matvec_cuda.launches > before_g) == (
        transfer == "gather")
    zc, Zc = hc.apply(R[:, 0].contiguous()), hc.apply_multi(R)
    assert (z.cpu() - zc).abs().max() <= 1e-12 * zc.abs().max()
    assert (Z.cpu() - Zc).abs().max() <= 1e-12 * Zc.abs().max()


@pytest.mark.parametrize("matvec", ["gather", "pallas"])
def test_amg_solves_on_the_card(dev, matvec):
    """solve_elasticity(precond="amg") (2D, both branches) and
    solve_poisson_ell(precond="amg") on the card, fp64: the CPU's
    iteration counts, solutions within 1e-10 relative."""
    from tpufem_torch.mesh.rectangle import perturbed_rectangle_mesh
    from tpufem_torch.solve.elasticity import solve_elasticity
    from tpufem_torch.solve.poisson import solve_poisson_ell

    mesh = perturbed_rectangle_mesh(-1, 1, -1, 1, 20, 20, jitter=0.2,
                                    seed=0)

    def f(x):
        return torch.stack([0 * x[..., 0] + 1.0, 0 * x[..., 1] - 0.5], -1)

    sols = [solve_elasticity(mesh, body_force=f, tol=1e-10, matvec=matvec,
                             precond="amg", device=d)
            for d in (dev, "cpu")]
    if matvec == "gather":
        mesh = perturbed_rectangle_mesh(-3, 3, -3, 3, 40, 40, jitter=0.2,
                                        seed=3)
        sols += [solve_poisson_ell(mesh, tol=1e-10, precond="amg", device=d)
                 for d in (dev, "cpu")]
    for card, cpu in zip(sols[::2], sols[1::2]):
        assert card.cg.converged and card.cg.iterations == cpu.cg.iterations
        assert ((card.u.cpu() - cpu.u).abs().max()
                <= 1e-10 * cpu.u.abs().max())


def test_elasticity_box_on_the_card(dev):
    """solve_elasticity_box with the vector MG on the card, fp64: the
    CPU's iteration count, the solution within 1e-10 relative."""
    from tpufem_torch.solve.elasticity_structured import (
        manufactured_elasticity_3d, solve_elasticity_box)

    f = manufactured_elasticity_3d(1.2, 0.8)[1]
    sols = [solve_elasticity_box((-3.0, 3.0), 16, lam=1.2, mu=0.8,
                                 body_force=f, dtype=torch.float64,
                                 tol=1e-8, maxiter=200, precond="mg",
                                 device=d) for d in (dev, "cpu")]
    assert sols[0].cg.converged
    assert sols[0].cg.iterations == sols[1].cg.iterations
    assert ((sols[0].u.cpu() - sols[1].u).abs().max()
            <= 1e-10 * sols[1].u.abs().max())


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("b", [2, 3, 4, 6])
@pytest.mark.parametrize("k", [3, 5, 25, 64])
@pytest.mark.parametrize("form", ["loop", "out"])
def test_bcsr_band_run_time_forms_bit_equal(dev, monkeypatch, dtype, b, k,
                                            form):
    """Both run-time-K forms of B12 (a thread a row in groups of slots, one
    at a time under two groups; b threads a row), whichever the chooser
    would pick, equal the plain version bit for bit, on ragged tiles."""
    from tpufem_torch.sparse import ell_cuda

    monkeypatch.setattr(ell_cuda, "bcsr_band_design",
                        lambda b_, k_, rows: form)
    data, cols, x = _bcsr_case(dev, dtype, b, n=1037, k=k)
    plan, data_t = ell_cuda.bcsr_band_plan(data, cols, block_rows=512)
    d_t, rel = (torch.as_tensor(a, device=dev) for a in (data_t, plan.rel))
    y = ell_cuda.bcsr_matvec_cuda(plan, d_t, rel, x)
    torch.cuda.synchronize()
    assert torch.equal(y, ell_cuda.bcsr_band_matvec_plain(plan, d_t, rel, x))


def _robin_p2_form(V, L):
    """A Robin + Neumann P2 Poisson form (boundary slots in the matrix)."""
    def build(wf):
        wf.build(lambda u, v: L.dot(L.grad(u), L.grad(v)),
                 lambda v: L.Constant(1.0) * v)
        wf.build_boundary(lhs=lambda u, v: 2.5 * u * v,
                          rhs=lambda v: L.Coefficient(
                              lambda p: 1.0 + p[..., 0] * p[..., 1]) * v)
        return wf
    return build


@pytest.mark.parametrize("fmt", ["ell", "dense", "stencil"])
def test_boundary_slot_scatter_on_the_card(dev, fmt):
    """The boundary terms' slot scatter (sorted accumulation) on the card:
    two assemblies bit for bit equal, and equal to the CPU's within fp64
    rounding (P2 tets for ELL / dense, P1 triangles for the stencil)."""
    from tpufem_torch.fem.space import FunctionSpace
    from tpufem_torch.forms import language as L
    from tpufem_torch.forms.weakform import WeakForm
    from tpufem_torch.mesh.box import box_mesh
    from tpufem_torch.mesh.rectangle import rectangle_mesh

    if fmt == "stencil":
        V = FunctionSpace(rectangle_mesh(-3, 3, -3, 3, 24, 20))
    else:
        V = FunctionSpace(box_mesh(-1, 1, -1, 1, -1, 1, 3, 4, 3), degree=2)
    build = _robin_p2_form(V, L)
    out = [build(WeakForm(V, device=d)).assemble(format=fmt)
           for d in (dev, dev, "cpu")]

    def data(A):
        return A if fmt == "dense" else A.data

    assert torch.equal(data(out[0][0]), data(out[1][0]))
    assert torch.equal(out[0][1], out[1][1])
    ref = data(out[2][0])
    assert (data(out[0][0]).cpu() - ref).abs().max() <= \
        1e-12 * ref.abs().max()
    assert (out[0][1].cpu() - out[2][1]).abs().max() <= \
        1e-12 * out[2][1].abs().max()


def test_coo_and_matfree_on_the_card(dev):
    """assemble_coo and the three matrix-free products on the card: each
    twice bit for bit equal, equal to the CPU's within fp64 rounding, and
    the products equal to B9's (the ELL assembly on the card)."""
    from tpufem_torch.assemble.coo import assemble_coo
    from tpufem_torch.assemble.ell import assemble_ell
    from tpufem_torch.assemble.local import p1_stiffness
    from tpufem_torch.fem.elements import element_for_cell
    from tpufem_torch.mesh.adjacency import ell_pattern, pattern_unique_keys
    from tpufem_torch.mesh.box import box_mesh
    from tpufem_torch.mesh.rectangle import perturbed_rectangle_mesh
    from tpufem_torch.sparse import ell_cuda
    from tpufem_torch.sparse.matfree import element_operator, poisson_operator

    for mesh in (perturbed_rectangle_mesh(-3, 3, -3, 3, 40, 30, jitter=0.2,
                                          seed=1),
                 box_mesh(-1, 1, -1, 1, -1, 1, 6, 5, 4)):
        el = element_for_cell(mesh.cell_type)
        nn = mesh.num_nodes
        pat = ell_pattern(mesh.conn, nn, pad_to=8, with_sort_plan=False)
        keys = pattern_unique_keys(pat)
        x = torch.randn(nn, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(3))
        results = {}
        for d in (dev, "cpu"):
            ec = torch.as_tensor(mesh.element_coords(), device=d)
            Ke = p1_stiffness(ec, el)
            xd = x.to(d)
            ops = [element_operator(mesh.conn, Ke, nn),
                   poisson_operator(ec, mesh.conn, nn, el),
                   poisson_operator(ec, mesh.conn, nn, el, on_the_fly=True)]
            vals = [assemble_coo(mesh.conn, Ke, keys, nn) for _ in range(2)]
            ys = [[op(xd) for _ in range(2)] for op in ops]
            results[str(d)] = (vals, ys)
            if d is dev:
                before = ell_cuda.ell_gather_matvec_cuda.launches + \
                    ell_cuda.ell_matvec_cuda.launches
                y_ell = assemble_ell(pat, Ke).matvec(xd)
                assert ell_cuda.ell_gather_matvec_cuda.launches + \
                    ell_cuda.ell_matvec_cuda.launches > before
        (vals, ys), (cvals, cys) = results[str(dev)], results["cpu"]
        assert torch.equal(vals[0], vals[1])
        assert (vals[0].cpu() - cvals[0]).abs().max() <= \
            1e-12 * cvals[0].abs().max()
        for (y1, y2), (c1, _) in zip(ys, cys):
            assert torch.equal(y1, y2)
            assert (y1.cpu() - c1).abs().max() <= 1e-12 * c1.abs().max()
            assert (y1 - y_ell).abs().max() <= 1e-12 * y_ell.abs().max()


@pytest.mark.parametrize("cell", ["quad", "hex", "p2"])
def test_weakform_entry_points_launch_b9_not_plain(dev, monkeypatch, cell):
    """solve_poisson_ell on a Q1 quad / hex mesh, and a P2 Neumann system
    solved with AMG-PCG, with CUDA tensors: B9 launches and the plain
    versions never run (they raise here); counts and solutions equal the
    CPU's."""
    from tpufem_torch.sparse import ell_cuda

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card path")

    def solve(device):
        if cell == "quad":
            from tpufem_torch.mesh.rectangle import perturbed_quad_mesh
            from tpufem_torch.solve.poisson import solve_poisson_ell

            mesh = perturbed_quad_mesh(-3, 3, -3, 3, 24, 24, jitter=0.25,
                                       seed=5)
            return solve_poisson_ell(mesh, precond="amg", tol=1e-10,
                                     device=device)
        if cell == "hex":
            from tpufem_torch.mesh.box import box_hex_mesh
            from tpufem_torch.solve.poisson import solve_poisson_ell

            mesh = box_hex_mesh(-3, 3, -3, 3, -3, 3, 8, 8, 8)
            return solve_poisson_ell(mesh, precond="amg", tol=1e-10,
                                     device=device)
        import numpy as np

        from tpufem_torch.fem.space import FunctionSpace
        from tpufem_torch.forms import language as L
        from tpufem_torch.forms.weakform import WeakForm
        from tpufem_torch.mesh.adjacency import reverse_cuthill_mckee
        from tpufem_torch.mesh.rectangle import rectangle_mesh
        from tpufem_torch.solve.amg import build_amg
        from tpufem_torch.solve.bc import apply_dirichlet_ell
        from tpufem_torch.solve.cg import cg
        from tpufem_torch.sparse.ell import ELLMatrix, reorder_ell

        V = FunctionSpace(rectangle_mesh(-3, 3, -3, 3, 20, 20), degree=2)
        wf = WeakForm(V, device=device).build(
            lambda u, v: L.dot(L.grad(u), L.grad(v)),
            lambda v: L.Constant(1.0) * v)
        wf.build_boundary(rhs=lambda v: L.Constant(-2.0) * v,
                          where=lambda c: np.abs(c[:, 1]) > 3 - 1e-9)
        A, b = wf.assemble(format="ell")
        A, b = apply_dirichlet_ell(A, b, torch.as_tensor(
            np.abs(V.scalar_dof_coords[:, 0]) > 3 - 1e-9, device=device))
        perm = reverse_cuthill_mckee(A.cols.cpu().numpy())
        data, cols = reorder_ell(A.data, A.cols, perm)
        Ap = ELLMatrix(torch.as_tensor(data, device=device),
                       torch.as_tensor(cols, device=device))
        hier = build_amg(Ap, aggregation="greedy", strength=0.08,
                         coarse_n=300)
        res = cg(Ap.matvec, b[torch.as_tensor(perm, device=device)],
                 tol=1e-10, maxiter=200, M=hier.apply)

        class Sol:
            pass

        sol = Sol()
        sol.cg, sol.u = res, res.x
        return sol

    cpu = solve("cpu")
    monkeypatch.setattr(ell_cuda, "ell_band_matvec_plain", refuse)
    monkeypatch.setattr(ell_cuda, "ell_gather_matvec_plain", refuse)
    before = ell_cuda.ell_matvec_cuda.launches
    card = solve(dev)
    torch.cuda.synchronize()
    assert ell_cuda.ell_matvec_cuda.launches > before
    assert card.cg.converged and card.cg.iterations == cpu.cg.iterations
    assert (card.u.cpu() - cpu.u).abs().max() <= 1e-10 * cpu.u.abs().max()


def test_ell_dual_product_launches_b9_twice(dev):
    """The forward-mode product (Newton's Jacobian-vector product): a dual
    x runs B9 on the primal and on the tangent, each bit for bit its plain
    version's."""
    import torch.autograd.forward_ad as fwad

    from tpufem_torch.sparse import ell_cuda
    from tpufem_torch.sparse.ell import ELLMatrix

    data, cols, x = _ell_case(dev, torch.float64)
    t = torch.randn(x.shape[0], generator=torch.Generator(
        device="cpu").manual_seed(1), dtype=x.dtype).to(dev)
    A = ELLMatrix(data, cols).resolve_band()
    plan, d_t, rel = A._band
    before = ell_cuda.ell_matvec_cuda.launches
    with fwad.dual_level():
        y = fwad.unpack_dual(A.matvec(fwad.make_dual(x, t)))
    torch.cuda.synchronize()
    assert ell_cuda.ell_matvec_cuda.launches == before + 2
    assert torch.equal(y.primal, ell_cuda.ell_band_matvec_plain(
        plan, d_t, rel, x))
    assert torch.equal(y.tangent, ell_cuda.ell_band_matvec_plain(
        plan, d_t, rel, t))


@pytest.mark.parametrize("q", [8, 5])
def test_ell_gather_multi_fp64_at_the_modal_widths(dev, q):
    """B10's absolute-column form in fp64 at the modal path's q = 8 (the
    refinement's residuals) and q = 5 (its finish), bit for bit."""
    from tpufem_torch.sparse import ell_cuda

    data, cols, _ = _ell_case(dev, torch.float64, n=20001, band=150)
    X = torch.randn((20001, q), generator=torch.Generator(
        device="cpu").manual_seed(q), dtype=torch.float64).to(dev)
    before = ell_cuda.ell_gather_matvec_multi_cuda.launches
    Y = ell_cuda.ell_gather_matvec_multi_cuda(data, cols, X)
    torch.cuda.synchronize()
    assert ell_cuda.ell_gather_matvec_multi_cuda.launches == before + 1
    assert torch.equal(Y, ell_cuda.ell_gather_matvec_multi_plain(data, cols,
                                                                 X))


def test_physics_solvers_on_the_card_match_the_cpu(dev, monkeypatch):
    """newton_krylov, leapfrog_wave and the mixed subspace iteration on
    the card (B9, B10 banded and absolute; the plain products refused)
    against the same calls on the CPU: Newton and inner counts equal, x
    within 1e-10; the wave within 1e-12; the fp64 Rayleigh-Ritz values of
    the fp64 lockstep steps' subspace within 1e-10, the mixed steps'
    eigenvalues within 8 eps32; one B9 launch per step plus one."""
    from tpufem_torch.assemble.dense import assemble_vector
    from tpufem_torch.assemble.ell import assemble_ell
    from tpufem_torch.assemble.local import (element_load, element_mass,
                                             element_nonlinear_load,
                                             p1_stiffness)
    from tpufem_torch.fem.elements import P1Triangle
    from tpufem_torch.fem.quadrature import triangle_rule
    from tpufem_torch.mesh.adjacency import ell_pattern
    from tpufem_torch.mesh.rectangle import rectangle_mesh
    from tpufem_torch.solve.bc import apply_dirichlet_ell
    from tpufem_torch.solve.dynamics import leapfrog_wave
    from tpufem_torch.solve.eigen import subspace_stepper
    from tpufem_torch.solve.newton import newton_krylov
    from tpufem_torch.solve.precond import jacobi
    from tpufem_torch.sparse import ell_cuda
    from tpufem_torch.sparse.ell import ELLMatrix, ell_matvec_multi

    mesh = rectangle_mesh(-3, 3, -3, 3, 24, 24)
    nn = mesh.num_nodes
    el, rule = P1Triangle(), triangle_rule(5)
    pat = ell_pattern(mesh.conn, nn, pad_to=8, with_sort_plan=False)

    def exact(x):
        return (9.0 - x[..., 0] ** 2) * (9.0 - x[..., 1] ** 2)

    def system(device):
        ec = torch.as_tensor(mesh.element_coords(), device=device)
        conn = torch.as_tensor(mesh.conn, device=device).long()
        A = assemble_ell(pat, p1_stiffness(ec, el))
        b = assemble_vector(conn, element_load(
            ec, el, rule, lambda x: 36.0 - 2.0 * (x[..., 0] ** 2
                                                  + x[..., 1] ** 2)
            + exact(x) ** 3), nn)
        bc = torch.as_tensor(mesh.node_flags != 0, device=device)
        mL = assemble_vector(conn, element_mass(ec, el, rule).sum(-1), nn)
        return ec, conn, A, b, bc, mL

    def run(device):
        ec, conn, A, b, bc, mL = system(device)

        def residual(u):
            ui = torch.where(bc, 0.0, u)
            nl = assemble_vector(conn, element_nonlinear_load(
                ec, el, rule, ui[conn], lambda w: w ** 3), nn)
            return torch.where(bc, u, A.matvec(ui) + nl - b)

        inv = torch.where(bc, 1.0, 1.0 / A.diagonal())
        nk = newton_krylov(residual, torch.zeros(nn, dtype=torch.float64,
                                                 device=device),
                           tol=1e-10, M=lambda r: r * inv)
        Ab, _ = apply_dirichlet_ell(A, torch.zeros_like(b), bc)
        u0 = torch.where(bc, 0.0, torch.as_tensor(np.sin(
            np.pi * (mesh.coords[:, 0] + 3) / 6) * np.sin(
            np.pi * (mesh.coords[:, 1] + 3) / 6), device=device))
        b9 = ell_cuda.ell_matvec_cuda.launches
        wave = leapfrog_wave(Ab.matvec, mL, u0, torch.zeros_like(u0), 0.02,
                             50, bc_mask=bc)
        b9 = ell_cuda.ell_matvec_cuda.launches - b9
        mL1 = torch.where(bc, 1.0, mL)
        A32 = ELLMatrix(Ab.data.float(), Ab.cols, Ab.row_lengths,
                        Ab.diag_pos)
        _, step, finish = subspace_stepper(
            A32.matvec, nn, 3, lumped_mass=mL1, M=jacobi(A32), bc_mask=bc,
            inner_iters=15, buffer=3, dtype=torch.float32,
            matvec_multi=A32.matvec_multi,
            matvec_hi_multi=lambda X: ell_matvec_multi(Ab.data, Ab.cols, X),
            device=device)
        X = torch.as_tensor(np.where(
            (mesh.node_flags != 0)[:, None], 0.0, np.random.default_rng(
                0).standard_normal((nn, 6))), device=device)
        X64 = X
        _, step64, _ = subspace_stepper(
            Ab.matvec, nn, 3, lumped_mass=mL1, M=jacobi(Ab), bc_mask=bc,
            inner_iters=15, buffer=3, matvec_multi=Ab.matvec_multi,
            device=device)
        for _ in range(3):
            X, X64 = step(X), step64(X64)
        return nk, wave, b9, X64, finish(X), Ab, mL1

    cpu = run("cpu")
    for plain in ("ell_band_matvec_plain", "ell_band_matvec_multi_plain",
                  "ell_gather_matvec_plain", "ell_gather_matvec_multi_plain"):
        monkeypatch.setattr(ell_cuda, plain, _refuse_plain)
    before = (ell_cuda.ell_matvec_multi_cuda.launches,
              ell_cuda.ell_gather_matvec_multi_cuda.launches)
    card = run(dev)
    torch.cuda.synchronize()
    assert ell_cuda.ell_matvec_multi_cuda.launches > before[0]
    assert ell_cuda.ell_gather_matvec_multi_cuda.launches > before[1]
    (nk, wave, b9, X, fin, Ab, mL), (nkc, wavec, _, Xc, finc, _, _) = (
        card, cpu)
    assert nk.converged and nk.iterations == nkc.iterations
    assert nk.inner_iterations == nkc.inner_iterations
    assert (nk.x.cpu() - nkc.x).abs().max() <= 1e-10 * nkc.x.abs().max()
    assert b9 == 51
    for a, c in zip(wave, wavec):
        assert (a.cpu() - c).abs().max() <= 1e-12 * c.abs().max()
    D, m = Ab.to_dense().cpu().double().numpy(), mL.cpu().numpy()

    def ritz64(Y):
        Y = Y.cpu().numpy()
        G = np.linalg.cholesky(Y.T @ (m[:, None] * Y))
        Gi = np.linalg.inv(G)
        return np.linalg.eigvalsh(Gi @ (Y.T @ D @ Y) @ Gi.T)

    # the fp64 lockstep steps' subspaces give the same Ritz values; the
    # mixed ones, whose fp32 inner solves round differently on the card,
    # agree at fp32 resolution (tests/test_torch_eigen.py's)
    lam, lamc = ritz64(X), ritz64(Xc)
    assert np.abs(lam - lamc).max() <= 1e-10 * np.abs(lamc).max()
    assert (fin.eigenvalues.cpu() - finc.eigenvalues).abs().max() <= \
        8 * np.finfo(np.float32).eps * finc.eigenvalues.abs().max()


def _refuse_plain(*args, **kw):
    raise AssertionError("a plain version ran on the card")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("vprecond", ["jacobi", "amg"])
def test_stokes_cavity_on_the_card_matches_the_cpu(dev, monkeypatch, dtype,
                                                   vprecond):
    """solve_stokes on the n = 12 lid-driven cavity (examples/
    stokes_cavity.py's lid; "amg" with coarse_n = 100, a level over the
    625 scalar P2 rows) on the card, its ELL products on B9 (the plain
    versions refused), against the same call on the CPU: the MINRES count
    equal, u and p within 1e-8 (fp64) or 1e-4 (fp32) of max |u|, |p|."""
    from tpufem_torch.mesh.rectangle import rectangle_mesh
    from tpufem_torch.solve.stokes import solve_stokes
    from tpufem_torch.sparse import ell_cuda

    def lid(X):
        on_top = (np.abs(X[..., 1] - 1.0) < 1e-12).astype(float)
        profile = 16.0 * (X[..., 0] * (1 - X[..., 0])) ** 2
        return np.stack([on_top * profile, 0.0 * X[..., 0]], axis=-1)

    mesh = rectangle_mesh(0.0, 1.0, 0.0, 1.0, 12, 12)
    tol = 1e-8 if dtype == torch.float64 else 1e-6
    kw = dict(bc_velocity=lid, dtype=dtype, tol=tol, maxiter=4000,
              velocity_precond=vprecond, amg_kw=dict(coarse_n=100))
    cpu = solve_stokes(mesh, device="cpu", **kw)
    for plain in ("ell_band_matvec_plain", "ell_gather_matvec_plain"):
        monkeypatch.setattr(ell_cuda, plain, _refuse_plain)
    before = ell_cuda.ell_matvec_cuda.launches
    card = solve_stokes(mesh, device=dev, **kw)
    torch.cuda.synchronize()
    if vprecond == "amg":
        assert ell_cuda.ell_matvec_cuda.launches > before
    assert card.res.converged and cpu.res.converged
    assert card.res.iterations == cpu.res.iterations
    rel = 1e-8 if dtype == torch.float64 else 1e-4
    for a, c in ((card.u, cpu.u), (card.p, cpu.p)):
        assert a.dtype == dtype and a.is_cuda
        assert (a.cpu() - c).abs().max() <= rel * c.abs().max()


def test_device_seconds_per_rep_agrees_with_cuda_events(dev):
    """utils.timing's rep-difference over a loop of B14 block sums lies
    within a factor 2 of the CUDA events' median time of one block sum, on
    a 256 MB vector: large enough that the device, not the host's four
    launches a repetition, sets a repetition's time (on examples/
    reduction_bench.py's 64 MB the loop is host-bound)."""
    from tpufem_torch.ops.reduction import block_reduce
    from tpufem_torch.utils.timing import cuda_ms, device_seconds_per_rep

    n = 1 << 26
    x = torch.rand(n, device=dev)

    def sum_many(reps):
        acc = torch.zeros((), device=dev)
        for _ in range(reps):
            acc = acc * 0.0 + block_reduce(x, block=n // 8)
        return acc

    before = block_reduce.launches
    per_rep_ms = device_seconds_per_rep(sum_many, reps_low=10,
                                        reps_high=210) * 1e3
    assert block_reduce.launches > before
    event_ms = cuda_ms(lambda: block_reduce(x, block=n // 8))
    assert 0.5 * event_ms <= per_rep_ms <= 2.0 * event_ms, (per_rep_ms,
                                                            event_ms)


def test_loaded_ell_system_launches_b9(dev, tmp_path, monkeypatch):
    """A system saved by io.checkpoint on the host and loaded onto the
    card: its product is the banded ELL kernel (B9; the plain versions
    refused) and equals the host product."""
    from tpufem_torch.assemble.ell import assemble_ell
    from tpufem_torch.assemble.local import p1_stiffness
    from tpufem_torch.fem.elements import P1Triangle
    from tpufem_torch.io.checkpoint import load_system, save_system
    from tpufem_torch.mesh.adjacency import ell_pattern
    from tpufem_torch.mesh.rectangle import rectangle_mesh
    from tpufem_torch.sparse import ell_cuda

    mesh = rectangle_mesh(-1.0, 1.0, -1.0, 1.0, 40, 40)
    pat = ell_pattern(mesh.conn, mesh.num_nodes, pad_to=8)
    A = assemble_ell(pat, p1_stiffness(torch.as_tensor(
        mesh.element_coords(), dtype=torch.float32), P1Triangle()))
    b = torch.rand(mesh.num_nodes)
    path = str(tmp_path / "system.npz")
    save_system(path, A, b, level=0)
    A_dev, b_dev, extras = load_system(path, device=dev)
    assert A_dev.data.is_cuda and b_dev.is_cuda and int(extras["level"]) == 0
    ref = A.matvec(b)
    for plain in ("ell_band_matvec_plain", "ell_gather_matvec_plain"):
        monkeypatch.setattr(ell_cuda, plain, _refuse_plain)
    before = ell_cuda.ell_matvec_cuda.launches
    y = A_dev.matvec(b_dev)
    torch.cuda.synchronize()
    assert ell_cuda.ell_matvec_cuda.launches == before + 1
    _close(y.cpu(), ref, torch.float32)
