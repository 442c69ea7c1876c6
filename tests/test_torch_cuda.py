"""CUDA kernels K1-K4 (the tiled K3 and K4 over every level pair and
tile shape), B3-B5, B5b, B7, B8, the ELL kernels B9-B11, the BCSR kernel
B12, the fused assembly B13, the block sum B14 and SAXPY B15 against their
plain PyTorch versions on the card.

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

# Tolerances: a kernel and its plain version compute the same sums in
# another order (and with FMA contraction), so fields agree to a few ulps
# of the largest entry; fp64 dots are accumulated in fp64 on both sides.
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
    _close(A.data, Ap.data, dtype)
    _close(b, bp, dtype)


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

def _grid_2d(n):
    from tpufem_torch.solve.multigrid import _light_grid

    info, coords, _ = _light_grid((-3.0, 3.0), n, 2)
    return structured_plan(info, embed=True), coords


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("rhs_mode", ["quadrature", "interp"])
@pytest.mark.parametrize("apply_bc", [True, False])
def test_fused_system_2d_kernel_matches_plain(dev, dtype, rhs_mode, apply_bc):
    from tpufem_torch.fem.quadrature import triangle_rule
    from tpufem_torch.solve.poisson import model_problem_2d_planes

    plan, coords = _grid_2d(24)      # x pads 25 nodes to 128 store columns
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    C = torch.as_tensor(node_coords_embedded_from_grid(coords, plan, np_dt),
                        device=dev)
    f, rule = model_problem_2d_planes(), triangle_rule(2)
    before = fused_system_cuda.build_poisson_system.launches_2d
    A, b = build_poisson_system(plan, C, f, rule, apply_bc=apply_bc,
                                rhs_mode=rhs_mode)
    Ap, bp = build_poisson_system_plain(plan, C, f, rule, apply_bc=apply_bc,
                                        rhs_mode=rhs_mode)
    torch.cuda.synchronize()
    assert fused_system_cuda.build_poisson_system.launches_2d == before + 1
    _close(A.data, Ap.data, dtype)
    _close(b, bp, dtype)


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


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("dims", [(5, 4, 6), (8, 8, 8)],
                         ids=["box5x4x6", "cube8"])
def test_assemble_kernel_matches_plain_and_k1(dev, dtype, dims):
    """B13 equals its plain version bit for bit, and its planes are K1's
    raw stiffness (apply_bc=False) within the field tolerance."""
    from tpufem_torch.mesh.box import box_mesh
    from tpufem_torch.ops.assemble_cuda import (assemble_stencil_cuda,
                                                assemble_stencil_plain,
                                                element_coords_bt_embedded)

    mesh = box_mesh(-1, 2, 0, 1, -2, 0, *dims)
    plan = structured_plan(mesh, embed=True)
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    X = torch.as_tensor(element_coords_bt_embedded(mesh, plan, dtype=np_dt),
                        device=dev)
    before = assemble_stencil_cuda.launches
    A = assemble_stencil_cuda(plan, X)
    assert assemble_stencil_cuda.launches == before + 1
    ref = assemble_stencil_plain(plan, X)
    torch.cuda.synchronize()
    assert A.data.device.type == "cuda" and A.offsets == ref.offsets
    assert torch.equal(A.data, ref.data)
    ng = plan.info.node_grid
    coords = np.moveaxis(mesh.coords.reshape(*ng, 3), -1, 0)
    C = torch.as_tensor(node_coords_embedded_from_grid(coords, plan, np_dt),
                        device=dev)
    K1, _ = build_poisson_system(plan, C, model_problem_3d_planes(),
                                 tetrahedron_rule(2), apply_bc=False)
    _close(A.data, K1.data, dtype)


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
    bit for bit (the same kernel body and order); each stripe is within a
    few ulps of its plain version (FMA contraction, as K1's)."""
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
        _close(data.shards[i].to(d.device), d, dtype)
        _close(rhs.shards[i].to(r.device), r, dtype)


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
