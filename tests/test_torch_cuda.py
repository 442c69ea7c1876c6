"""CUDA kernels K1-K4, B4 and B5 against their plain PyTorch versions on
the card.

Every test here needs an NVIDIA GPU with nvcc (sm_90a) and skips without
one.  This file imports neither JAX nor the JAX package, so it runs on a
machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""
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
