"""CUDA kernels K1-K4 against their plain PyTorch versions on the card.

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
from tpufem_torch.ops.fused_system_cuda import (
    build_poisson_system, build_poisson_system_plain,
    node_coords_embedded_from_grid)
from tpufem_torch.ops.mg_transfer_cuda import (
    const_prolong_add_smooth_embedded, const_prolong_add_smooth_plain,
    const_residual_restrict_embedded, const_residual_restrict_plain)
from tpufem_torch.ops.stencil_cuda import stencil_apply, stencil_apply_plain
from tpufem_torch.solve.multigrid import build_poisson_multigrid
from tpufem_torch.solve.poisson import RhsFunction, model_problem_3d_planes
from tpufem_torch.solve.structured_fast import solve_poisson_fast

pytestmark = pytest.mark.cuda

# Tolerances: a kernel and its plain version compute the same sums in
# another order (and with FMA contraction), so fields agree to a few ulps
# of the largest entry; fp64 dots are accumulated in fp64 on both sides.
_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
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
                                 device=dev)
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
