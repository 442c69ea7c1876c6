"""Port parity, kernels B4 (general-coefficient residual, Jacobi sweep,
sweep + <r, y>) and B5 (const-weight matvec, residual, sweep, sweep + dot):
the port's plain versions against the JAX package's XLA forms
(``use_pallas=False``, which its own tests pin to the Pallas kernels) and,
on a tiny grid, against the Pallas kernels in interpret mode; float64 at
1e-12, bf16 data under fp32 vectors at 1e-6 relative, on the CPU."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpufem.ops import stencil_pallas as jsp
from tpufem.solve import multigrid as jmg

from tpufem_torch.convert import const_level_from_numpy, level_from_numpy
from tpufem_torch.ops import stencil_cuda
from tpufem_torch.ops.stencil_cuda import (const_stencil_apply,
                                           const_stencil_apply_plain,
                                           stencil_fused_apply)
from tpufem_torch.sparse.stencil import StencilMatrix

# several pytest workers share the CPU: one intra-op thread each keeps
# the many small tensor ops from oversubscribing it
torch.set_num_threads(1)

OMEGA = 0.8


def _meta(l):
    return dict(node_grid=l.plan.info.node_grid,
                cell_grid=l.plan.info.cell_grid,
                type_node_offsets=np.asarray(l.plan.info.type_node_offsets),
                store_grid=l.plan.store_grid, offsets=l.plan.offsets)


def _general(n, dtype=jnp.float64):
    """(JAX finest general level, the port's copy in float64)."""
    jl = jmg.build_poisson_multigrid((-3.0, 3.0), n, 3, dtype=dtype,
                                     coarse_max=4, use_pallas=False)[0]
    tl = level_from_numpy(**_meta(jl), data=np.asarray(jl.data, np.float64),
                          inv_diag=np.asarray(jl.inv_diag, np.float64),
                          bc_mask=np.asarray(jl.bc_mask))
    return jl, tl


def _const(n):
    jl = jmg.build_poisson_multigrid((-3.0, 3.0), n, 3, dtype=jnp.float64,
                                     coarse_max=4, use_pallas=False,
                                     operator="const")[0]
    return jl, const_level_from_numpy(**_meta(jl), weights=jl.weights,
                                      code=np.asarray(jl.code))


def _rand(level, seed, dtype=np.float64):
    """Random store vector, zero on the embedded padding."""
    rng = np.random.default_rng(seed)
    if hasattr(level, "code"):
        node = np.asarray(level.code) != 0
    else:
        node = np.asarray(level.data[level.plan.offsets.index(0)]) != 0
    return np.where(node, rng.standard_normal(level.plan.num_store_rows),
                    0.0).astype(dtype)


def _close(a, ref, rtol=1e-12):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(a, np.float64), ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1.0))


def _dot_close(d, ref, rtol=1e-12):
    assert abs(float(d) - float(ref)) <= rtol * max(abs(float(ref)), 1.0)


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("epilogue,with_dot", [("residual", False),
                                               ("smooth", False),
                                               ("smooth", True)])
def test_general_epilogues_match_jax(n, epilogue, with_dot):
    jl, tl = _general(n)
    x, r = _rand(jl, 1), _rand(jl, 2)
    jx, jr = jnp.asarray(x), jnp.asarray(r)
    if epilogue == "residual":
        ref = jmg._residual(jl, jr, jx, False)
    else:
        ref = jmg._smooth(jl, jr, jx, OMEGA, False)
    out = stencil_fused_apply(
        epilogue, tl.data, torch.as_tensor(x), tl.plan.offsets,
        b=torch.as_tensor(r),
        inv_diag=tl.inv_diag if epilogue == "smooth" else None, omega=OMEGA,
        with_dot=with_dot)
    if with_dot:
        out, d = out
        _dot_close(d, jnp.vdot(jr, ref))
    _close(out, ref)


@pytest.mark.parametrize("with_dot", [False, True])
def test_general_sweep_bf16_data_matches_jax(with_dot):
    """cast_hierarchy's levels: bf16 data and inv_diag, fp32 vectors."""
    jl32 = jmg.build_poisson_multigrid((-3.0, 3.0), 8, 3, dtype=jnp.float32,
                                       coarse_max=4, use_pallas=False)[0]
    jl = jmg.cast_hierarchy([jl32], jnp.bfloat16)[0]
    x, r = _rand(jl32, 3, np.float32), _rand(jl32, 4, np.float32)
    jr = jnp.asarray(r)
    ref = jmg._smooth(jl, jr, jnp.asarray(x), OMEGA, False)
    assert ref.dtype == jnp.float32
    data = torch.as_tensor(np.array(jl32.data)).to(torch.bfloat16)
    inv_d = torch.as_tensor(np.array(jl32.inv_diag)).to(torch.bfloat16)
    np.testing.assert_array_equal(data.float().numpy(),
                                  np.asarray(jl.data.astype(jnp.float32)))
    out = stencil_fused_apply("smooth", data, torch.as_tensor(x),
                              jl.plan.offsets, b=torch.as_tensor(r),
                              inv_diag=inv_d, omega=OMEGA, with_dot=with_dot)
    if with_dot:
        out, d = out
        _dot_close(d, jnp.vdot(jr, ref), rtol=1e-5)   # fp32 sums reordered
    assert out.dtype == torch.float32
    _close(out, ref, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float64"])
def test_omega_inv_diag_rounds_as_jax(dtype):
    """omega * inv_diag bit for bit as the reference's weakly typed
    product, in inv_diag's type."""
    v = np.random.default_rng(5).uniform(0.01, 3.0, 4096)
    jv = jnp.asarray(v).astype(getattr(jnp, dtype))
    tv = torch.as_tensor(v).to(getattr(torch, dtype))
    out = stencil_cuda.omega_inv_diag(OMEGA, tv)
    ref = OMEGA * jv
    assert out.dtype == tv.dtype
    np.testing.assert_array_equal(out.double().numpy(),
                                  np.asarray(ref.astype(jnp.float64)))


def test_general_sweep_dot_matches_pallas_kernel():
    """Against the replaced TPU kernels themselves, in interpret mode (tiny
    grid: interpret mode is slow on the CPU)."""
    jl, tl = _general(4)
    x, r = _rand(jl, 5), _rand(jl, 6)
    args = (jnp.asarray(jl.data), jnp.asarray(r), jnp.asarray(x))
    y_ref, d_ref = jsp.stencil_smooth_dot_embedded(
        *args, jnp.asarray(jl.inv_diag), jl.plan, omega=OMEGA, block_lead=2,
        interpret=True)
    res_ref = jsp.stencil_residual_embedded(*args, jl.plan, block_lead=2,
                                            interpret=True)
    kw = dict(b=torch.as_tensor(r))
    y, d = stencil_fused_apply("smooth", tl.data, torch.as_tensor(x),
                               tl.plan.offsets, inv_diag=tl.inv_diag,
                               omega=OMEGA, with_dot=True, **kw)
    _close(y, y_ref)
    _dot_close(d, d_ref)
    _close(stencil_fused_apply("residual", tl.data, torch.as_tensor(x),
                               tl.plan.offsets, **kw), res_ref)


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("epilogue,with_dot", [("matvec", False),
                                               ("residual", False),
                                               ("smooth", False),
                                               ("smooth", True)])
def test_const_epilogues_match_jax(n, epilogue, with_dot):
    jl, tl = _const(n)
    x, r = _rand(jl, 7), _rand(jl, 8)
    jx, jr = jnp.asarray(x), jnp.asarray(r)
    ref = {"matvec": lambda: jmg._const_matvec_xla(jl.weights, jl.code,
                                                   jl.plan.offsets, jx),
           "residual": lambda: jmg._residual(jl, jr, jx, False),
           "smooth": lambda: jmg._smooth(jl, jr, jx, OMEGA, False)}[
               epilogue]()
    out = const_stencil_apply(
        epilogue, tl.weights, tl.code, torch.as_tensor(x), tl.plan.offsets,
        b=None if epilogue == "matvec" else torch.as_tensor(r), omega=OMEGA,
        with_dot=with_dot)
    if with_dot:
        out, d = out
        _dot_close(d, jnp.vdot(jr, ref))
    _close(out, ref)


def test_const_sweep_dot_matches_pallas_kernel():
    jl, tl = _const(4)
    x, r = _rand(jl, 9), _rand(jl, 10)
    y_ref, d_ref = jsp.const_smooth_dot_embedded(
        jl.weights, jl.code, jnp.asarray(r), jnp.asarray(x), jl.plan,
        omega=OMEGA, block_lead=2, interpret=True)
    y, d = const_stencil_apply("smooth", tl.weights, tl.code,
                               torch.as_tensor(x), tl.plan.offsets,
                               b=torch.as_tensor(r), omega=OMEGA,
                               with_dot=True)
    _close(y, y_ref)
    _dot_close(d, d_ref)


@pytest.mark.parametrize("epilogue", ["matvec", "residual", "smooth"])
def test_const_result_independent_of_code_type(epilogue):
    """After cast_hierarchy the code plane is bf16; the rows it selects,
    and so every result, stay the same."""
    _, tl = _const(8)
    x = torch.as_tensor(_rand(tl, 11, np.float32))
    b = None if epilogue == "matvec" else torch.as_tensor(
        _rand(tl, 12, np.float32))
    args = (tl.weights, tl.code.float(), x, tl.plan.offsets)
    ref = const_stencil_apply_plain(epilogue, *args, b=b)
    out = const_stencil_apply_plain(epilogue, tl.weights,
                                    tl.code.to(torch.bfloat16), x,
                                    tl.plan.offsets, b=b)
    assert out.dtype == torch.float32
    assert torch.equal(out, ref)


def test_stencil_matrix_matvec_goes_through_the_kernel_wrapper(monkeypatch):
    """StencilMatrix.matvec dispatches through ops.stencil_cuda: K2 for a
    CUDA tensor, the plain version for a CPU one."""
    _, tl = _general(4)
    calls = []
    real = stencil_cuda.stencil_apply

    def spy(data, x, offsets, **kw):
        calls.append(x.device.type)
        return real(data, x, offsets, **kw)

    monkeypatch.setattr(stencil_cuda, "stencil_apply", spy)
    A = StencilMatrix(tl.data, tl.plan.offsets)
    x = torch.as_tensor(_rand(tl, 13))
    y = A @ x
    assert calls == ["cpu"]
    np.testing.assert_array_equal(
        y.numpy(), stencil_cuda.stencil_apply_plain(tl.data, x,
                                                    tl.plan.offsets).numpy())
    assert A.shape == (tl.plan.num_store_rows,) * 2
    assert A.dtype == torch.float64
    assert torch.equal(A.diagonal(), tl.data[tl.plan.offsets.index(0)])


def test_cpu_tensors_launch_no_kernel():
    jl, tl = _general(4)
    _, cl = _const(4)
    x, r = torch.as_tensor(_rand(jl, 14)), torch.as_tensor(_rand(jl, 15))
    stencil_fused_apply("smooth", tl.data, x, tl.plan.offsets, b=r,
                        inv_diag=tl.inv_diag, with_dot=True)
    const_stencil_apply("smooth", cl.weights, cl.code, x, cl.plan.offsets,
                        b=r, with_dot=True)
    assert stencil_cuda.stencil_fused_apply.launches == 0
    assert stencil_cuda.const_stencil_apply.launches == 0
