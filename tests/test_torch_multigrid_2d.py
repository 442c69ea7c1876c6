"""Port parity, multigrid on the 2D box: the 7-point transfers, both 2D
hierarchies (const: 7 weights and the code plane; general: the assembled
planes), their coarse inverses, the V-cycle, the K = 7 instantiation of
kernel B5 (const matvec, residual, sweep, sweep + dot) and the 2D
hierarchies carried across with tpufem_torch.convert: tpufem_torch against
the JAX package's XLA forms (``use_pallas=False``) and, on a tiny grid, the
Pallas kernels in interpret mode; float64 at 1e-12, on the CPU."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpufem.ops import stencil_pallas as jsp
from tpufem.solve import multigrid as jmg

from tpufem_torch.convert import (const_hierarchy_from_numpy,
                                  hierarchy_from_numpy)
from tpufem_torch.ops import stencil_cuda
from tpufem_torch.ops.stencil_cuda import const_stencil_apply
from tpufem_torch.solve import multigrid as tmg

# several pytest workers share the CPU: one intra-op thread each keeps
# the many small tensor ops from oversubscribing it
torch.set_num_threads(1)

DOMAIN = (-3.0, 3.0)
OMEGA = 0.8


def _meta(l):
    return dict(node_grid=l.plan.info.node_grid,
                cell_grid=l.plan.info.cell_grid,
                type_node_offsets=np.asarray(l.plan.info.type_node_offsets),
                store_grid=l.plan.store_grid, offsets=l.plan.offsets)


def _np(a):
    return None if a is None else np.asarray(a, np.float64)


def _jax_levels(n, operator, **kw):
    return jmg.build_poisson_multigrid(DOMAIN, n, 2, dtype=jnp.float64,
                                       use_pallas=False, operator=operator,
                                       **kw)


def _port_levels(n, operator, **kw):
    return tmg.build_poisson_multigrid(DOMAIN, n, 2, dtype=torch.float64,
                                       operator=operator, device="cpu", **kw)


def _rand(level, seed):
    rng = np.random.default_rng(seed)
    if hasattr(level, "code"):
        node = np.asarray(level.code) != 0
    else:
        node = np.asarray(level.data[level.plan.offsets.index(0)]) != 0
    return np.where(node, rng.standard_normal(level.plan.num_store_rows),
                    0.0)


def _close(a, ref, rtol=1e-12):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(a, np.float64), ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1.0))


@pytest.mark.parametrize("n", [4, 7])
def test_2d_transfers_match_jax(n):
    """prolong (coarse [n+1]^2 -> fine [2n+1]^2) and restrict = P^T."""
    rng = np.random.default_rng(n)
    xc = rng.standard_normal((n + 1, n + 1))
    rf = rng.standard_normal((2 * n + 1, 2 * n + 1))
    _close(tmg.prolong(torch.as_tensor(xc), 2),
           jmg.prolong(jnp.asarray(xc), 2))
    _close(tmg.restrict(torch.as_tensor(rf), 2),
           jmg.restrict(jnp.asarray(rf), 2))
    # the adjoint pair: <P xc, rf> = <xc, R rf>
    lhs = float((tmg.prolong(torch.as_tensor(xc), 2)
                 * torch.as_tensor(rf)).sum())
    rhs = float((torch.as_tensor(xc)
                 * tmg.restrict(torch.as_tensor(rf), 2)).sum())
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)
    with pytest.raises(ValueError):
        tmg.prolong(torch.as_tensor(xc), 3)


@pytest.mark.parametrize("n", [16, 24])
def test_2d_const_hierarchy_matches_jax(n):
    jl, tl = _jax_levels(n, "const"), _port_levels(n, "const")
    assert len(tl) == len(jl) >= 2
    for a, b in zip(tl, jl):
        assert isinstance(a, tmg.ConstMGLevel)
        assert a.plan.offsets == tuple(b.plan.offsets)
        assert tuple(a.plan.store_grid) == tuple(b.plan.store_grid)
        assert len(a.weights) == 7
        np.testing.assert_allclose(a.weights, b.weights, rtol=1e-14,
                                   atol=1e-14)
        np.testing.assert_array_equal(a.code.numpy(), np.asarray(b.code))
    _close(tl[-1].coarse_inverse.numpy(), jl[-1].coarse_inverse)


@pytest.mark.parametrize("n", [16, 24])
def test_2d_general_hierarchy_matches_jax(n):
    jl, tl = _jax_levels(n, "general"), _port_levels(n, "general")
    assert len(tl) == len(jl) >= 2
    for a, b in zip(tl, jl):
        assert isinstance(a, tmg.MGLevel) and a.data.shape[0] == 7
        _close(a.data.numpy(), b.data)
        _close(a.inv_diag.numpy(), b.inv_diag)
        np.testing.assert_array_equal(a.bc_mask.numpy(),
                                      np.asarray(b.bc_mask))
    _close(tl[-1].coarse_inverse.numpy(), jl[-1].coarse_inverse)


def test_2d_hierarchies_carry_across():
    """tpufem_torch.convert takes the JAX package's 2D levels (7 weights,
    2D code planes, 2D general levels) to the port's own build."""
    jc, tc = _jax_levels(16, "const"), _port_levels(16, "const")
    cc = const_hierarchy_from_numpy(
        [dict(**_meta(l), weights=l.weights, code=np.asarray(l.code),
              coarse_inverse=_np(l.coarse_inverse)) for l in jc])
    for a, b in zip(cc, tc):
        assert a.plan.store_grid == b.plan.store_grid and a.weights == \
            pytest.approx(b.weights, rel=1e-14, abs=1e-14)
        assert torch.equal(a.code, b.code)
    _close(cc[-1].coarse_inverse, tc[-1].coarse_inverse)
    jg, tg = _jax_levels(16, "general"), _port_levels(16, "general")
    gc = hierarchy_from_numpy(
        [dict(**_meta(l), data=_np(l.data), inv_diag=_np(l.inv_diag),
              bc_mask=np.asarray(l.bc_mask),
              coarse_inverse=_np(l.coarse_inverse)) for l in jg])
    for a, b in zip(gc, tg):
        _close(a.data, b.data)
        assert torch.equal(a.bc_mask, b.bc_mask)


@pytest.mark.parametrize("operator", ["const", "general"])
@pytest.mark.parametrize("nu", [(1, 1), (2, 2)])
@pytest.mark.parametrize("final_dot", [False, True])
def test_2d_v_cycle_matches_jax(operator, nu, final_dot):
    """Through the kernel wrappers (their plain versions on the CPU); the
    2D transfers stay unfused, as in the reference."""
    jl, tl = _jax_levels(16, operator), _port_levels(16, operator)
    r = _rand(jl[0], 1)
    kw = dict(nu1=nu[0], nu2=nu[1], final_dot=final_dot)
    ref = jmg.v_cycle(jl, jnp.asarray(r), use_pallas=False, **kw)
    out = tmg.v_cycle(tl, torch.as_tensor(r), **kw)
    if final_dot:
        (out, d), (ref, d_ref) = out, ref
        assert abs(float(d) - float(d_ref)) <= 1e-12 * max(
            abs(float(d_ref)), 1.0)
    _close(out, ref)
    assert not tmg._can_fuse_transfers(tl, 0, 1, True, True)


@pytest.mark.parametrize("epilogue,with_dot", [("matvec", False),
                                               ("residual", False),
                                               ("smooth", False),
                                               ("smooth", True)])
def test_b5_k7_epilogues_match_jax(epilogue, with_dot):
    jl = _jax_levels(16, "const")[0]
    tl = _port_levels(16, "const")[0]
    assert len(tl.plan.offsets) == 7
    x, r = _rand(jl, 2), _rand(jl, 3)
    jx, jr = jnp.asarray(x), jnp.asarray(r)
    if epilogue == "matvec":
        ref = jmg._matvec(jl, jx, False)
    elif epilogue == "residual":
        ref = jmg._residual(jl, jr, jx, False)
    else:
        ref = jmg._smooth(jl, jr, jx, OMEGA, False)
    kw = {} if epilogue == "matvec" else dict(b=torch.as_tensor(r))
    out = const_stencil_apply(epilogue, tl.weights, tl.code,
                              torch.as_tensor(x), tl.plan.offsets,
                              omega=OMEGA, with_dot=with_dot, **kw)
    if with_dot:
        out, d = out
        ref_d = float(jnp.vdot(jr, ref))
        assert abs(float(d) - ref_d) <= 1e-12 * max(abs(ref_d), 1.0)
    _close(out, ref)
    assert stencil_cuda.const_stencil_apply.launches == 0


def test_b5_k7_sweep_dot_matches_pallas_kernel():
    """Against the replaced TPU kernel itself on a 2D store grid, in
    interpret mode (tiny grid: interpret mode is slow on the CPU)."""
    jl = _jax_levels(4, "const", coarse_max=2)[0]
    tl = _port_levels(4, "const", coarse_max=2)[0]
    x, r = _rand(jl, 4), _rand(jl, 5)
    y_ref, d_ref = jsp.const_smooth_dot_embedded(
        jl.weights, jnp.asarray(jl.code), jnp.asarray(r), jnp.asarray(x),
        jl.plan, omega=OMEGA, interpret=True)
    y, d = const_stencil_apply("smooth", tl.weights, tl.code,
                               torch.as_tensor(x), tl.plan.offsets,
                               b=torch.as_tensor(r), omega=OMEGA,
                               with_dot=True)
    _close(y, y_ref)
    assert abs(float(d) - float(d_ref)) <= 1e-12 * max(abs(float(d_ref)), 1)
