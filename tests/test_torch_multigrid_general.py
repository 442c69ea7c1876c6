"""Port parity, multigrid beyond the main path: the general-coefficient
hierarchy and V-cycle (any nu1/nu2, final_dot), the const V-cycle unfused
and with nu > 1, the coarsest-level Jacobi fallback, cast_hierarchy in
bf16, and the reference's defaults (nu1 = nu2 = 2, operator="general"):
tpufem_torch.solve.multigrid against the JAX package's XLA forms
(``use_pallas=False``) on hierarchies carried across with
tpufem_torch.convert; float64 at 1e-12 unless noted, on the CPU."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpufem.solve import multigrid as jmg

from tpufem_torch.convert import (const_hierarchy_from_numpy,
                                  hierarchy_from_numpy)
from tpufem_torch.ops import mg_transfer_cuda, stencil_cuda
from tpufem_torch.solve import multigrid as tmg
from tpufem_torch.solve.cg import cg
from tpufem_torch.sparse.stencil import stencil_matvec

# several pytest workers share the CPU: one intra-op thread each keeps
# the many small tensor ops from oversubscribing it
torch.set_num_threads(1)

DOMAIN = (-3.0, 3.0)


def _meta(l):
    return dict(node_grid=l.plan.info.node_grid,
                cell_grid=l.plan.info.cell_grid,
                type_node_offsets=np.asarray(l.plan.info.type_node_offsets),
                store_grid=l.plan.store_grid, offsets=l.plan.offsets)


def _np(a, dtype=np.float64):
    """A JAX array (bf16 included) as numpy in ``dtype``."""
    return None if a is None else np.asarray(jnp.asarray(a, dtype))


def _general_dicts(levels, dtype=np.float64):
    return [dict(**_meta(l), data=_np(l.data, dtype),
                 inv_diag=_np(l.inv_diag, dtype),
                 bc_mask=np.asarray(l.bc_mask),
                 coarse_inverse=_np(l.coarse_inverse, dtype))
            for l in levels]


def _const_dicts(levels):
    return [dict(**_meta(l), weights=l.weights, code=np.asarray(l.code),
                 coarse_inverse=_np(l.coarse_inverse)) for l in levels]


def _jax_levels(n, operator, dtype=jnp.float64):
    return jmg.build_poisson_multigrid(DOMAIN, n, 3, dtype=dtype,
                                       coarse_max=4, use_pallas=False,
                                       operator=operator)


@pytest.fixture(scope="module", params=[8, 12])
def general(request):
    jl = _jax_levels(request.param, "general")
    return jl, hierarchy_from_numpy(_general_dicts(jl))


@pytest.fixture(scope="module")
def const():
    jl = _jax_levels(12, "const")
    return jl, const_hierarchy_from_numpy(_const_dicts(jl))


def _rand(level, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    if isinstance(level, (jmg.ConstMGLevel, tmg.ConstMGLevel)):
        node = np.asarray(level.code) != 0
    else:
        node = np.asarray(level.data[level.plan.offsets.index(0)]) != 0
    return np.where(node, rng.standard_normal(level.plan.num_store_rows),
                    0.0).astype(dtype)


def _close(a, ref, rtol=1e-12):
    ref = np.asarray(jnp.asarray(ref, jnp.float64))
    np.testing.assert_allclose(np.asarray(a, np.float64), ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1.0))


def _cycle_pair(jl, tl, r, rtol=1e-12, dot_rtol=None, **kw):
    ref = jmg.v_cycle(jl, jnp.asarray(r), **dict(
        {k: v for k, v in kw.items() if k != "fuse_transfers"},
        use_pallas=False))
    out = tmg.v_cycle(tl, torch.as_tensor(r), **kw)
    if kw.get("final_dot"):
        (out, d), (ref, d_ref) = out, ref
        assert abs(float(d) - float(d_ref)) <= (dot_rtol or rtol) * max(
            abs(float(d_ref)), 1.0)
    _close(out, ref, rtol)


def test_general_hierarchy_matches_jax():
    jl = _jax_levels(8, "general")
    tl = tmg.build_poisson_multigrid(DOMAIN, 8, dtype=torch.float64,
                                     coarse_max=4, device="cpu")
    assert len(tl) == len(jl) == 2
    for a, b in zip(tl, jl):
        assert isinstance(a, tmg.MGLevel)
        np.testing.assert_array_equal(a.data.numpy(), np.asarray(b.data))
        np.testing.assert_array_equal(a.inv_diag.numpy(),
                                      np.asarray(b.inv_diag))
        np.testing.assert_array_equal(a.bc_mask.numpy(),
                                      np.asarray(b.bc_mask))
    np.testing.assert_allclose(tl[-1].coarse_inverse.numpy(),
                               np.asarray(jl[-1].coarse_inverse),
                               rtol=1e-12, atol=1e-14)


def test_top_level_shares_the_operator():
    jl = _jax_levels(8, "general")
    data = torch.as_tensor(np.array(jl[0].data))
    bc = torch.as_tensor(np.array(jl[0].bc_mask))
    tl = tmg.build_poisson_multigrid(DOMAIN, 8, dtype=torch.float64,
                                     coarse_max=4, top=(data, bc),
                                     device="cpu")
    assert tl[0].data is data
    np.testing.assert_array_equal(tl[0].inv_diag.numpy(),
                                  np.asarray(jl[0].inv_diag))
    with pytest.raises(ValueError):
        tmg.build_poisson_multigrid(DOMAIN, 8, operator="const",
                                    top=(data, bc))


@pytest.mark.parametrize("nu", [(1, 1), (2, 2)])
@pytest.mark.parametrize("final_dot", [False, True])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_general_v_cycle_matches_jax(general, nu, final_dot, use_pallas):
    """Through the kernel wrappers (their plain versions on the CPU) and
    through the plain level operators."""
    jl, tl = general
    _cycle_pair(jl, tl, _rand(jl[0], 1), nu1=nu[0], nu2=nu[1],
                final_dot=final_dot, use_pallas=use_pallas)


@pytest.mark.parametrize("fuse_transfers", [False, True])
@pytest.mark.parametrize("nu", [(1, 1), (2, 2), (1, 3)])
@pytest.mark.parametrize("final_dot", [False, True])
def test_const_v_cycle_matches_jax(const, fuse_transfers, nu, final_dot):
    """Unfused (residual, restrict, prolong and sweeps one by one) and
    fused (K3/K4 plus B5 sweeps), against the reference's unfused XLA
    cycle."""
    jl, tl = const
    _cycle_pair(jl, tl, _rand(jl[0], 2), nu1=nu[0], nu2=nu[1],
                final_dot=final_dot, fuse_transfers=fuse_transfers)


@pytest.mark.parametrize("operator", ["general", "const"])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_jacobi_coarsest_matches_jax(operator, use_pallas):
    """A coarsest level without a dense inverse gets 20 damped Jacobi
    sweeps, on both level types."""
    jl = _jax_levels(8, operator)
    jl[-1].coarse_inverse = None
    dicts = (_general_dicts if operator == "general" else _const_dicts)(jl)
    tl = (hierarchy_from_numpy if operator == "general"
          else const_hierarchy_from_numpy)(dicts)
    assert tl[-1].coarse_inverse is None
    _cycle_pair(jl, tl, _rand(jl[0], 3), nu1=1, nu2=1, use_pallas=use_pallas)
    _cycle_pair(jl[-1:], tl[-1:], _rand(jl[-1], 4), nu1=1, nu2=1,
                use_pallas=use_pallas)


@pytest.mark.parametrize("operator", ["general", "const"])
def test_large_coarsest_level_falls_back_to_jacobi(monkeypatch, operator):
    """Past the dense-inverse limit the hierarchy keeps no inverse and the
    preconditioner still converges PCG (the reference's fallback; for
    const levels it needs the B5 sweep)."""
    # n=16 with 2 levels: the coarsest has 9^3 = 729 nodes
    monkeypatch.setattr(tmg, "_DENSE_COARSE_MAX", 100)
    tl = tmg.build_poisson_multigrid(DOMAIN, 16, dtype=torch.float64,
                                     levels=2, operator=operator,
                                     device="cpu")
    assert len(tl) == 2 and tl[-1].coarse_inverse is None
    top = tmg.build_poisson_multigrid(DOMAIN, 16, dtype=torch.float64,
                                      levels=1, device="cpu")[0]
    b = torch.as_tensor(_rand(top, 5))
    res = cg(lambda v: stencil_matvec(top.data, top.plan.offsets, v), b,
             tol=1e-8, maxiter=100,
             M=tmg.mg_preconditioner(tl, nu1=1, nu2=1),
             M_dot=tmg.mg_preconditioner(tl, nu1=1, nu2=1, with_dot=True))
    assert res.converged and res.iterations <= 30


def test_cast_hierarchy_bf16_matches_jax():
    j32 = _jax_levels(8, "general", jnp.float32)
    jl = jmg.cast_hierarchy(j32, jnp.bfloat16)
    tl32 = hierarchy_from_numpy(_general_dicts(j32, np.float32),
                                dtype=torch.float32)
    data0 = tl32[0].data.clone()
    tl = tmg.cast_hierarchy(tl32, torch.bfloat16)
    # the cast copies: the fp32 levels (and an operator they share) stay
    assert torch.equal(tl32[0].data, data0) and tl[0].data is not tl32[0].data
    # the reference's own cast, carried across (bf16 arrives as fp32 numpy)
    tj = hierarchy_from_numpy(_general_dicts(jl, np.float32),
                              dtype=torch.bfloat16)
    for a, b in zip(tl, tj):
        assert a.data.dtype == a.inv_diag.dtype == torch.bfloat16
        assert torch.equal(a.data, b.data)
        assert torch.equal(a.inv_diag, b.inv_diag)
    assert tl[-1].coarse_inverse.dtype == torch.float32
    assert tj[-1].coarse_inverse.dtype == torch.float32
    r = _rand(jl[0], 6, np.float32)
    # fp32 vectors; the dot sums 3e4 fp32 terms in another order
    _cycle_pair(jl, tl, r, rtol=1e-6, dot_rtol=1e-4, nu1=1, nu2=1,
                final_dot=True)
    # and a const hierarchy's code plane casts too
    cl = tmg.cast_hierarchy(tmg.build_poisson_multigrid(
        DOMAIN, 8, coarse_max=4, operator="const", device="cpu"),
        torch.bfloat16)
    assert all(l.code.dtype == torch.bfloat16 for l in cl)


def test_repaired_defaults_match_jax():
    """The reference's defaults: operator="general" and nu1 = nu2 = 2."""
    tl = tmg.build_poisson_multigrid(DOMAIN, 8, dtype=torch.float64,
                                     coarse_max=4, device="cpu")
    assert all(isinstance(l, tmg.MGLevel) for l in tl)
    jl = _jax_levels(8, "general")
    r = _rand(jl[0], 7)
    z_ref = jmg.mg_preconditioner(jl, use_pallas=False)(jnp.asarray(r))
    _close(tmg.mg_preconditioner(tl)(torch.as_tensor(r)), z_ref)
    z_ref, d_ref = jmg.mg_preconditioner(jl, use_pallas=False,
                                         with_dot=True)(jnp.asarray(r))
    z, d = tmg.mg_preconditioner(tl, with_dot=True)(torch.as_tensor(r))
    _close(z, z_ref)
    assert abs(float(d) - float(d_ref)) <= 1e-12 * abs(float(d_ref))


def test_final_dot_needs_the_top_level_and_a_post_sweep(general):
    _, tl = general
    r = torch.as_tensor(_rand(tl[0], 8))
    for kw in (dict(nu2=0), dict(li=1)):
        with pytest.raises(ValueError):
            tmg.v_cycle(tl, r if "li" not in kw else r[:0], final_dot=True,
                        **kw)


def test_cpu_cycles_launch_no_kernel(general, const):
    for jl, tl in (general, const):
        tmg.mg_preconditioner(tl, with_dot=True)(
            torch.as_tensor(_rand(jl[0], 9)))
    assert stencil_cuda.stencil_fused_apply.launches == 0
    assert stencil_cuda.const_stencil_apply.launches == 0
    assert mg_transfer_cuda.const_residual_restrict_embedded.launches == 0
    assert mg_transfer_cuda.const_prolong_add_smooth_embedded.launches == 0
