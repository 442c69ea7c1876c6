"""Port parity, kernels K3 (residual + restrict) and K4 (prolong + add +
smooth, optionally with <r, y>), and the V-cycle built on them: the port's
plain versions against the JAX package's unfused compositions — the
recipe of test_mg_transfer_fused.py, which pins the Pallas kernels to
them — on a hierarchy carried across with tpufem_torch.convert; float64
on the CPU."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpufem.solve.multigrid import (_const_matvec_xla, _grid, _smooth,
                                    _store, build_poisson_multigrid,
                                    mg_preconditioner as jax_mg, prolong,
                                    restrict, v_cycle as jax_v_cycle)

from tpufem_torch.convert import const_hierarchy_from_numpy
from tpufem_torch.ops import mg_transfer_cuda
from tpufem_torch.ops.mg_transfer_cuda import (
    const_prolong_add_smooth_embedded, const_residual_restrict_embedded)
from tpufem_torch.solve.multigrid import mg_preconditioner, v_cycle

# several pytest workers share the CPU: one intra-op thread each keeps
# the many small tensor ops from oversubscribing it
torch.set_num_threads(1)


def _as_dicts(levels):
    return [dict(node_grid=l.plan.info.node_grid,
                 cell_grid=l.plan.info.cell_grid,
                 type_node_offsets=np.asarray(l.plan.info.type_node_offsets),
                 store_grid=l.plan.store_grid, offsets=l.plan.offsets,
                 weights=l.weights, code=np.asarray(l.code),
                 coarse_inverse=(None if l.coarse_inverse is None
                                 else np.asarray(l.coarse_inverse)))
            for l in levels]


@pytest.fixture(scope="module", params=[8, 12])
def hier(request):
    jl = build_poisson_multigrid((-3.0, 3.0), request.param, 3,
                                 dtype=jnp.float64, coarse_max=4,
                                 use_pallas=False, operator="const")
    return jl, const_hierarchy_from_numpy(_as_dicts(jl))


def _rand(level, seed):
    """Random embedded vector: zero at border/padding positions."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(level.plan.num_store_rows)
    return np.where(np.asarray(level.code) != 0.0, v, 0.0)


def _close(a, ref):
    # float64, same operations composed in another order: 1e-12
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(a), ref, rtol=1e-12,
                               atol=1e-12 * max(np.abs(ref).max(), 1.0))


def test_residual_restrict_matches_jax(hier):
    (jf, jc), (tf, tc) = hier[0][:2], hier[1][:2]
    r, e = _rand(jf, 0), _rand(jf, 1)
    resid = jnp.asarray(r) - _const_matvec_xla(jf.weights, jf.code,
                                               jf.plan.offsets, jnp.asarray(e))
    rc_ref = jnp.where(jc.bc_mask, 0, _store(jc, restrict(_grid(jf, resid),
                                                          3)))
    rc = const_residual_restrict_embedded(tf.weights, tf.code, tc.code,
                                          torch.as_tensor(r),
                                          torch.as_tensor(e), tf.plan,
                                          tc.plan)
    _close(rc, rc_ref)


@pytest.mark.parametrize("with_dot", [False, True])
def test_prolong_add_smooth_matches_jax(hier, with_dot):
    (jf, jc), (tf, tc) = hier[0][:2], hier[1][:2]
    r, e, ec = _rand(jf, 2), _rand(jf, 3), _rand(jc, 4)
    e_ref = jnp.asarray(e) + _store(jf, prolong(_grid(jc, jnp.asarray(ec)),
                                                3))
    e_ref = _smooth(jf, jnp.asarray(r), e_ref, 0.8, use_pallas=False)
    out = const_prolong_add_smooth_embedded(
        tf.weights, tf.code, torch.as_tensor(ec), torch.as_tensor(r),
        torch.as_tensor(e), tf.plan, tc.plan, omega=0.8, with_dot=with_dot)
    if with_dot:
        out, d = out
        d_ref = float(jnp.vdot(jnp.asarray(r), e_ref))
        assert abs(float(d) - d_ref) <= 1e-12 * max(abs(d_ref), 1.0)
    _close(out, e_ref)


@pytest.mark.parametrize("final_dot", [False, True])
def test_v_cycle_matches_jax(hier, final_dot):
    jl, tl = hier
    r = _rand(jl[0], 8)
    ref = jax_v_cycle(jl, jnp.asarray(r), nu1=1, nu2=1, use_pallas=False,
                      final_dot=final_dot)
    out = v_cycle(tl, torch.as_tensor(r), final_dot=final_dot)
    if final_dot:
        (out, d), (ref, d_ref) = out, ref
        assert abs(float(d) - float(d_ref)) <= 1e-12 * max(abs(float(d_ref)),
                                                           1.0)
    _close(out, ref)


def test_preconditioner_matches_jax_and_launches_nothing(hier):
    jl, tl = hier
    r = _rand(jl[0], 9)
    z_ref = jax_mg(jl, nu1=1, nu2=1, use_pallas=False)(jnp.asarray(r))
    z = mg_preconditioner(tl)(torch.as_tensor(r))
    _close(z, z_ref)
    assert mg_transfer_cuda.const_residual_restrict_embedded.launches == 0
    assert mg_transfer_cuda.const_prolong_add_smooth_embedded.launches == 0
