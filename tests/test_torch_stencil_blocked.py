"""Port parity, the route to the blocked stencil kernels B3 (general
coefficients: matvec, matvec + dot, residual, sweep, sweep + dot) and B5b
(const weights: matvec, residual, sweep, sweep + dot): the port's copy of
the reference's ``_needs_2d`` rule against the JAX package's over the store
grids of the large 3D sizes, and, with the threshold forced to 0, every
routed wrapper against the JAX package's blocked Pallas kernels in
interpret mode; float64 at 1e-12 on the CPU."""
import functools

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from tpufem.ops import stencil_pallas as jsp
from tpufem.solve import multigrid as jmg

from tpufem_torch.assemble.structured import structured_plan
from tpufem_torch.convert import const_level_from_numpy, level_from_numpy
from tpufem_torch.ops import stencil_cuda as sc
from tpufem_torch.solve.multigrid import _light_grid

# several pytest workers share the CPU: one intra-op thread each keeps
# the many small tensor ops from oversubscribing it
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """One BLAS thread a test, as one torch thread: numpy's OpenBLAS
    threads spin against the other workers on the shared CPU (a 729 x 729
    inverse takes seconds on eight, 0.07 s on one)."""
    with threadpool_limits(1, user_api="blas"):
        yield

OMEGA = 0.8
N_ROUTED = 16
# the blocked wrappers themselves (the fixture below spies on the names)
B3, B5B = sc.stencil_blocked_apply, sc.const_stencil_blocked_apply


def _store_grid(n, dim=3):
    return tuple(structured_plan(_light_grid((-3.0, 3.0), n, dim,
                                             with_coords=False)[0],
                                 embed=True).store_grid)


@pytest.mark.parametrize("n", [96, 224, 320, 352, 384])
def test_needs_2d_matches_jax(n):
    sg = _store_grid(n)
    for width in (15, 3):
        for n_extras in (0, 1, 2):
            for dtype_bytes in (2, 4, 8):
                args = (sg, width, n_extras, dtype_bytes)
                assert sc._needs_2d(*args) == jsp._needs_2d(*args), args
    assert sc._VMEM_1D_LIMIT == jsp._VMEM_1D_LIMIT
    # the scale size routes every fp32 call, the main-path size none
    assert sc._needs_2d(_store_grid(384), 3, 0, 4)
    assert not sc._needs_2d(_store_grid(96), 15, 2, 4)
    # 2D store grids never route
    assert not sc._needs_2d(_store_grid(1024, 2), 7, 2, 8)


def test_grid_steps_are_the_plan_offsets():
    plan = structured_plan(_light_grid((-3.0, 3.0), 8, 3,
                                       with_coords=False)[0], embed=True)
    steps = sc._grid_steps(plan.offsets, tuple(plan.store_grid))
    assert np.array_equal(np.reshape(steps, (-1, 3)),
                          np.asarray(plan.offsets_grid))
    with pytest.raises(ValueError):
        sc._grid_steps((2 * plan.store_grid[2],), tuple(plan.store_grid))


def _meta(l):
    return dict(node_grid=l.plan.info.node_grid,
                cell_grid=l.plan.info.cell_grid,
                type_node_offsets=np.asarray(l.plan.info.type_node_offsets),
                store_grid=l.plan.store_grid, offsets=l.plan.offsets)


@functools.lru_cache(maxsize=None)
def _levels():
    """(JAX general level, port copy, JAX const level, port copy)."""
    jg = jmg.build_poisson_multigrid((-3.0, 3.0), N_ROUTED, 3,
                                     dtype=jnp.float64, coarse_max=4,
                                     use_pallas=False)[0]
    tg = level_from_numpy(**_meta(jg), data=np.asarray(jg.data),
                          inv_diag=np.asarray(jg.inv_diag),
                          bc_mask=np.asarray(jg.bc_mask))
    jc = jmg.build_poisson_multigrid((-3.0, 3.0), N_ROUTED, 3,
                                     dtype=jnp.float64, coarse_max=4,
                                     use_pallas=False, operator="const")[0]
    tc = const_level_from_numpy(**_meta(jc), weights=jc.weights,
                                code=np.asarray(jc.code))
    return jg, tg, jc, tc


def _rand(n_rows, node, seed):
    rng = np.random.default_rng(seed)
    return np.where(node, rng.standard_normal(n_rows), 0.0)


@pytest.fixture
def routed(monkeypatch):
    """Threshold 0 on both sides, and a record of the blocked wrappers the
    port's routed wrappers call."""
    monkeypatch.setattr(jsp, "_VMEM_1D_LIMIT", 0)
    monkeypatch.setattr(sc, "_VMEM_1D_LIMIT", 0)
    calls = []
    for name in ("stencil_blocked_apply", "const_stencil_blocked_apply"):
        real = getattr(sc, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls.append((_name, args[0]))
            return _real(*args, **kw)

        monkeypatch.setattr(sc, name, spy)
    return calls


def _close(a, ref, rtol=1e-12):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(a, np.float64), ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1.0))


def _dot_close(d, ref, rtol=1e-12):
    assert abs(float(d) - float(ref)) <= rtol * max(abs(float(ref)), 1.0)


@pytest.mark.parametrize("epilogue", ["matvec", "matvec_dot", "residual",
                                      "smooth", "smooth_dot"])
def test_routed_general_wrappers_match_jax_blocked(routed, epilogue):
    jg, tg, _, _ = _levels()
    node = np.asarray(jg.data[jg.plan.offsets.index(0)]) != 0
    x, r = (_rand(tg.plan.num_store_rows, node, s) for s in (1, 2))
    jd, jx, jr = jnp.asarray(jg.data), jnp.asarray(x), jnp.asarray(r)
    jinv = jnp.asarray(jg.inv_diag)
    tx, tr = torch.as_tensor(x), torch.as_tensor(r)
    kw = dict(interpret=True)
    if epilogue == "matvec":
        ref = jsp.stencil_matvec_embedded(jd, jx, jg.plan, **kw)
        out = sc.stencil_matvec_embedded(tg.data, tx, tg.plan)
    elif epilogue == "matvec_dot":
        ref = jsp.stencil_matvec_dot_embedded(jd, jx, jg.plan, **kw)
        out = sc.stencil_matvec_dot_embedded(tg.data, tx, tg.plan)
    elif epilogue == "residual":
        ref = jsp.stencil_residual_embedded(jd, jr, jx, jg.plan, **kw)
        out = sc.stencil_residual_embedded(tg.data, tr, tx, tg.plan)
    elif epilogue == "smooth":
        ref = jsp.stencil_smooth_embedded(jd, jr, jx, jinv, jg.plan,
                                          omega=OMEGA, **kw)
        out = sc.stencil_smooth_embedded(tg.data, tr, tx, tg.inv_diag,
                                         tg.plan, omega=OMEGA)
    else:
        ref = jsp.stencil_smooth_dot_embedded(jd, jr, jx, jinv, jg.plan,
                                              omega=OMEGA, **kw)
        out = sc.stencil_smooth_dot_embedded(tg.data, tr, tx, tg.inv_diag,
                                             tg.plan, omega=OMEGA)
    if epilogue.endswith("dot"):
        (out, d), (ref, d_ref) = out, ref
        _dot_close(d, d_ref)
    _close(out, ref)
    assert routed == [("stencil_blocked_apply", epilogue.split("_")[0])]
    assert B3.launches == 0


@pytest.mark.parametrize("epilogue", ["matvec", "residual", "smooth",
                                      "smooth_dot"])
def test_routed_const_wrappers_match_jax_blocked(routed, epilogue):
    _, _, jc, tc = _levels()
    node = np.asarray(jc.code) != 0
    x, r = (_rand(tc.plan.num_store_rows, node, s) for s in (3, 4))
    jcode, jx, jr = jnp.asarray(jc.code), jnp.asarray(x), jnp.asarray(r)
    tx, tr = torch.as_tensor(x), torch.as_tensor(r)
    w = jc.weights
    kw = dict(interpret=True)
    if epilogue == "matvec":
        ref = jsp.const_matvec_embedded(w, jcode, jx, jc.plan, **kw)
        out = sc.const_matvec_embedded(tc.weights, tc.code, tx, tc.plan)
    elif epilogue == "residual":
        ref = jsp.const_residual_embedded(w, jcode, jr, jx, jc.plan, **kw)
        out = sc.const_residual_embedded(tc.weights, tc.code, tr, tx,
                                         tc.plan)
    elif epilogue == "smooth":
        ref = jsp.const_smooth_embedded(w, jcode, jr, jx, jc.plan,
                                        omega=OMEGA, **kw)
        out = sc.const_smooth_embedded(tc.weights, tc.code, tr, tx, tc.plan,
                                       omega=OMEGA)
    else:
        ref = jsp.const_smooth_dot_embedded(w, jcode, jr, jx, jc.plan,
                                            omega=OMEGA, **kw)
        out = sc.const_smooth_dot_embedded(tc.weights, tc.code, tr, tx,
                                           tc.plan, omega=OMEGA)
    if epilogue == "smooth_dot":
        (out, d), (ref, d_ref) = out, ref
        _dot_close(d, d_ref)
    _close(out, ref)
    assert routed == [("const_stencil_blocked_apply",
                       epilogue.split("_")[0])]
    assert B5B.launches == 0


def test_unrouted_wrappers_stay_flat(monkeypatch):
    """Under the reference's threshold the n=16 grid runs the flat path."""
    calls = []
    monkeypatch.setattr(sc, "stencil_blocked_apply",
                        lambda *a, **k: calls.append(a))
    _, tg, _, tc = _levels()
    x = torch.ones(tg.plan.num_store_rows, dtype=torch.float64)
    sc.stencil_matvec_embedded(tg.data, x, tg.plan)
    sc.const_matvec_embedded(tc.weights, tc.code, x, tc.plan)
    assert calls == []
