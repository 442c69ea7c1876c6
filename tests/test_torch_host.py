"""Port parity, host layer: structured plans, quadrature, embedding, the
analytic const hierarchy and the model problem of tpufem_torch against the
JAX package (numpy/float64 on the CPU)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpufem.assemble.structured import structured_plan as jax_plan
from tpufem.fem.elements import P1Tetrahedron as JaxP1Tet
from tpufem.fem.quadrature import tetrahedron_rule as jax_rule
from tpufem.mesh.box import box_mesh
from tpufem.ops.fused_system_pallas import (
    node_coords_embedded_from_grid as jax_coords_emb)
from tpufem.solve import multigrid as jmg
from tpufem.solve.poisson import model_problem_3d as jax_mp3d
from tpufem.solve.poisson import model_problem_3d_planes as jax_mp3d_planes

from tpufem_torch.assemble.structured import structured_plan
from tpufem_torch.fem.elements import P1Tetrahedron
from tpufem_torch.fem.quadrature import tetrahedron_rule
from tpufem_torch.mesh.core import StructuredInfo
from tpufem_torch.ops.fused_system_cuda import node_coords_embedded_from_grid
from tpufem_torch.solve import multigrid as tmg
from tpufem_torch.solve.poisson import model_problem_3d, model_problem_3d_planes

# several pytest workers share the CPU: one intra-op thread each keeps
# the many small tensor ops from oversubscribing it
torch.set_num_threads(1)


def _infos(case):
    """(JAX StructuredInfo, port StructuredInfo) for a test case."""
    if case == "noncubic":
        jinfo = box_mesh(-3, 2, 0, 3, -2, 1, 5, 4, 6).structured
    else:
        jinfo, _, _ = jmg._light_grid((-3.0, 3.0), case, 3, with_coords=False)
    tinfo = StructuredInfo(node_grid=tuple(jinfo.node_grid),
                           cell_grid=tuple(jinfo.cell_grid),
                           type_node_offsets=np.asarray(
                               jinfo.type_node_offsets))
    return jinfo, tinfo


@pytest.mark.parametrize("case", [8, 12, 96, "noncubic"])
@pytest.mark.parametrize("embed", [True, False])
def test_structured_plan_matches_jax(case, embed):
    jinfo, tinfo = _infos(case)
    jp, tp = jax_plan(jinfo, embed=embed), structured_plan(tinfo, embed=embed)
    # integer metadata: exact equality
    assert tp.offsets == jp.offsets
    assert tp.offsets_grid == jp.offsets_grid
    assert tp.store_grid == tuple(jp.store_grid)
    np.testing.assert_array_equal(tp.entry_k, jp.entry_k)
    np.testing.assert_array_equal(tp.entry_shift, jp.entry_shift)


@pytest.mark.parametrize("n", [8, 12, 96])
def test_light_grid_matches_jax(n):
    jinfo, jc, jbc = jmg._light_grid((-3.0, 3.0), n, 3)
    tinfo, tc, tbc = tmg._light_grid((-3.0, 3.0), n, 3)
    assert tinfo.node_grid == jinfo.node_grid
    assert tinfo.cell_grid == jinfo.cell_grid
    np.testing.assert_array_equal(tinfo.type_node_offsets,
                                  jinfo.type_node_offsets)
    np.testing.assert_array_equal(tc, jc)       # same linspace: exact
    np.testing.assert_array_equal(tbc, jbc)


@pytest.mark.parametrize("degree", [1, 2, 3])
def test_tetrahedron_rule_and_shape_values_match_jax(degree):
    jr, tr = jax_rule(degree), tetrahedron_rule(degree)
    np.testing.assert_array_equal(tr.points, jr.points)
    np.testing.assert_array_equal(tr.weights, jr.weights)
    np.testing.assert_array_equal(P1Tetrahedron().shape_values(tr.points),
                                  JaxP1Tet().shape_values(jr.points))


@pytest.mark.parametrize("case", [12, "noncubic"])
def test_embed_extract_and_coords_match_jax(case):
    jinfo, tinfo = _infos(case)
    jp, tp = jax_plan(jinfo, embed=True), structured_plan(tinfo, embed=True)
    nn = int(np.prod(jinfo.node_grid))
    v = np.random.default_rng(0).standard_normal(nn)
    emb = tp.embed_field(torch.as_tensor(v))
    np.testing.assert_array_equal(emb.numpy(),
                                  np.asarray(jp.embed_field(jnp.asarray(v))))
    np.testing.assert_array_equal(tp.extract_field(emb).numpy(), v)
    # embedded node coordinates, including the synthetic padding ramp
    lo = np.array([-3.0, 0.0, -2.0])
    coords_grid = np.stack([lo[d] + np.arange(jinfo.node_grid[2 - d],
                                              dtype=np.float64)
                            .reshape([-1 if ax == 2 - d else 1
                                      for ax in range(3)])
                            * np.ones(jinfo.node_grid)
                            for d in range(3)])
    for dt in (np.float32, np.float64):
        np.testing.assert_array_equal(
            node_coords_embedded_from_grid(coords_grid, tp, dt),
            jax_coords_emb(coords_grid, jp, dt))


@pytest.mark.parametrize("n", [8, 12])
def test_const_hierarchy_matches_jax(n):
    jl = jmg.build_poisson_multigrid((-3.0, 3.0), n, 3, dtype=jnp.float64,
                                     coarse_max=4, use_pallas=False,
                                     operator="const")
    tl = tmg.build_poisson_multigrid((-3.0, 3.0), n, 3, dtype=torch.float64,
                                     coarse_max=4, operator="const",
                                     device="cpu")
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert a.plan.store_grid == tuple(b.plan.store_grid)
        np.testing.assert_array_equal(a.code.numpy(), np.asarray(b.code))
        # one-cell stiffness: the same float64 formula in the same order
        assert a.weights == tuple(b.weights)
        np.testing.assert_array_equal(a.inv_diag.numpy(),
                                      np.asarray(b.inv_diag))
    # dense inverse of a cond ~1e2 operator: 1e-12 relative
    np.testing.assert_allclose(tl[-1].coarse_inverse.numpy(),
                               np.asarray(jl[-1].coarse_inverse),
                               rtol=1e-12, atol=1e-14)


def test_uniform_stencil_data_and_bc_match_jax():
    n = 8
    info, _, bc = jmg._light_grid((-3.0, 3.0), n, 3, with_coords=False)
    jp = jax_plan(info, embed=True)
    tp = structured_plan(_infos(n)[1], embed=True)
    Ke = jmg._uniform_cell_stiffness((-3.0, 3.0), n, 3, np.float64)
    np.testing.assert_array_equal(tmg._uniform_cell_stiffness((-3.0, 3.0), n),
                                  Ke)
    mask = jmg._embed_grid_numpy(bc, jp.store_grid, fill=False)
    np.testing.assert_array_equal(
        tmg._embed_grid_numpy(bc, tp.store_grid, fill=False), mask)
    # same Ke in: the slice-add assembly and elimination are exact
    raw_j = jmg._apply_bc_numpy(
        jmg._uniform_stencil_data(jp, Ke, np.float64), jp.offsets, mask)
    raw_t = tmg._apply_bc_numpy(
        tmg._uniform_stencil_data(tp, Ke, np.float64), tp.offsets, mask)
    np.testing.assert_array_equal(raw_t, raw_j)
    np.testing.assert_array_equal(tmg._uniform_weights(tp, Ke),
                                  jmg._uniform_weights(jp, Ke))


def test_model_problem_matches_jax():
    pts = np.random.default_rng(1).uniform(-3, 3, (50, 3))
    (jf, je), (tf, te) = jax_mp3d(), model_problem_3d()
    np.testing.assert_array_equal(tf(pts), jf(pts))
    np.testing.assert_array_equal(te(pts), je(pts))
    x, y, z = pts.T
    np.testing.assert_array_equal(model_problem_3d_planes()(x, y, z),
                                  jax_mp3d_planes()(x, y, z))
    assert "T(9)" in model_problem_3d_planes().c_expr
