"""Port parity, kernel B7 (one-pass 2D P1-triangle system build: stiffness,
RHS and zero-Dirichlet elimination): the port's plain version against the
JAX package's Pallas kernel ``_kernel_2d`` in interpret mode, in quadrature
and interp modes, as the raw system plus the elimination, and on a linear
f that both RHS modes integrate exactly; float64 at 1e-12 on the CPU."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpufem.fem.quadrature import triangle_rule as jax_rule
from tpufem.ops.fused_system_pallas import (
    build_poisson_system_pallas, node_coords_embedded_from_grid as jax_coords)
from tpufem.solve.bc import apply_dirichlet_stencil as jax_bc
from tpufem.solve.multigrid import _light_grid as jax_light_grid
from tpufem.assemble.structured import structured_plan as jax_plan
from tpufem.solve.poisson import model_problem_2d_planes as jax_f

from tpufem_torch.assemble.structured import structured_plan
from tpufem_torch.fem.quadrature import triangle_rule
from tpufem_torch.ops import fused_system_cuda
from tpufem_torch.ops.fused_system_cuda import (build_poisson_system,
                                                node_coords_embedded_from_grid,
                                                tables_header)
from tpufem_torch.solve.bc import apply_dirichlet_stencil
from tpufem_torch.solve.multigrid import _embed_grid_numpy, _light_grid
from tpufem_torch.solve.poisson import RhsFunction, model_problem_2d_planes

# several pytest workers share the CPU: one intra-op thread each keeps
# the many small tensor ops from oversubscribing it
torch.set_num_threads(1)

N = 12
DOMAIN = (-3.0, 3.0)


def _close(a, ref, rtol=1e-12):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(a, np.float64), ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1.0))


@pytest.fixture(scope="module")
def grid():
    """(JAX plan, the port's plan, embedded coords, JAX bc mask, port bc)."""
    jinfo, coords, bc_grid = jax_light_grid(DOMAIN, N, 2)
    info, coords_t, _ = _light_grid(DOMAIN, N, 2)
    np.testing.assert_array_equal(coords, coords_t)
    jp = jax_plan(jinfo, embed=True)
    tp = structured_plan(info, embed=True)
    assert tp.offsets == tuple(jp.offsets)
    assert tuple(tp.store_grid) == tuple(jp.store_grid)
    C = node_coords_embedded_from_grid(coords, tp, np.float64)
    np.testing.assert_array_equal(C, jax_coords(coords, jp, np.float64))
    bc = _embed_grid_numpy(bc_grid, tp.store_grid, fill=False)
    return jp, tp, C, jnp.asarray(bc), torch.as_tensor(bc)


@pytest.mark.parametrize("rhs_mode", ["quadrature", "interp"])
@pytest.mark.parametrize("degree", [2, 3])
def test_b7_plain_matches_pallas_kernel(grid, rhs_mode, degree):
    jp, tp, C, jbc, _ = grid
    A_ref, b_ref = build_poisson_system_pallas(
        jp, jnp.asarray(C), jbc, jax_f(), jax_rule(degree),
        rhs_mode=rhs_mode, interpret=True)
    A, b = build_poisson_system(tp, torch.as_tensor(C),
                                model_problem_2d_planes(),
                                triangle_rule(degree), rhs_mode=rhs_mode)
    assert A.offsets == tuple(jp.offsets) and A.data.shape[0] == 7
    # float64, the same element terms summed in another order: 1e-12
    _close(A.data.numpy(), A_ref.data)
    _close(b.numpy(), b_ref)
    assert fused_system_cuda.build_poisson_system.launches_2d == 0
    assert fused_system_cuda.build_poisson_system.launches == 0


@pytest.mark.parametrize("rhs_mode", ["quadrature", "interp"])
def test_b7_raw_plus_elimination_matches_pallas(grid, rhs_mode):
    """apply_bc=False, then the symmetric elimination with nonzero g."""
    jp, tp, C, jbc, bc = grid
    g = np.random.default_rng(0).standard_normal(tp.num_store_rows)
    A0_ref, b0_ref = build_poisson_system_pallas(
        jp, jnp.asarray(C), jbc, jax_f(), jax_rule(2), apply_bc=False,
        rhs_mode=rhs_mode, interpret=True)
    A0, b0 = build_poisson_system(tp, torch.as_tensor(C),
                                  model_problem_2d_planes(),
                                  triangle_rule(2), apply_bc=False,
                                  rhs_mode=rhs_mode)
    _close(A0.data.numpy(), A0_ref.data)
    _close(b0.numpy(), b0_ref)
    A_ref, b_ref = jax_bc(A0_ref, b0_ref, jbc, jnp.asarray(g))
    A, b = apply_dirichlet_stencil(A0, b0, bc, torch.as_tensor(g))
    _close(A.data.numpy(), A_ref.data)
    _close(b.numpy(), b_ref)


def test_b7_linear_f_is_integrated_exactly(grid):
    """A linear f: the degree-2 rule and the P1 interpolant both integrate
    f phi_a exactly, so the two RHS modes agree, and agree with JAX's."""
    jp, tp, C, jbc, _ = grid
    lin = RhsFunction(lambda x, y: 1.0 + 2.0 * x - 3.0 * y,
                      "T(1) + T(2) * x - T(3) * y")
    Ct = torch.as_tensor(C)
    _, bq = build_poisson_system(tp, Ct, lin, triangle_rule(2))
    _, bi = build_poisson_system(tp, Ct, lin, triangle_rule(2),
                                 rhs_mode="interp")
    _close(bq.numpy(), bi.numpy())
    _, b_ref = build_poisson_system_pallas(
        jp, jnp.asarray(C), jbc, lambda x, y: 1.0 + 2.0 * x - 3.0 * y,
        jax_rule(2), rhs_mode="interp", interpret=True)
    _close(bq.numpy(), b_ref)


def test_b7_generated_header_tables(grid):
    """The tables B7 is compiled with: the six (type, local node) entries
    of the two triangles, the rule and f(x, y), taken from the plan."""
    _, tp, _, _, _ = grid
    rule = triangle_rule(2)
    text = tables_header(tp, rule, model_problem_2d_planes().c_expr)
    assert "#define TPUFEM_K 7" in text
    ta = text.split("#define TPUFEM_FOR_TA(X) ")[1].split("\n")[0]
    entries = [list(map(int, e.split(", ")))
               for e in ta.strip().removeprefix("X(").removesuffix(")")
               .split(") X(")]
    assert len(entries) == 6
    offs = tp.info.type_node_offsets
    for e in entries:
        t, a = e[0], e[1]
        assert e[2:4] == list(offs[t, a])
        assert e[4:10] == list(offs[t].reshape(-1))
        assert e[10:] == list(tp.entry_k[t, a])
    qp = text.split("#define TPUFEM_FOR_QP(X) ")[1].split("\n")[0]
    assert qp.count("X(") == rule.num_points == 3
    assert "T rhs_f(T x, T y) { return (T(36) -" in text
    off = text.split("#define TPUFEM_FOR_OFFSETS(X) ")[1].split("\n")[0]
    assert off.count("X(") == 7 and "X(0, " in off


def test_b7_wrapper_takes_only_2d_plans(grid):
    """The one entry point holds the coordinates to the plan's dimension:
    2D coordinates with a 3D plan (or 3D ones with a 2D plan) raise before
    any build, as does an unknown RHS mode."""
    _, tp, C, _, _ = grid
    plan3 = structured_plan(_light_grid(DOMAIN, 4, 3)[0], embed=True)
    with pytest.raises(ValueError, match="C_emb"):
        build_poisson_system(plan3, torch.zeros((2,) + plan3.store_grid[1:],
                                                dtype=torch.float64),
                             model_problem_2d_planes(), triangle_rule(2))
    with pytest.raises(ValueError, match="C_emb"):
        build_poisson_system(tp, torch.zeros((3,) + tuple(tp.store_grid),
                                             dtype=torch.float64),
                             model_problem_2d_planes(), triangle_rule(2))
    with pytest.raises(ValueError, match="rhs_mode"):
        build_poisson_system(tp, torch.as_tensor(C),
                             model_problem_2d_planes(), triangle_rule(2),
                             rhs_mode="lumped")
