"""Port parity, Dirichlet boundary conditions: tpufem_torch.solve.bc
(symmetric elimination on a stencil system, the matrix-free RHS and
operator wrappers) against tpufem.solve.bc on the same random system;
float64 at 1e-12 on the CPU."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpufem.solve import bc as jbc
from tpufem.solve.multigrid import _embed_grid_numpy, _light_grid
from tpufem.sparse.stencil import StencilMatrix as JaxStencil
from tpufem.sparse.stencil import stencil_matvec as jax_matvec

from tpufem_torch.assemble.structured import structured_plan
from tpufem_torch.solve import bc as tbc
from tpufem_torch.solve.multigrid import _light_grid as port_light_grid
from tpufem_torch.sparse.stencil import StencilMatrix, stencil_matvec

# several pytest workers share the CPU: one intra-op thread each keeps
# the many small tensor ops from oversubscribing it
torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[4, 8])
def system(request):
    """Random embedded stencil system, box-boundary mask and data g."""
    n = request.param
    info, _, bc = _light_grid((-3.0, 3.0), n, 3, with_coords=False)
    plan = structured_plan(port_light_grid((-3.0, 3.0), n)[0], embed=True)
    rng = np.random.default_rng(n)
    node = _embed_grid_numpy(np.ones(info.node_grid, bool), plan.store_grid,
                             fill=False)
    data = rng.standard_normal((plan.width, plan.num_store_rows)) * node
    b = rng.standard_normal(plan.num_store_rows) * node
    mask = _embed_grid_numpy(bc, plan.store_grid, fill=False)
    g = rng.standard_normal(plan.num_store_rows) * node
    return plan, data, b, mask, g


def _close(a, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(a), ref, rtol=1e-12,
                               atol=1e-12 * max(np.abs(ref).max(), 1.0))


@pytest.mark.parametrize("values", ["vector", "scalar", "none"])
def test_apply_dirichlet_stencil_matches_jax(system, values):
    plan, data, b, mask, g = system
    gv = {"vector": g, "scalar": 2.5, "none": None}[values]
    jA, jb = jbc.apply_dirichlet_stencil(
        JaxStencil(jnp.asarray(data), plan.offsets), jnp.asarray(b),
        jnp.asarray(mask), None if gv is None else jnp.asarray(gv))
    A0 = StencilMatrix(torch.as_tensor(data), plan.offsets)
    tA, tb = tbc.apply_dirichlet_stencil(
        A0, torch.as_tensor(b), torch.as_tensor(mask),
        None if gv is None else torch.as_tensor(gv))
    _close(tA.data, jA.data)
    _close(tb, jb)
    assert tA.offsets == tuple(jA.offsets)
    # the given matrix is left as it was
    np.testing.assert_array_equal(A0.data.numpy(), data)


def test_constrain_rhs_and_operator_match_jax(system):
    plan, data, b, mask, g = system
    jmv = lambda v: jax_matvec(jnp.asarray(data), plan.offsets, v)
    tmv = lambda v: stencil_matvec(torch.as_tensor(data), plan.offsets, v)
    jb, jg = jbc.constrain_rhs(jmv, jnp.asarray(b), jnp.asarray(mask),
                               jnp.asarray(g))
    tb, tg = tbc.constrain_rhs(tmv, torch.as_tensor(b), torch.as_tensor(mask),
                               torch.as_tensor(g))
    _close(tb, jb)
    _close(tg, jg)
    x = np.random.default_rng(1).standard_normal(plan.num_store_rows)
    _close(tbc.constrained_operator(tmv, torch.as_tensor(mask))(
        torch.as_tensor(x)),
        jbc.constrained_operator(jmv, jnp.asarray(mask))(jnp.asarray(x)))


def test_eliminated_system_keeps_boundary_values(system):
    """Symmetric elimination: the BC rows are identity rows carrying g,
    and the matrix stays symmetric (on the node rows)."""
    plan, data, b, mask, g = system
    sym = data.copy()
    # symmetrize the random planes: entry (i, i+off) == (i+off, i)
    for k, off in enumerate(plan.offsets):
        kk = plan.offsets.index(-off)
        sym[kk] = np.roll(sym[k], off)
    A, bb = tbc.apply_dirichlet_stencil(
        StencilMatrix(torch.as_tensor(sym), plan.offsets), torch.as_tensor(b),
        torch.as_tensor(mask), torch.as_tensor(g))
    m = torch.as_tensor(mask)
    assert torch.equal(bb[m], torch.as_tensor(g)[m])
    assert torch.equal(A.matvec(torch.as_tensor(g))[m],
                       torch.as_tensor(g)[m])
    u, v = (torch.as_tensor(np.random.default_rng(s).standard_normal(
        plan.num_store_rows) * (np.abs(sym).sum(0) != 0)) for s in (2, 3))
    assert abs(float(torch.dot(u, A @ v) - torch.dot(v, A @ u))) <= 1e-10
