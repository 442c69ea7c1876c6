"""Port parity, kernel K2 (stencil SpMV, optionally with <x, Ax>): the
port's plain version against the JAX package's stencil_matvec / vdot and
its Pallas kernel (interpret mode), float64 on the CPU."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpufem.assemble.structured import structured_plan as jax_plan
from tpufem.ops.stencil_pallas import stencil_matvec_dot_embedded as jax_mvd
from tpufem.solve.multigrid import _light_grid
from tpufem.sparse.stencil import stencil_matvec as jax_stencil_matvec

from tpufem_torch.assemble.structured import structured_plan
from tpufem_torch.ops import stencil_cuda
from tpufem_torch.ops.stencil_cuda import (stencil_apply,
                                           stencil_matvec_dot_embedded,
                                           stencil_matvec_embedded)
from tpufem_torch.solve.multigrid import _light_grid as port_light_grid
from tpufem_torch.sparse.stencil import StencilMatrix

# several pytest workers share the CPU: one intra-op thread each keeps
# the many small tensor ops from oversubscribing it
torch.set_num_threads(1)


def _fields(n, seed):
    """Random embedded operator data and vector (zero on the padding, as
    every embedded field is)."""
    info, _, _ = _light_grid((-3.0, 3.0), n, 3, with_coords=False)
    jp = jax_plan(info, embed=True)
    tp = structured_plan(port_light_grid((-3.0, 3.0), n)[0], embed=True)
    rng = np.random.default_rng(seed)
    node = np.zeros(jp.store_grid, bool)
    node[1:n + 2, 1:n + 2, 1:n + 2] = True
    data = rng.standard_normal((jp.width, jp.num_store_rows)) * node.ravel()
    x = rng.standard_normal(jp.num_store_rows) * node.ravel()
    return jp, tp, data, x


@pytest.mark.parametrize("n", [4, 8, 12])
def test_stencil_matvec_and_dot_match_jax(n):
    jp, tp, data, x = _fields(n, n)
    y_ref = np.asarray(jax_stencil_matvec(jnp.asarray(data), jp.offsets,
                                          jnp.asarray(x)))
    d_ref = float(jnp.vdot(jnp.asarray(x), jnp.asarray(y_ref)))
    td, tx = torch.as_tensor(data), torch.as_tensor(x)
    y = stencil_matvec_embedded(td, tx, tp)
    y2, d = stencil_matvec_dot_embedded(td, tx, tp)
    # float64, same sum of 15 products per row: 1e-12 covers reordering
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(y2.numpy(), y.numpy())
    assert abs(float(d) - d_ref) <= 1e-12 * max(abs(d_ref), 1.0)
    np.testing.assert_allclose(StencilMatrix(td, tp.offsets).matvec(tx),
                               y.numpy(), rtol=0, atol=0)


def test_stencil_matvec_dot_matches_pallas_kernel():
    """Against the replaced TPU kernel itself, in interpret mode (tiny
    grid: interpret mode is slow on the CPU)."""
    jp, tp, data, x = _fields(4, 7)
    y_ref, d_ref = jax_mvd(jnp.asarray(data), jnp.asarray(x), jp,
                           block_lead=2, interpret=True)
    y, d = stencil_apply(torch.as_tensor(data), torch.as_tensor(x),
                         tp.offsets, with_dot=True)
    # float64; the Pallas kernel sums the dot block by block: 1e-12
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-12,
                               atol=1e-12)
    assert abs(float(d) - float(d_ref)) <= 1e-12 * max(abs(float(d_ref)), 1)


def test_cpu_tensors_launch_no_kernel():
    _, tp, data, x = _fields(4, 3)
    before = stencil_cuda.stencil_apply.launches
    stencil_matvec_dot_embedded(torch.as_tensor(data), torch.as_tensor(x), tp)
    assert stencil_cuda.stencil_apply.launches == before == 0
