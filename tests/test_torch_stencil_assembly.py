"""Port parity, index-based stencil assembly: stencil_pattern, both
stencil_values methods, assemble_stencil and StencilMatrix.to_dense against
the JAX package (tests/test_sparse.py's meshes, float64, CPU)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpufem.assemble.dense import assemble_dense as jax_assemble_dense
from tpufem.assemble.local import p1_stiffness as jax_p1_stiffness
from tpufem.assemble.stencil import assemble_stencil as jax_assemble_stencil
from tpufem.assemble.stencil import stencil_values as jax_stencil_values
from tpufem.fem.elements import P1Tetrahedron as JaxTet
from tpufem.fem.elements import P1Triangle as JaxTri
from tpufem.mesh.box import box_mesh as jax_box_mesh
from tpufem.mesh.rectangle import rectangle_mesh as jax_rectangle_mesh
from tpufem.sparse.stencil import stencil_pattern as jax_stencil_pattern

from tpufem_torch.assemble.local import p1_stiffness
from tpufem_torch.assemble.stencil import assemble_stencil, stencil_values
from tpufem_torch.convert import stencil_pattern_from_numpy
from tpufem_torch.fem.elements import P1Tetrahedron, P1Triangle
from tpufem_torch.mesh.box import box_mesh
from tpufem_torch.mesh.rectangle import (perturbed_rectangle_mesh,
                                         rectangle_mesh)
from tpufem_torch.sparse.stencil import StencilMatrix, stencil_pattern

# several pytest workers share the CPU: one intra-op thread each keeps
# the many small tensor ops from oversubscribing it
torch.set_num_threads(1)

# tests/test_sparse.py's meshes: name -> (generator pair, arguments,
# elements, expected width)
_MESHES = {
    "2d_4x6": ((rectangle_mesh, jax_rectangle_mesh), (0, 1, 0, 1, 4, 6),
               (P1Triangle, JaxTri), 7),
    "2d_5x7": ((rectangle_mesh, jax_rectangle_mesh), (-3, 3, -3, 3, 5, 7),
               (P1Triangle, JaxTri), 7),
    "3d_2x3x4": ((box_mesh, jax_box_mesh), (0, 1, 0, 1, 0, 1, 2, 3, 4),
                 (P1Tetrahedron, JaxTet), 15),
}


def _case(name):
    (gen, jgen), args, (el, jel), width = _MESHES[name]
    tm, jm = gen(*args), jgen(*args)
    ec = tm.element_coords()
    Ke = p1_stiffness(torch.as_tensor(ec), el())
    jKe = jax_p1_stiffness(jnp.asarray(ec), jel())
    return tm, jm, Ke, jKe, width


@pytest.mark.parametrize("name", sorted(_MESHES))
def test_stencil_pattern_matches_jax(name):
    tm, jm, _, _, width = _case(name)
    p = stencil_pattern(tm.conn, tm.num_nodes)
    jp = jax_stencil_pattern(jm.conn, jm.num_nodes)
    assert p.width == jp.width == width
    for field in ("offsets", "slots", "perm", "sorted_slots"):
        np.testing.assert_array_equal(getattr(p, field), getattr(jp, field))
    assert (p.diag_k, p.num_rows) == (jp.diag_k, jp.num_rows)
    assert p.offsets[p.diag_k] == 0
    carried = stencil_pattern_from_numpy(
        offsets=jp.offsets, slots=jp.slots, perm=jp.perm,
        sorted_slots=jp.sorted_slots, diag_k=jp.diag_k,
        num_rows=jp.num_rows)
    np.testing.assert_array_equal(carried.slots, p.slots)
    assert carried.width == p.width


@pytest.mark.parametrize("method", ["scatter", "sort"])
@pytest.mark.parametrize("name", sorted(_MESHES))
def test_stencil_assembly_matches_jax(name, method):
    tm, jm, Ke, jKe, _ = _case(name)
    p = stencil_pattern(tm.conn, tm.num_nodes)
    jp = jax_stencil_pattern(jm.conn, jm.num_nodes)
    data = stencil_values(p, Ke, method=method)
    jdata = np.asarray(jax_stencil_values(jp, jKe, method=method))
    ref = np.abs(jdata).max()
    assert np.abs(data.numpy() - jdata).max() <= 1e-12 * ref
    A = assemble_stencil(p, Ke, method=method)
    jA = jax_assemble_stencil(jp, jKe, method=method)
    assert A.offsets == jA.offsets
    dense = A.to_dense().numpy()
    jdense = np.asarray(jA.to_dense())
    assert np.abs(dense - jdense).max() <= 1e-12 * ref
    np.testing.assert_allclose(
        dense, np.asarray(jax_assemble_dense(jm.conn, jKe, jm.num_nodes)),
        rtol=1e-12, atol=1e-14)
    x = np.random.default_rng(0).standard_normal(tm.num_nodes)
    np.testing.assert_allclose(A.matvec(torch.as_tensor(x)).numpy(),
                               dense @ x, rtol=1e-12, atol=1e-12)
    # both methods give the same values, bit for bit
    other = "sort" if method == "scatter" else "scatter"
    assert torch.equal(stencil_values(p, Ke, method=other), data)


def test_stencil_pattern_rejects_and_to_dense_edges():
    m = perturbed_rectangle_mesh(-1, 1, -1, 1, 6, 6, seed=0)
    p = stencil_pattern(m.conn, m.num_nodes)
    with pytest.raises(ValueError, match="ELL"):
        stencil_pattern(m.conn, m.num_nodes, max_offsets=p.width - 1)
    with pytest.raises(ValueError, match="method"):
        stencil_values(p, torch.zeros((m.num_elements, 3, 3),
                                      dtype=torch.float64), method="coo")
    with pytest.raises(ValueError, match="diag_k"):
        stencil_pattern_from_numpy(offsets=[-1, 1], slots=None, perm=None,
                                   sorted_slots=None, diag_k=0, num_rows=3)
    # entries whose column leaves [0, n) are dropped, as in the reference
    A = StencilMatrix(torch.arange(12, dtype=torch.float64).reshape(3, 4),
                      (-1, 0, 2))
    np.testing.assert_array_equal(A.to_dense().numpy(), np.array(
        [[4.0, 0, 8, 0], [1, 5, 0, 9], [0, 2, 6, 0], [0, 0, 3, 7]]))
