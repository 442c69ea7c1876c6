"""Port parity, COO assembly, the matrix-free operators and element
coloring: tpufem_torch.assemble.coo, sparse.matfree and
mesh.adjacency.greedy_element_coloring / pattern_unique_keys /
slots_for_conn against the JAX package's (float64, CPU, the same numpy
meshes).  Triplets equal in order and value, the deduplicated values at
1e-12 and equal to the ELL assembly's, colorings and keys equal bit for
bit; every matrix-free product agrees with the JAX package's and with the
assembled ELL product at 1e-12, and a product repeats bit for bit."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpufem.assemble import coo as jcoo
from tpufem.assemble.local import p1_stiffness as jax_p1_stiffness
from tpufem.fem.elements import element_for_cell as jax_element
from tpufem.mesh import adjacency as jadj
from tpufem.mesh.box import box_mesh as jax_box_mesh
from tpufem.mesh.rectangle import perturbed_rectangle_mesh as jax_perturbed
from tpufem.sparse import matfree as jmf

from tpufem_torch.assemble import coo
from tpufem_torch.assemble.ell import assemble_ell
from tpufem_torch.assemble.local import p1_stiffness
from tpufem_torch.fem.elements import element_for_cell
from tpufem_torch.mesh import adjacency as adj
from tpufem_torch.mesh.box import box_mesh
from tpufem_torch.mesh.rectangle import perturbed_rectangle_mesh
from tpufem_torch.sparse import matfree

torch.set_num_threads(1)

_MESHES = {
    "tri": (lambda m: m(-3, 3, -3, 3, 7, 6, jitter=0.2, seed=3),
            jax_perturbed, perturbed_rectangle_mesh),
    "tet": (lambda m: m(-1, 1, -1, 1, -1, 1, 3, 2, 3), jax_box_mesh,
            box_mesh),
}


def _meshes(name):
    make, jm, tm = _MESHES[name]
    return make(jm), make(tm)


def _close(a, ref, rtol=1e-12):
    a, ref = np.asarray(a), np.asarray(ref)
    assert a.shape == ref.shape
    assert np.abs(a - ref).max() <= rtol * max(np.abs(ref).max(), 1e-300)


def _stiffness(m):
    el = element_for_cell(m.cell_type)
    return p1_stiffness(torch.as_tensor(m.element_coords()), el), el


@pytest.mark.parametrize("name", list(_MESHES))
def test_coo_equals_jax_and_ell(name):
    jm, m = _meshes(name)
    Ke, _ = _stiffness(m)
    jKe = jax_p1_stiffness(jnp.asarray(jm.element_coords()),
                           jax_element(jm.cell_type))
    rows, cols, vals = coo.coo_triplets(m.conn, Ke)
    jrows, jcols, jvals = jcoo.coo_triplets(jm.conn, jKe)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(cols.numpy(), np.asarray(jcols))
    _close(vals.numpy(), jvals)
    # the native pattern holds no keys: they are materialized, and equal
    # the numpy pattern's
    pat = adj.ell_pattern(m.conn, m.num_nodes, pad_to=8,
                          with_sort_plan=False)
    jpat = jadj.ell_pattern(jm.conn, jm.num_nodes, pad_to=8)
    assert pat.unique_keys is None
    keys = adj.pattern_unique_keys(pat)
    np.testing.assert_array_equal(keys, jadj.pattern_unique_keys(jpat))
    np.testing.assert_array_equal(
        adj.pattern_unique_keys(adj.ell_pattern(m.conn, m.num_nodes,
                                                pad_to=8)), keys)
    nn = m.num_nodes
    values = coo.assemble_coo(m.conn, Ke, keys, nn)
    _close(values.numpy(), jcoo.assemble_coo(jm.conn, jKe, keys, nn))
    # the same values as the ELL assembly on the pattern, slot for slot
    A = assemble_ell(pat, Ke)
    real = np.arange(pat.width)[None, :] < pat.row_lengths[:, None]
    _close(A.data.numpy()[real], values.numpy())
    # the row sums of a stiffness matrix vanish
    row_sum = torch.zeros(nn, dtype=values.dtype).index_add_(
        0, torch.as_tensor(keys // nn), values)
    assert row_sum.abs().max() <= 1e-12 * values.abs().max()
    again = coo.assemble_coo(m.conn, Ke, keys, nn)
    assert torch.equal(again, values)


@pytest.mark.parametrize("name", list(_MESHES))
def test_coloring_and_slots_equal_jax(name):
    jm, m = _meshes(name)
    colors = adj.greedy_element_coloring(m.conn, m.num_nodes)
    np.testing.assert_array_equal(
        colors, jadj.greedy_element_coloring(jm.conn, jm.num_nodes))
    assert colors.dtype == np.int32 and colors.min() == 0
    for c in range(colors.max() + 1):
        nodes = m.conn[colors == c].ravel()
        assert np.unique(nodes).size == nodes.size    # no shared node
    pat = adj.ell_pattern(m.conn, m.num_nodes, pad_to=8,
                          with_sort_plan=False)
    jpat = jadj.ell_pattern(jm.conn, jm.num_nodes, pad_to=8)
    np.testing.assert_array_equal(adj.slots_for_conn(pat, m.conn),
                                  jadj.slots_for_conn(jpat, jm.conn))
    np.testing.assert_array_equal(adj.slots_for_conn(pat, m.conn),
                                  pat.slots)
    with pytest.raises(ValueError, match="missing"):
        adj.slots_for_conn(pat, np.array([[0, m.num_nodes - 1]]))


@pytest.mark.parametrize("name", list(_MESHES))
def test_matfree_operators_equal_jax_and_ell(name):
    jm, m = _meshes(name)
    Ke, el = _stiffness(m)
    nn = m.num_nodes
    ec = torch.as_tensor(m.element_coords())
    jec = jnp.asarray(jm.element_coords())
    jel = jax_element(jm.cell_type)
    x = np.random.default_rng(2).standard_normal(nn)
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    pat = adj.ell_pattern(m.conn, nn, pad_to=8, with_sort_plan=False)
    ref = assemble_ell(pat, Ke).matvec(xt).numpy()
    ops = {
        "element": (matfree.element_operator(m.conn, Ke, nn),
                    jmf.element_operator(jm.conn, jax_p1_stiffness(jec, jel),
                                         nn)),
        "factored": (matfree.poisson_operator(ec, m.conn, nn, el),
                     jmf.poisson_operator(jec, jm.conn, nn, jel)),
        "on_the_fly": (matfree.poisson_operator(ec, m.conn, nn, el,
                                                on_the_fly=True),
                       jmf.poisson_operator(jec, jm.conn, nn, jel,
                                            on_the_fly=True)),
    }
    for key, (op, jop) in ops.items():
        y = op(xt)
        _close(y.numpy(), jop(xj))
        _close(y.numpy(), ref)
        assert torch.equal(op(xt), y), key


def test_node_sum_plan_lists_each_node_in_element_order():
    conn = np.array([[0, 1, 2], [2, 1, 3], [3, 4, 2]], np.int32)
    plan = matfree._node_sum_plan(conn, 5).numpy()
    assert plan.shape == (5, 3)
    pad = conn.size
    np.testing.assert_array_equal(plan[2], [2, 3, 8])
    np.testing.assert_array_equal(plan[0], [0, pad, pad])
    np.testing.assert_array_equal(plan[1], [1, 4, pad])
