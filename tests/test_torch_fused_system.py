"""Port parity, kernel K1 (one-pass system build: stiffness + RHS +
zero-Dirichlet elimination): the port's plain version against the JAX
package's XLA pipeline — the recipe of test_embedded_pipeline.py, which
pins the Pallas kernel to it — and against the Pallas kernel itself in
interpret mode for the ``interp`` RHS; float64 on the CPU."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpufem.assemble.planar import (element_coords_bt, element_load_bt,
                                    p1_stiffness_bt)
from tpufem.assemble.structured import (assemble_stencil_structured_bt,
                                        assemble_vector_structured_bt)
from tpufem.assemble.structured import structured_plan as jax_plan
from tpufem.fem.quadrature import tetrahedron_rule as jax_rule
from tpufem.mesh.box import box_mesh
from tpufem.ops.fused_system_pallas import build_poisson_system_pallas
from tpufem.ops.fused_system_pallas import \
    node_coords_embedded as jax_node_coords_embedded
from tpufem.solve.bc import apply_dirichlet_stencil
from tpufem.solve.poisson import model_problem_3d_planes as jax_f

from tpufem_torch.assemble.structured import structured_plan
from tpufem_torch.fem.quadrature import tetrahedron_rule
from tpufem_torch.mesh.box import box_mesh as port_box_mesh
from tpufem_torch.ops import fused_system_cuda
from tpufem_torch.ops.fused_system_cuda import (build_poisson_system,
                                                node_coords_embedded,
                                                tables_header)
from tpufem_torch.solve.poisson import model_problem_3d_planes

# several pytest workers share the CPU: one intra-op thread each keeps
# the many small tensor ops from oversubscribing it
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def noncubic():
    # non-cubic box: catches axis swaps
    mesh = box_mesh(-3, 2, 0, 3, -2, 1, 5, 4, 6)
    jp = jax_plan(mesh, embed=True)
    tp = structured_plan(port_box_mesh(-3, 2, 0, 3, -2, 1, 5, 4, 6),
                         embed=True)
    # each package's own embedded coordinates: JAX's on JAX's side of a
    # comparison, the port's on the port's
    C_jax = jax_node_coords_embedded(mesh, jp, np.float64)
    C = node_coords_embedded(port_box_mesh(-3, 2, 0, 3, -2, 1, 5, 4, 6), tp,
                             np.float64)
    return mesh, jp, tp, C_jax, C


@pytest.mark.parametrize("degree", [2, 3])
@pytest.mark.parametrize("apply_bc", [True, False])
def test_system_build_matches_jax_pipeline(noncubic, degree, apply_bc):
    mesh, jp, tp, _, C = noncubic
    fp = jax_f()
    X = jnp.asarray(element_coords_bt(mesh, np.float64))
    A_ref = assemble_stencil_structured_bt(jp, p1_stiffness_bt(X,
                                                               "tetrahedron"))
    b_ref = assemble_vector_structured_bt(
        jp, element_load_bt(X, "tetrahedron", jax_rule(degree), fp))
    if apply_bc:
        bc = jp.embed_field(jnp.asarray(mesh.node_flags != 0), fill=False)
        A_ref, b_ref = apply_dirichlet_stencil(A_ref, b_ref, bc)

    A, b = build_poisson_system(tp, torch.as_tensor(C),
                                model_problem_3d_planes(),
                                tetrahedron_rule(degree), apply_bc=apply_bc)
    assert A.offsets == tuple(jp.offsets)
    # float64, same element formulas summed in another order: 1e-12
    np.testing.assert_allclose(A.data.numpy(), np.asarray(A_ref.data),
                               rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_ref), rtol=1e-12,
                               atol=1e-12)


def test_interp_rhs_matches_pallas_kernel(noncubic):
    mesh, jp, tp, C_jax, C = noncubic
    bc = jp.embed_field(jnp.asarray(mesh.node_flags != 0), fill=False)
    A_ref, b_ref = build_poisson_system_pallas(
        jp, jnp.asarray(C_jax), bc, jax_f(), jax_rule(2), block_lead=2,
        rhs_mode="interp", interpret=True)
    A, b = build_poisson_system(tp, torch.as_tensor(C),
                                model_problem_3d_planes(), tetrahedron_rule(2),
                                rhs_mode="interp")
    # float64; the Pallas kernel accumulates the same terms in another
    # order: 1e-12
    np.testing.assert_allclose(A.data.numpy(), np.asarray(A_ref.data),
                               rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_ref), rtol=1e-12,
                               atol=1e-12)
    assert fused_system_cuda.build_poisson_system.launches == 0


def test_generated_header_tables(noncubic):
    """The tables K1 is compiled with: every type's vertex offsets, every
    (type, local node) entry, the quadrature and f, taken from the plan
    (checked against the plan)."""
    _, _, tp, _, _ = noncubic
    rule = tetrahedron_rule(2)
    text = tables_header(tp, rule, model_problem_3d_planes().c_expr)
    assert "#define TPUFEM_K 15" in text
    ta = text.split("#define TPUFEM_FOR_TA(X) ")[1].split("\n")[0]
    entries = [list(map(int, e.split(", ")))
               for e in ta.strip().removeprefix("X(").removesuffix(")")
               .split(") X(")]
    assert len(entries) == 24
    offs = tp.info.type_node_offsets
    for e in entries:
        t, a = e[0], e[1]
        assert e[2:5] == list(offs[t, a])
        assert e[5:17] == list(offs[t].reshape(-1))
        assert e[17:] == list(tp.entry_k[t, a])
    types = text.split("#define TPUFEM_FOR_TYPES(X) ")[1].split("\n")[0]
    assert [list(map(int, e.split(", "))) for e in types.strip()
            .removeprefix("X(").removesuffix(")").split(") X(")] == [
        [t, *offs[t].reshape(-1)] for t in range(offs.shape[0])]
    qp = text.split("#define TPUFEM_FOR_QP(X) ")[1].split("\n")[0]
    assert qp.count("X(") == rule.num_points
    assert "T rhs_f(T x, T y, T z) { return (T(2) *" in text
