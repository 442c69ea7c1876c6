"""Port parity, PCG: tpufem_torch.solve.cg (``cg`` with ``check_every``,
``cg_fixed``, the fused-dot hooks) against the JAX package's cg on the same
system and the same const MG preconditioner (carried across with
tpufem_torch.convert); float64 on the CPU."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpufem.assemble.planar import (element_coords_bt, element_load_bt,
                                    p1_stiffness_bt)
from tpufem.assemble.structured import (assemble_stencil_structured_bt,
                                        assemble_vector_structured_bt,
                                        structured_plan)
from tpufem.fem.quadrature import tetrahedron_rule
from tpufem.mesh.box import box_mesh
from tpufem.solve.bc import apply_dirichlet_stencil
from tpufem.solve.cg import cg as jax_cg, cg_fixed as jax_cg_fixed
from tpufem.solve.multigrid import (build_poisson_multigrid,
                                    mg_preconditioner as jax_mg)
from tpufem.solve.poisson import model_problem_3d_planes
from tpufem.sparse.stencil import stencil_matvec

from tpufem_torch.convert import const_hierarchy_from_numpy, system_from_numpy
from tpufem_torch.ops.stencil_cuda import stencil_apply
from tpufem_torch.solve.cg import cg, cg_fixed
from tpufem_torch.solve.multigrid import mg_preconditioner

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


@pytest.fixture(scope="module", params=[8, 16])
def problem(request):
    """The embedded n^3 Poisson system (JAX XLA pipeline) and its const MG
    hierarchy, in both packages."""
    n = request.param
    mesh = box_mesh(-3, 3, -3, 3, -3, 3, n, n, n)
    plan = structured_plan(mesh, embed=True)
    X = jnp.asarray(element_coords_bt(mesh, np.float64))
    A = assemble_stencil_structured_bt(plan, p1_stiffness_bt(X,
                                                             "tetrahedron"))
    b = assemble_vector_structured_bt(plan, element_load_bt(
        X, "tetrahedron", tetrahedron_rule(2), model_problem_3d_planes()))
    bc = plan.embed_field(jnp.asarray(mesh.node_flags != 0), fill=False)
    A, b = apply_dirichlet_stencil(A, b, bc)
    jl = build_poisson_multigrid((-3.0, 3.0), n, 3, dtype=jnp.float64,
                                 coarse_max=4, use_pallas=False,
                                 operator="const")
    tA, tb = system_from_numpy(np.asarray(A.data), np.asarray(b), A.offsets)
    return dict(jA=A, jb=b, jl=jl, tA=tA, tb=tb,
                tl=const_hierarchy_from_numpy(_as_dicts(jl)))


def _rel(a, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(a) - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("check_every,precond", [(1, "mg"), (4, "mg"),
                                                 (1, "none")])
def test_cg_matches_jax(problem, check_every, precond):
    jA, tA = problem["jA"], problem["tA"]
    jkw, tkw = {}, {}
    if precond == "mg":
        jkw = dict(M=jax_mg(problem["jl"], nu1=1, nu2=1, use_pallas=False),
                   M_dot=jax_mg(problem["jl"], nu1=1, nu2=1,
                                use_pallas=False, with_dot=True))
        tkw = dict(M=mg_preconditioner(problem["tl"], nu1=1, nu2=1),
                   M_dot=mg_preconditioner(problem["tl"], nu1=1, nu2=1,
                                           with_dot=True),
                   matvec_dot=lambda v: stencil_apply(tA.data, v, tA.offsets,
                                                      with_dot=True))
    tol = 1e-10 if precond == "mg" else 1e-8
    ref = jax_cg(lambda v: stencil_matvec(jA.data, jA.offsets, v),
                 problem["jb"], tol=tol, maxiter=400,
                 check_every=check_every, **jkw)
    res = cg(tA.matvec, problem["tb"], tol=tol, maxiter=400,
             check_every=check_every, **tkw)
    assert res.converged and bool(ref.converged)
    assert res.iterations == int(ref.iterations)
    # float64 iterates; reductions summed in another order: 1e-9
    assert _rel(res.x, ref.x) <= 1e-9
    assert abs(float(res.residual_norm) - float(ref.residual_norm)) <= \
        1e-6 * float(ref.residual_norm) + 1e-14


def test_cg_fixed_matches_jax(problem):
    jA, tA = problem["jA"], problem["tA"]
    x_ref, r_ref = jax_cg_fixed(
        lambda v: stencil_matvec(jA.data, jA.offsets, v), problem["jb"],
        jnp.int32(5), M=jax_mg(problem["jl"], nu1=1, nu2=1, use_pallas=False))
    x, r = cg_fixed(tA.matvec, problem["tb"], 5,
                    M_dot=mg_preconditioner(problem["tl"], nu1=1, nu2=1,
                                            with_dot=True))
    assert _rel(x, x_ref) <= 1e-9       # float64, reordered sums
    assert _rel(r, r_ref) <= 1e-9


def test_cg_fixed_guard_freezes_converged_iterate(problem):
    """rz -> 0 (exact convergence inside the budget) must not 0/0."""
    tA, tb = problem["tA"], problem["tb"]
    x, _ = cg_fixed(tA.matvec, torch.zeros_like(tb), 3)
    assert torch.count_nonzero(x) == 0 and torch.isfinite(x).all()


def _block_diagonal_system(n=40, seed=3):
    """Two SPD blocks acting on the rows of a [2, n] vector, and a [2, n]
    right-hand side (numpy, float64)."""
    rng = np.random.default_rng(seed)
    blocks = []
    for _ in range(2):
        G = rng.standard_normal((n, n))
        blocks.append(G @ G.T / n + np.eye(n))
    return np.stack(blocks), rng.standard_normal((2, n))


@pytest.mark.parametrize("check_every", [1, 3])
def test_cg_takes_vectors_of_any_shape_as_jax(check_every):
    """The default dots run over the flattened vectors, as jnp.vdot does:
    cg on a [2, n] block system equals the JAX cg (same iterations, x at
    1e-12), and so does cg_fixed."""
    blocks, b = _block_diagonal_system()
    jB, tB = jnp.asarray(blocks), torch.as_tensor(blocks)
    jmv = lambda v: jnp.einsum("bij,bj->bi", jB, v)
    tmv = lambda v: torch.einsum("bij,bj->bi", tB, v)
    inv_d = 1.0 / np.stack([np.diag(blk) for blk in blocks])
    ref = jax_cg(jmv, jnp.asarray(b), tol=1e-12, maxiter=200,
                 check_every=check_every, M=lambda r: r * jnp.asarray(inv_d))
    res = cg(tmv, torch.as_tensor(b), tol=1e-12, maxiter=200,
             check_every=check_every, M=lambda r: r * torch.as_tensor(inv_d))
    assert res.converged and bool(ref.converged)
    assert res.x.shape == (2, b.shape[1])
    assert res.iterations == int(ref.iterations)
    assert _rel(res.x, ref.x) <= 1e-12
    x_ref, r_ref = jax_cg_fixed(jmv, jnp.asarray(b), jnp.int32(7))
    x, r = cg_fixed(tmv, torch.as_tensor(b), 7)
    assert _rel(x, x_ref) <= 1e-12 and _rel(r, r_ref) <= 1e-12
