"""The JAX package's own CPU numbers for chip_smoke.py's weak-form paths
(p2, p2_tet_robin, quad_hex): iteration counts and errors on the same
systems, float64, the XLA gather products (TPUFEM_BAND_DISPATCH=0).

    python scripts/weakform_jax_reference.py p2 500       # 1,002,001 DOFs
    python scripts/weakform_jax_reference.py p2_dirichlet 160   # 103,041
    python scripts/weakform_jax_reference.py p2_tet_robin 30
    python scripts/weakform_jax_reference.py quad 1000
    python scripts/weakform_jax_reference.py hex 100      # 1,030,301

Each prints one JSON line: the case, its size, the DOFs, the PCG count,
the relative residual at the stop, the relative L2 error of the nodal
values against the manufactured solution and the walls (s).  The systems
are those chip_smoke.py builds with the port:

  p2            P2 triangles on rectangle_mesh(-3,3,-3,3,n,n): Dirichlet on
                |x| = 3, Neumann data -6(9-x^2) on |y| = 3 (the JAX
                package's tests/test_boundary.py case), ELL assembly,
                apply_dirichlet_ell, RCM + reorder_ell, build_amg(greedy,
                strength 0.08, coarse_n=300), PCG to 1e-12;
  p2_dirichlet  tests/amg_systems.py's p2_system(n) with the same AMG,
                PCG to 1e-9 (tests/test_amg_scaling.py's 100k cell);
  p2_tet_robin  P2 tetrahedra on box_mesh(-3,3,...,n,n,n), the pure Robin
                problem du/dn + u = g on every facet (no Dirichlet row),
                exact solution (9-x^2)(9-y^2)(9-z^2), RCM, the same AMG,
                PCG to 1e-10;
  quad / hex    solve_poisson_ell(precond="amg", tol=1e-10) on
                perturbed_quad_mesh(-3,3,-3,3,n,n, jitter=0.25, seed=5) /
                box_hex_mesh(-3,3,...,n,n,n).
"""
import json
import os
import sys
import time

os.environ.setdefault("TPUFEM_BAND_DISPATCH", "0")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402


def _rel(u, ue):
    u, ue = np.asarray(u), np.asarray(ue)
    return float(np.linalg.norm(u - ue) / np.linalg.norm(ue))


def _amg_pcg(A, b, tol, walls):
    """RCM-reorder (A, b), build the greedy strength-0.08 AMG and run
    PCG; returns (x in the original order, cg result)."""
    from tpufem.mesh.adjacency import reverse_cuthill_mckee
    from tpufem.solve.amg import build_amg
    from tpufem.solve.cg import cg
    from tpufem.sparse.ell import ELLMatrix, reorder_ell

    t = time.perf_counter()
    perm = reverse_cuthill_mckee(np.asarray(A.cols))
    data_p, cols_p = reorder_ell(np.asarray(A.data), np.asarray(A.cols),
                                 perm)
    Ap = ELLMatrix(jnp.asarray(data_p), jnp.asarray(cols_p))
    bp = jnp.asarray(np.asarray(b)[perm])
    walls["rcm"] = time.perf_counter() - t
    t = time.perf_counter()
    hier = build_amg(Ap, aggregation="greedy", strength=0.08, coarse_n=300)
    walls["amg_setup"] = time.perf_counter() - t
    t = time.perf_counter()
    res = cg(Ap.matvec, bp, tol=tol, maxiter=500, M=jax.jit(hier.apply))
    x = np.empty(perm.size)
    x[perm] = np.asarray(res.x)
    walls["solve"] = time.perf_counter() - t
    walls["levels"] = [int(lv.A.shape[0]) for lv in hier.levels]
    return x, res


def p2(n, dirichlet_only=False):
    from tpufem.fem.space import FunctionSpace
    from tpufem.forms.language import Coefficient, dot, grad
    from tpufem.forms.weakform import WeakForm
    from tpufem.mesh.rectangle import rectangle_mesh
    from tpufem.solve.bc import apply_dirichlet_ell
    from tpufem.solve.poisson import model_problem_2d

    walls = {}
    f, exact = model_problem_2d()
    t = time.perf_counter()
    V = FunctionSpace(rectangle_mesh(-3, 3, -3, 3, n, n), degree=2)
    wf = WeakForm(V).build(lambda u, v: dot(grad(u), grad(v)),
                           lambda v: Coefficient(f) * v)
    if dirichlet_only:
        bc = V.dof_flags
    else:
        g = Coefficient(lambda xq: -6.0 * (9.0 - xq[..., 0] ** 2))
        wf.build_boundary(rhs=lambda v: g * v,
                          where=lambda c: np.abs(c[:, 1]) > 3 - 1e-9)
        bc = np.abs(V.scalar_dof_coords[:, 0]) > 3 - 1e-9
    A, b = wf.assemble(format="ell")
    A, b = apply_dirichlet_ell(A, b, jnp.asarray(bc))
    walls["assemble"] = time.perf_counter() - t
    x, res = _amg_pcg(A, b, 1e-9 if dirichlet_only else 1e-12, walls)
    return V.num_dofs, res, _rel(x, exact(V.scalar_dof_coords)), walls


def _robin_data(xq):
    """du/dn on the faces of (-3, 3)^3 for u = (9-x^2)(9-y^2)(9-z^2), where
    u = 0 (so du/dn + u = du/dn)."""
    x, y, z = xq[..., 0], xq[..., 1], xq[..., 2]
    on_x = jnp.abs(x) > 3 - 1e-9
    on_y = jnp.abs(y) > 3 - 1e-9
    return jnp.where(on_x, -6.0 * (9 - y ** 2) * (9 - z ** 2),
                     jnp.where(on_y, -6.0 * (9 - x ** 2) * (9 - z ** 2),
                               -6.0 * (9 - x ** 2) * (9 - y ** 2)))


def p2_tet_robin(n):
    from tpufem.fem.space import FunctionSpace
    from tpufem.forms.language import Coefficient, dot, grad
    from tpufem.forms.weakform import WeakForm
    from tpufem.mesh.box import box_mesh
    from tpufem.solve.poisson import model_problem_3d

    walls = {}
    f, exact = model_problem_3d()
    t = time.perf_counter()
    V = FunctionSpace(box_mesh(-3, 3, -3, 3, -3, 3, n, n, n), degree=2)
    wf = WeakForm(V).build(lambda u, v: dot(grad(u), grad(v)),
                           lambda v: Coefficient(f) * v)
    wf.build_boundary(lhs=lambda u, v: u * v,
                      rhs=lambda v: Coefficient(_robin_data) * v)
    A, b = wf.assemble(format="ell")
    walls["assemble"] = time.perf_counter() - t
    x, res = _amg_pcg(A, b, 1e-10, walls)
    return V.num_dofs, res, _rel(x, exact(V.scalar_dof_coords)), walls


def q1(cell, n):
    from tpufem.mesh.box import box_hex_mesh
    from tpufem.mesh.rectangle import perturbed_quad_mesh
    from tpufem.solve.poisson import (model_problem_2d, model_problem_3d,
                                      solve_poisson_ell)

    if cell == "quad":
        mesh = perturbed_quad_mesh(-3, 3, -3, 3, n, n, jitter=0.25, seed=5)
        exact = model_problem_2d()[1]
    else:
        mesh = box_hex_mesh(-3, 3, -3, 3, -3, 3, n, n, n)
        exact = model_problem_3d()[1]
    t = time.perf_counter()
    sol = solve_poisson_ell(mesh, precond="amg", tol=1e-10)
    walls = {"solve_poisson_ell": time.perf_counter() - t}
    return mesh.num_nodes, sol.cg, _rel(sol.u, exact(mesh.coords)), walls


def main():
    case, n = sys.argv[1], int(sys.argv[2])
    t0 = time.perf_counter()
    if case == "p2":
        dofs, res, err, walls = p2(n)
    elif case == "p2_dirichlet":
        dofs, res, err, walls = p2(n, dirichlet_only=True)
    elif case == "p2_tet_robin":
        dofs, res, err, walls = p2_tet_robin(n)
    elif case in ("quad", "hex"):
        dofs, res, err, walls = q1(case, n)
    else:
        raise SystemExit(f"unknown case {case!r}")
    print(json.dumps({
        "case": case, "n": n, "dofs": int(dofs),
        "iterations": int(res.iterations), "converged": bool(res.converged),
        "relres": float(res.residual_norm), "rel_l2_error": err,
        "walls": walls, "wall": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
