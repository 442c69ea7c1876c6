"""Semilinear Poisson via matrix-free Newton-Krylov, as
examples/nonlinear_poisson.py:

    -Δu + u³ = f   on (-3,3)²,  u = 0 on the boundary,

manufactured so the exact solution is u* = (9-x²)(9-y²).  The Jacobian is
never assembled: the inner CG takes the forward-mode tangent of the
assembled residual (``solve.newton``).  fp32, as the JAX example fixes it.
On the card every product of the stiffness, primal and tangent, is the
banded ELL kernel (B9); ``--precond amg`` preconditions the inner CG with
a frozen interval-W AMG of the linear part, whose level products are B9
too.

The solve runs twice, as the JAX example runs its jitted solve twice: the
first, cold run (the process's one-time costs: the first dual level, the
banded plan) is ``walls_s.compile``, the second is ``solve_s``; both give
the same x bit for bit.

    python -m tpufem_torch.examples.nonlinear_poisson [--n 512] [--precond amg]
    python -m tpufem_torch.examples.nonlinear_poisson --n 48 --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from tpufem_torch.assemble.dense import assemble_vector
from tpufem_torch.assemble.ell import assemble_ell
from tpufem_torch.assemble.local import (element_load,
                                         element_nonlinear_load,
                                         p1_stiffness)
from tpufem_torch.examples._common import add_device_arg, device_of, sync
from tpufem_torch.fem.elements import P1Triangle
from tpufem_torch.fem.quadrature import triangle_rule
from tpufem_torch.mesh.adjacency import ell_pattern
from tpufem_torch.mesh.rectangle import rectangle_mesh
from tpufem_torch.solve.newton import newton_krylov


def exact(x):
    return (9.0 - x[..., 0] ** 2) * (9.0 - x[..., 1] ** 2)


def f(x):
    return 36.0 - 2.0 * (x[..., 0] ** 2 + x[..., 1] ** 2) + exact(x) ** 3


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=512,
                    help="mesh lines per side (512 -> 263,169 DOFs)")
    ap.add_argument("--tol", type=float, default=1e-6,
                    help="relative residual (fp32 pipeline: ~1e-7 is the "
                    "floor)")
    ap.add_argument("--precond", choices=["jacobi", "amg"],
                    default="jacobi",
                    help="inner-CG preconditioner.  'amg' freezes an "
                    "interval-W hierarchy of the LINEAR part: it wins where "
                    "diffusion dominates; on this manufactured problem the "
                    "reaction term 3u^2 swamps the Laplacian near the "
                    "solution")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_of(args)

    t0 = time.perf_counter()
    mesh = rectangle_mesh(-3.0, 3.0, -3.0, 3.0, args.n, args.n)
    pat = ell_pattern(mesh.conn, mesh.num_nodes, pad_to=8,
                      with_sort_plan=False)
    t_host = time.perf_counter() - t0

    element = P1Triangle()
    rule = triangle_rule(5)
    ec = torch.as_tensor(mesh.element_coords(), dtype=torch.float32,
                         device=dev)
    conn = torch.as_tensor(mesh.conn, device=dev).long()
    nn = mesh.num_nodes
    A = assemble_ell(pat, p1_stiffness(ec, element))
    b = assemble_vector(conn, element_load(ec, element, rule, f), nn)
    bc = torch.as_tensor(mesh.node_flags != 0, device=dev)
    d = A.diagonal()
    inv_d = torch.where(bc, 1.0, torch.where(d != 0, 1.0 / d, 1.0))
    hier = None
    if args.precond == "amg":
        # frozen interval-W AMG of the BC-applied LINEAR operator: the
        # Jacobian is A_int + 3u^2 M_int, so it preconditions every Newton
        # step without a setup per step (the rectangle's numbering is
        # banded already: no RCM)
        from tpufem_torch.solve.amg import build_amg
        from tpufem_torch.solve.bc import apply_dirichlet_ell

        A_bc, _ = apply_dirichlet_ell(A, b, bc)
        hier = build_amg(A_bc, aggregation="interval", cycle="W")
        M = hier.apply
    else:
        def M(r):
            return r * inv_d

    def residual(u):
        ui = torch.where(bc, 0.0, u)
        nl = assemble_vector(conn, element_nonlinear_load(
            ec, element, rule, ui[conn], lambda w: w ** 3), nn)
        r = A.matvec(ui) + nl - b
        return torch.where(bc, u, r)

    def run():
        t0 = time.perf_counter()
        res = newton_krylov(residual, torch.zeros(nn, dtype=torch.float32,
                                                  device=dev),
                            tol=args.tol, maxiter=40, M=M)
        sync(dev)
        return res, time.perf_counter() - t0

    cold, t_wall = run()
    res, t_solve = run()

    u = res.x.double().cpu().numpy()
    ue = exact(mesh.coords)
    err = float(np.sqrt(np.mean((u - ue) ** 2))
                / np.sqrt(np.mean(ue ** 2)))
    out = {
        "metric": "semilinear_poisson_newton_krylov",
        "dofs": nn,
        "precond": args.precond,
        "newton_iters": res.iterations,
        "inner_cg_iters_total": res.inner_iterations,
        "relres": float(res.residual_norm),
        "converged": res.converged,
        "solve_s": round(t_solve, 3),
        "rel_l2_error_vs_exact": err,
        "walls_s": {"host": round(t_host, 2),
                    "compile": round(t_wall, 2)},
    }
    print(json.dumps(out))
    if not res.converged:
        raise SystemExit(1)
    return {**out, "x": res.x, "result": res, "cold": cold,
            "residual": residual, "M": M, "hier": hier, "A": A}


if __name__ == "__main__":
    main()
