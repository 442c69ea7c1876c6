"""Unstructured 1M-row end-to-end: assemble + PCG, as
examples/unstructured_1m.py.

  1. a perturbed, randomly numbered triangle mesh (no stencil structure);
  2. host RCM renumbering (``rcm_renumber``, on the native library's
     neighbour lists) -> a bandwidth of about one mesh line;
  3. scatter assembly on the device (``assemble.ell``'s deterministic
     slot accumulation);
  4. PCG where every product is the banded ELL kernel (B9), preconditioned
     by Chebyshev-Jacobi (default), Jacobi, or the smoothed-aggregation
     AMG V-cycle (``--precond amg``, solve/amg.py).

The build and the solve each run twice; the second of each is timed
(the JAX example's first runs compile).

    python -m tpufem_torch.examples.unstructured_1m [--n 1000] [--precond amg]
    python -m tpufem_torch.examples.unstructured_1m --n 40 --device cpu
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from tpufem_torch.assemble.dense import assemble_vector
from tpufem_torch.assemble.ell import ell_values_scatter
from tpufem_torch.assemble.local import element_load, p1_stiffness
from tpufem_torch.examples._common import add_device_arg, device_of, sync
from tpufem_torch.fem.elements import P1Triangle
from tpufem_torch.fem.quadrature import triangle_rule
from tpufem_torch.mesh.adjacency import ell_pattern, reverse_cuthill_mckee
from tpufem_torch.mesh.core import Mesh
from tpufem_torch.mesh.rectangle import perturbed_rectangle_mesh
from tpufem_torch.solve.bc import apply_dirichlet_ell
from tpufem_torch.solve.cg import cg
from tpufem_torch.solve.poisson import model_problem_2d
from tpufem_torch.solve.precond import (chebyshev, estimate_lambda_max,
                                        jacobi, lambda_max_bound)
from tpufem_torch.sparse.ell import ELLMatrix


def rcm_renumber(mesh: Mesh, pad_to: int = 8):
    """Renumber mesh nodes with RCM so the assembled matrix is banded.

    RCM needs only the adjacency columns: the native library's neighbour
    lists where it is available, else the pattern's columns.  A native
    call that fails raises."""
    from tpufem_torch import native

    if native.available():
        _, cols = native.node_adjacency(mesh.conn, mesh.num_nodes)
    else:
        cols = ell_pattern(mesh.conn, mesh.num_nodes, pad_to=pad_to,
                           with_sort_plan=False).cols
    perm = reverse_cuthill_mckee(cols)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=perm.dtype)
    return Mesh(coords=np.ascontiguousarray(mesh.coords[perm]),
                conn=inv[mesh.conn].astype(mesh.conn.dtype),
                node_flags=np.ascontiguousarray(mesh.node_flags[perm]),
                cell_type=mesh.cell_type)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1000,
                    help="mesh lines per side (default 1000 -> 1,002,001 "
                    "rows, 2M elements)")
    ap.add_argument("--degree", type=int, default=14,
                    help="Chebyshev polynomial degree")
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--precond", choices=["amg", "chebyshev", "jacobi"],
                    default="chebyshev",
                    help="amg = smoothed-aggregation V-cycle (solve/amg.py)"
                    "; chebyshev = polynomial Jacobi (no setup); jacobi = "
                    "diagonal")
    ap.add_argument("--agg", choices=["interval", "greedy"],
                    default="greedy",
                    help="AMG aggregation: greedy = classical Vanek with "
                    "banded transfers; interval = stride-window aggregation")
    ap.add_argument("--strength", type=float, default=0.08,
                    help="SA strength-of-connection threshold for greedy "
                    "aggregation (0 = off; 0.08 classical)")
    ap.add_argument("--cycle", choices=["W", "V"], default="V",
                    help="AMG cycle")
    ap.add_argument("--lmax", choices=["bound", "power"], default="bound",
                    help="lmax for the Chebyshev interval: 'bound' = "
                    "Gershgorin row sums (guaranteed safe); 'power' = "
                    "power iteration (underestimates at 1M rows)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_of(args)
    n = args.n

    t0 = time.perf_counter()
    mesh = perturbed_rectangle_mesh(-3, 3, -3, 3, n, n, jitter=0.25, seed=0)
    mesh = rcm_renumber(mesh)
    pat = ell_pattern(mesh.conn, mesh.num_nodes, pad_to=8,
                      with_sort_plan=False)
    t_host = time.perf_counter() - t0
    nn = mesh.num_nodes
    bw = int(np.abs(pat.cols.astype(np.int64)
                    - np.arange(nn)[:, None]).max())
    print(f"# {nn} rows, {mesh.num_elements} elements, RCM bandwidth {bw}, "
          f"host setup {t_host:.2f}s", file=sys.stderr)

    element = P1Triangle()
    rule = triangle_rule(5)
    f, exact = model_problem_2d()
    ec = torch.as_tensor(mesh.element_coords(), dtype=torch.float32,
                         device=dev)
    conn = torch.as_tensor(mesh.conn, device=dev)
    bc = torch.as_tensor(mesh.node_flags != 0, device=dev)
    slots = torch.as_tensor(pat.slots.reshape(-1), device=dev)
    width = pat.cols.shape[1]

    def build():
        Ke = p1_stiffness(ec, element)
        data = ell_values_scatter(slots, Ke, nn, width)
        be = element_load(ec, element, rule, f)
        b = assemble_vector(conn, be, nn)
        sync(dev)
        return data, b

    t0 = time.perf_counter()
    data, b = build()
    t_build_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    data, b = build()
    t_build = time.perf_counter() - t0

    A = ELLMatrix(data, torch.as_tensor(pat.cols, device=dev),
                  diag_pos=torch.as_tensor(pat.diag_pos, device=dev))
    A, b = apply_dirichlet_ell(A, b, bc)
    A.resolve_band()

    t0 = time.perf_counter()
    setup_detail = {}
    if args.precond == "amg":
        from tpufem_torch.solve.amg import build_amg
        hier = build_amg(A, aggregation=args.agg, cycle=args.cycle,
                         strength=args.strength, walls_out=setup_detail)
        print(f"# AMG: levels {[lv.A.shape[0] for lv in hier.levels]}"
              f" + coarse {hier.coarse_inv.shape[0]}, operator complexity"
              f" {hier.operator_complexity:.2f}, {args.cycle}-cycle",
              file=sys.stderr)

        def solve():
            return cg(A.matvec, b, tol=args.tol, maxiter=3000, M=hier.apply,
                      check_every=2)
    elif args.precond == "chebyshev":
        if args.lmax == "bound":
            lmax = lambda_max_bound(A)
        else:
            lmax = estimate_lambda_max(A.matvec, A.diagonal(), nn,
                                       dtype=A.dtype)

        def solve():
            M = chebyshev(A.matvec, A.diagonal(), degree=args.degree,
                          lmax=lmax)
            return cg(A.matvec, b, tol=args.tol, maxiter=3000, M=M,
                      check_every=2)
    else:
        def solve():
            return cg(A.matvec, b, tol=args.tol, maxiter=3000, M=jacobi(A),
                      check_every=2)
    sync(dev)
    t_precond = time.perf_counter() - t0

    t0 = time.perf_counter()
    res = solve()
    sync(dev)
    t_solve_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = solve()
    sync(dev)
    t_solve = time.perf_counter() - t0

    ue = exact(mesh.coords)
    u = res.x.double().cpu().numpy()
    err = float(np.sqrt(np.mean((u - ue) ** 2))
                / np.sqrt(np.mean(ue ** 2)))
    out = {
        "metric": "unstructured_1m_assemble_chebpcg",
        "rows": nn,
        "elements": mesh.num_elements,
        "rcm_bandwidth": bw,
        "precond": args.precond,
        "cheb_degree": args.degree if args.precond == "chebyshev" else 0,
        "lmax_mode": args.lmax if args.precond == "chebyshev" else None,
        "amg_agg": args.agg if args.precond == "amg" else None,
        "amg_cycle": args.cycle if args.precond == "amg" else None,
        "amg_strength": args.strength if args.precond == "amg" else None,
        "pcg_iters": res.iterations,
        "relres": float(res.residual_norm),
        "converged": res.converged,
        "assemble_ms": round(t_build * 1e3, 2),
        "solve_ms": round(t_solve * 1e3, 2),
        "total_ms": round((t_build + t_solve) * 1e3, 2),
        "dofs_per_sec": round(nn / (t_build + t_solve), 1),
        "rel_l2_error_vs_exact": err,
        "walls_s": {"host": round(t_host, 2),
                    "build_compile": round(t_build_wall, 2),
                    "precond_setup": round(t_precond, 2),
                    "precond_setup_detail": {
                        k: (round(v, 2) if isinstance(v, float) else v)
                        for k, v in setup_detail.items()},
                    "solve_compile": round(t_solve_wall, 2),
                    "aot_cache": {}},
    }
    print(json.dumps(out))
    if not res.converged:
        raise SystemExit(1)
    return {**out, "x": res.x, "result": res, "mesh": mesh}


if __name__ == "__main__":
    main()
