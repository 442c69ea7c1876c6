"""Run-to-run spread of the unstructured Chebyshev(14)-PCG iteration count
on one NVIDIA GPU.

    python3 scripts/ell_pcg_spread.py [--n 1000] [--reps 4]

Builds chip_smoke.py's unstructured system once on the host (the 1000 x
1000 perturbed mesh, RCM, the ELL pattern), then assembles it on the card
``--reps`` times with each of two reductions and solves each to 1e-5 in
fp32 (``cg(check_every=2)``):

  * ``atomic``: ``index_add_``, whose float atomics add in an order that
    changes from run to run;
  * ``sorted``: ``index_put_(accumulate=True)``, which sorts the slot
    indices and adds each slot's entries in a fixed order.

Each line gives the iteration count, the final relres, whether the
assembled values equal the first repetition's bit for bit, and the rel
L2 error against the manufactured solution.  Then the same solve through
the entry point, ``solve_poisson_ell(precond="chebyshev",
matvec="pallas")`` on the mesh's random numbering (the port assembles with
the sorted reduction), ``--reps`` times.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    import numpy as np
    import torch

    from tpufem_torch.assemble.local import element_load, p1_stiffness
    from tpufem_torch.fem.elements import P1Triangle
    from tpufem_torch.fem.quadrature import triangle_rule
    from tpufem_torch.mesh.adjacency import ell_pattern, reverse_cuthill_mckee
    from tpufem_torch.mesh.rectangle import perturbed_rectangle_mesh
    from tpufem_torch.solve.bc import apply_dirichlet_ell
    from tpufem_torch.solve.cg import cg
    from tpufem_torch.solve.poisson import model_problem_2d, solve_poisson_ell
    from tpufem_torch.solve.precond import chebyshev, lambda_max_bound
    from tpufem_torch.sparse.ell import ELLMatrix

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ell_pcg_spread: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(f"# {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    m0 = perturbed_rectangle_mesh(-3, 3, -3, 3, args.n, args.n, jitter=0.25,
                                  seed=0)
    cols0 = ell_pattern(m0.conn, m0.num_nodes, pad_to=8,
                        with_sort_plan=False).cols
    perm = reverse_cuthill_mckee(cols0)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=perm.dtype)
    conn = inv[m0.conn].astype(np.int32)
    coords, flags = m0.coords[perm], m0.node_flags[perm]
    pat = ell_pattern(conn, m0.num_nodes, pad_to=8, with_sort_plan=False)
    nn, K = pat.cols.shape
    print(f"# host setup {time.perf_counter() - t0:.1f} s, {nn} rows")

    f, exact = model_problem_2d()
    el = P1Triangle()
    ec = torch.as_tensor(coords[conn], dtype=torch.float32, device=dev)
    conn_t = torch.as_tensor(conn, device=dev).long()
    slots = torch.as_tensor(pat.slots, device=dev).reshape(-1).long()
    cols = torch.as_tensor(pat.cols, device=dev)
    dpos = torch.as_tensor(pat.diag_pos, device=dev)
    mask = torch.as_tensor(flags != 0, device=dev)
    ue = torch.as_tensor(exact(coords), device=dev)

    def add(idx, vals, size, sorted_):
        out = torch.zeros(size, dtype=vals.dtype, device=dev)
        if sorted_:
            return out.index_put_((idx,), vals, accumulate=True)
        return out.index_add_(0, idx, vals)

    for mode in ("atomic", "sorted"):
        first = None
        for rep in range(args.reps):
            data = add(slots, p1_stiffness(ec, el).reshape(-1), nn * K,
                       mode == "sorted").reshape(nn, K)
            b = add(conn_t.reshape(-1),
                    element_load(ec, el, triangle_rule(5), f).reshape(-1),
                    nn, mode == "sorted")
            same = None if first is None else (
                torch.equal(data, first[0]) and torch.equal(b, first[1]))
            if first is None:
                first = (data, b)
            A, bb = apply_dirichlet_ell(
                ELLMatrix(data, cols, diag_pos=dpos), b, mask)
            A.resolve_band()
            M = chebyshev(A.matvec, A.diagonal(), degree=14,
                          lmax=lambda_max_bound(A))
            res = cg(A.matvec, bb, tol=1e-5, maxiter=3000, M=M,
                     check_every=2)
            err = (torch.linalg.vector_norm(res.x.double() - ue)
                   / torch.linalg.vector_norm(ue)).item()
            print(f"{mode} rep {rep}: {res.iterations} iterations, relres "
                  f"{res.residual_norm.item():.4e}, values equal to rep 0: "
                  f"{same}, rel L2 error {err:.4e}", flush=True)
    ue0 = torch.as_tensor(exact(m0.coords), device=dev)
    for rep in range(args.reps):
        sol = solve_poisson_ell(m0, precond="chebyshev", matvec="pallas",
                                dtype=torch.float32, tol=1e-5, device=dev)
        err = (torch.linalg.vector_norm(sol.u.double() - ue0)
               / torch.linalg.vector_norm(ue0)).item()
        print(f"entry rep {rep}: {sol.cg.iterations} iterations, relres "
              f"{sol.cg.residual_norm.item():.4e}, rel L2 error {err:.4e}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
