"""Unstructured elasticity at scale: BCSR + banded block SpMV +
block-AMG, as examples/elasticity_unstructured.py: a perturbed triangle
mesh -> RCM -> BCSR assembly (2 x 2 node blocks) -> PCG on the banded
block kernel (B12; ``--matvec gather``: the BCSR product, B12 where the
bandwidth allows, else its gather form B12g), preconditioned by
block-Jacobi or the rigid-body-mode block SA AMG (solve/amg_block.py).

    python -m tpufem_torch.examples.elasticity_unstructured [--n 700] [--precond amg]
    python -m tpufem_torch.examples.elasticity_unstructured --n 20 --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from tpufem_torch.examples._common import add_device_arg, device_of, sync
from tpufem_torch.mesh.rectangle import perturbed_rectangle_mesh
from tpufem_torch.solve.elasticity import solve_elasticity

# --matvec's names -> solve_elasticity's (the reference's "pallas")
_MATVEC = {"cuda": "pallas", "gather": "gather"}


def body_force(x):
    return torch.stack([0 * x[..., 0] + 1.0, 0 * x[..., 1] - 0.5], dim=-1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=700,
                    help="mesh lines per side (700 -> 982,802 DOFs)")
    ap.add_argument("--lam", type=float, default=1.0)
    ap.add_argument("--mu", type=float, default=1.0)
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--precond", choices=["amg", "jacobi"], default="amg")
    ap.add_argument("--matvec", choices=["cuda", "gather"], default="cuda")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_of(args)

    t0 = time.perf_counter()
    mesh = perturbed_rectangle_mesh(-1.0, 1.0, -1.0, 1.0, args.n, args.n,
                                    jitter=0.2, seed=0)
    t_mesh = time.perf_counter() - t0

    t0 = time.perf_counter()
    sol = solve_elasticity(
        mesh, lam=args.lam, mu=args.mu, body_force=body_force,
        dtype=torch.float32, tol=args.tol, maxiter=3000,
        matvec=_MATVEC[args.matvec], precond=args.precond, device=dev)
    sync(dev)
    t_total = time.perf_counter() - t0

    out = {
        "metric": "unstructured_elasticity_bcsr_pcg",
        "dofs": sol.space.num_dofs,
        "elements": mesh.num_elements,
        "precond": args.precond,
        "matvec": args.matvec,
        "lam_over_mu": args.lam / args.mu,
        "pcg_iters": sol.cg.iterations,
        "relres": float(sol.cg.residual_norm),
        "converged": sol.cg.converged,
        "solve_ms": round(sol.walls.get("solve", 0.0) * 1e3, 2),
        "dofs_per_sec": round(sol.space.num_dofs
                              / max(sol.walls.get("solve", 0.0), 1e-9), 1),
        "walls_s": {"mesh": round(t_mesh, 2),
                    "total": round(t_total, 2),
                    **{k: (round(v, 2) if isinstance(v, float) else v)
                       for k, v in sol.walls.items()}},
    }
    print(json.dumps(out))
    if not sol.cg.converged:
        raise SystemExit(1)
    return {**out, "u": sol.u, "result": sol.cg}


if __name__ == "__main__":
    main()
