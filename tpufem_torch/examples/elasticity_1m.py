"""3D elasticity at about 1M DOFs on one card, as examples/elasticity_1m.py:
a clamped box, a manufactured polynomial displacement, analytic
block-stencil assembly (no element arrays), PCG on the block-stencil
product preconditioned by 3 x 3 block-Jacobi (or ``--precond mg``, the
vector geometric multigrid).  The per-iteration time is the reference's
rep-difference (``utils.timing.device_seconds_per_rep``) over the
fixed-iteration PCG on the same operator.  Prints one JSON line with
DOFs/s, iterations and the relative L2 error against the manufactured
solution.  No hand-written kernel runs here (the block stencil is plain
PyTorch on the card).

    python -m tpufem_torch.examples.elasticity_1m --n 69    # 70^3 * 3 = 1,029,000 DOFs
    python -m tpufem_torch.examples.elasticity_1m --n 8 --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from tpufem_torch.examples._common import add_device_arg, device_of, sync


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=69)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--precond", choices=("jacobi", "mg"), default="jacobi",
                    help="mg needs n to halve down to <= 8-ish (e.g. 72)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_of(args)

    from tpufem_torch.assemble.structured import structured_plan
    from tpufem_torch.solve.cg import cg_fixed
    from tpufem_torch.solve.elasticity_structured import (
        _apply_bc_blocks, block_stencil_matvec, elasticity_stencil_data,
        manufactured_elasticity_3d, solve_elasticity_box,
        uniform_cell_matrices)
    from tpufem_torch.solve.multigrid import _embed_grid_numpy, _light_grid
    from tpufem_torch.utils.timing import device_seconds_per_rep

    lam, mu = 1.2, 0.8
    u_exact, f = manufactured_elasticity_3d(lam, mu)

    t0 = time.perf_counter()
    sol = solve_elasticity_box((-3.0, 3.0), args.n, lam=lam, mu=mu,
                               body_force=f, dtype=torch.float32,
                               tol=args.tol, maxiter=4000,
                               precond=args.precond, device=dev)
    sync(dev)
    wall = time.perf_counter() - t0

    info, coords_grid, _ = _light_grid((-3.0, 3.0), args.n, 3)
    ue = u_exact(coords_grid[0], coords_grid[1],
                 coords_grid[2]).reshape(3, -1)
    u = sol.u.cpu().numpy()
    err = float(np.linalg.norm(u - ue) / np.linalg.norm(ue))
    iters = sol.cg.iterations

    # per-iteration device time: rep-difference over the fixed-iteration
    # PCG on the same operator
    plan = structured_plan(info, embed=True)
    Ke1, _ = uniform_cell_matrices((-3.0, 3.0), args.n, lam, mu)
    data_np = elasticity_stencil_data(plan, Ke1, np.float32)
    mask_np = _embed_grid_numpy(
        _light_grid((-3.0, 3.0), args.n, 3)[2], plan.store_grid, fill=False)
    data_np = _apply_bc_blocks(data_np, plan.offsets, mask_np)
    diag_k = plan.offsets.index(0)
    D = np.moveaxis(data_np[diag_k], -1, 0)
    Dinv = np.linalg.inv(D + np.where(
        np.abs(np.linalg.det(D)) < 1e-30, 1.0, 0.0)[:, None, None]
        * np.eye(3))
    Dinv = np.moveaxis(Dinv, 0, -1).astype(np.float32)
    data = torch.as_tensor(data_np, device=dev)
    Minv = torch.as_tensor(Dinv, device=dev)
    b = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (3, plan.num_store_rows)).astype(np.float32), device=dev)

    offsets = plan.offsets

    def matvec(v):
        return block_stencil_matvec(data, v, offsets)

    if args.precond == "mg":
        from tpufem_torch.solve.elasticity_structured import (
            build_elasticity_multigrid, elastic_mg_preconditioner)
        levels = build_elasticity_multigrid((-3.0, 3.0), args.n, lam=lam,
                                            mu=mu, dtype=torch.float32,
                                            device=dev)
        M = elastic_mg_preconditioner(levels, nu1=1, nu2=1)
    else:
        def M(r):
            return (Minv * r[None]).sum(dim=1)

    def pcg_reps(iters):
        x, _ = cg_fixed(matvec, b, iters, M=M)
        return x

    t_iter = device_seconds_per_rep(pcg_reps, reps_low=10, reps_high=60)

    ndofs = sol.num_dofs
    total_s = iters * t_iter
    out = {
        "metric": "3d_elasticity_1M_block_stencil_pcg",
        "num_dofs": ndofs,
        "pcg_iters": iters,
        "pcg_relres": float(sol.cg.residual_norm),
        "pcg_iter_ms": round(t_iter * 1e3, 4),
        "solve_ms": round(total_s * 1e3, 2),
        "dofs_per_sec": round(ndofs / total_s, 1),
        "precond": args.precond,
        "rel_l2_error_vs_exact": err,
        "wall_s_incl_compile": round(wall, 1),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
    }
    print(json.dumps(out))
    return {**out, "converged": sol.cg.converged, "u": sol.u,
            "result": sol.cg}


if __name__ == "__main__":
    main()
