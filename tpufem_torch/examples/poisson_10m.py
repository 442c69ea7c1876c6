"""The 10M-57M-DOF 3D Poisson demo, as examples/poisson_10m.py: the
guarded ``solve_poisson_fast`` on the model problem, its operator built
on the card by the fused kernel (K1) and never formed as an indexed
sparse structure, MG-PCG on the stencil product (K2), the const
multigrid's smoother (B5) and its fused transfers (K3, K4).

    python -m tpufem_torch.examples.poisson_10m            # n=224: 11,390,625 DOFs
    python -m tpufem_torch.examples.poisson_10m --n 384    # 57,066,625 DOFs
    python -m tpufem_torch.examples.poisson_10m --n 16 --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from tpufem_torch.examples._common import add_device_arg, device_of
from tpufem_torch.solve.multigrid import _light_grid
from tpufem_torch.solve.poisson import model_problem_3d, model_problem_3d_planes
from tpufem_torch.solve.structured_fast import solve_poisson_fast


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=224)
    parser.add_argument("--tol", type=float, default=1e-5)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    dev = device_of(args)

    sol = solve_poisson_fast((-3.0, 3.0), args.n,
                             model_problem_3d_planes(), tol=args.tol,
                             device=dev)

    _, exact = model_problem_3d()
    _, coords_grid, _ = _light_grid((-3.0, 3.0), args.n, 3)
    coords = np.moveaxis(coords_grid, 0, -1).reshape(-1, 3)
    ue = exact(coords).astype(np.float32)
    u = sol.u.cpu().numpy()
    rel = float(np.sqrt(np.mean((u - ue) ** 2)) / np.sqrt(np.mean(ue ** 2)))
    print(f"dofs={sol.num_dofs} iters={sol.cg.iterations} "
          f"converged={sol.cg.converged} rel_l2_err={rel:.3e} "
          f"phases={sol.phases_s}")
    return {"dofs": sol.num_dofs, "iterations": sol.cg.iterations,
            "residual_norm": float(sol.cg.residual_norm),
            "converged": sol.cg.converged, "rel_l2_err": rel,
            "phases_s": sol.phases_s, "u": sol.u}


if __name__ == "__main__":
    main()
