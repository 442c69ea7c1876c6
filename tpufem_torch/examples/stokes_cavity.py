"""Stokes lid-driven cavity, as examples/stokes_cavity.py: Taylor-Hood
P2-P1, the saddle-point system [[A, B^T], [B, 0]] applied matrix-free and
solved by MINRES with the block preconditioner (the velocity block one
scalar-AMG V-cycle per component, or diag(A); the pressure mass) of
``solve.stokes``.  On the card the V-cycles' level products are the banded
ELL kernel (B9).

``walls_s`` holds ``solve_stokes``'s walls (build, precond_setup and its
detail, solve); the JAX example's ``solve_compile`` has no counterpart,
since nothing is compiled.

    python -m tpufem_torch.examples.stokes_cavity [--n 96] [--vprecond jacobi]
    python -m tpufem_torch.examples.stokes_cavity --n 8 --f64 --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from tpufem_torch.examples._common import add_device_arg, device_of
from tpufem_torch.mesh.rectangle import rectangle_mesh
from tpufem_torch.solve.stokes import solve_stokes


def lid(X):
    """Regularized lid: u_x = 16 x^2 (1-x)^2 on the top edge (corners 0)."""
    on_top = (np.abs(X[..., 1] - 1.0) < 1e-12).astype(float)
    profile = 16.0 * (X[..., 0] * (1 - X[..., 0])) ** 2
    return np.stack([on_top * profile, 0.0 * X[..., 0]], axis=-1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=96,
                    help="cells per side (96 -> ~75k velocity DOFs; "
                    "512 -> ~2.1M)")
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--viscosity", type=float, default=1.0)
    ap.add_argument("--f64", action="store_true",
                    help="solve in float64 (default float32)")
    ap.add_argument("--vprecond", choices=["amg", "jacobi"],
                    default="amg",
                    help="velocity-block preconditioner: amg = one "
                    "scalar-AMG V-cycle per component (mesh-robust MINRES "
                    "iterations); jacobi = diag(A)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_of(args)

    t0 = time.perf_counter()
    mesh = rectangle_mesh(0.0, 1.0, 0.0, 1.0, args.n, args.n)
    t_mesh = time.perf_counter() - t0

    sol = solve_stokes(mesh, bc_velocity=lid, viscosity=args.viscosity,
                       dtype=torch.float64 if args.f64 else torch.float32,
                       tol=args.tol, maxiter=50_000,
                       velocity_precond=args.vprecond, device=dev)

    u = sol.u.reshape(-1, 2)
    X = sol.V.scalar_dof_coords
    # centerline u_x minimum, the classic cavity diagnostic
    center = torch.as_tensor(np.abs(X[:, 0] - 0.5) < 1e-9, device=dev)
    ux_min = float(u[center, 0].min())

    out = {
        "metric": "stokes_cavity_taylor_hood_minres",
        "dtype": "float64" if args.f64 else "float32",
        "vprecond": args.vprecond,
        "velocity_dofs": sol.V.num_dofs,
        "pressure_dofs": sol.Q.num_scalar_dofs,
        "minres_iters": sol.res.iterations,
        "relres": float(sol.res.residual_norm),
        "converged": sol.res.converged,
        "centerline_ux_min": ux_min,
        "walls_s": {"mesh": round(t_mesh, 2),
                    **{k: ({kk: (round(vv, 2) if isinstance(vv, float)
                                 else vv) for kk, vv in v.items()}
                           if isinstance(v, dict) else round(v, 2))
                       for k, v in sol.walls.items()}},
    }
    print(json.dumps(out))
    if not sol.res.converged:
        raise SystemExit(1)
    return {**out, "solution": sol}


if __name__ == "__main__":
    main()
