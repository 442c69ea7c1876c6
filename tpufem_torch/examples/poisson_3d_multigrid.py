"""3D Poisson at scale with MG-PCG, as examples/poisson_3d_multigrid.py:
the analytic multigrid hierarchy (general levels, the JAX example's
default), the RHS from batch-trailing element loads, PCG on the embedded
stencil product (K2) preconditioned by a V-cycle whose smoother is the
fused residual / sweep kernel (B4).

    python -m tpufem_torch.examples.poisson_3d_multigrid --n 96
    python -m tpufem_torch.examples.poisson_3d_multigrid --n 8 --device cpu
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from tpufem_torch.assemble.planar import element_coords_bt, element_load_bt
from tpufem_torch.assemble.structured import assemble_vector_structured_bt
from tpufem_torch.examples._common import add_device_arg, device_of, sync
from tpufem_torch.fem.quadrature import tetrahedron_rule
from tpufem_torch.mesh.box import box_mesh
from tpufem_torch.ops.stencil_cuda import stencil_matvec_embedded
from tpufem_torch.solve.cg import cg
from tpufem_torch.solve.multigrid import (build_poisson_multigrid,
                                          mg_preconditioner)
from tpufem_torch.solve.poisson import model_problem_3d, model_problem_3d_planes
from tpufem_torch.utils.logging import RunLogger


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=32,
                        help="cells per side (dyadic-friendly, e.g. 32/64/96)")
    parser.add_argument("--tol", type=float, default=1e-6)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    dev = device_of(args)
    log = RunLogger(stream=sys.stderr)

    n = args.n
    mesh = box_mesh(-3, 3, -3, 3, -3, 3, n, n, n)
    log.mesh_stats(mesh)

    t0 = time.perf_counter()
    levels = build_poisson_multigrid((-3.0, 3.0), n, 3, dtype=torch.float32,
                                     device=dev)
    top = levels[0]
    sync(dev)
    log.log("hierarchy", levels=len(levels),
            seconds=time.perf_counter() - t0)

    X = torch.as_tensor(element_coords_bt(mesh, np.float32), device=dev)
    be = element_load_bt(X, "tetrahedron", tetrahedron_rule(3),
                         model_problem_3d_planes())
    b = assemble_vector_structured_bt(top.plan, be)
    b = torch.where(top.bc_mask, 0.0, b)
    del X, be

    def mv(v):
        return stencil_matvec_embedded(top.data, v, top.plan)

    M = mg_preconditioner(levels, nu1=1, nu2=1)
    t0 = time.perf_counter()
    res = cg(mv, b, tol=args.tol, maxiter=100, M=M)
    sync(dev)
    seconds = time.perf_counter() - t0
    log.solve(res, seconds=seconds)

    _, exact = model_problem_3d()
    u = top.plan.extract_field(res.x).double().cpu().numpy()
    ue = exact(mesh.coords)
    rel = float(np.sqrt(np.mean((u - ue) ** 2)) / np.sqrt(np.mean(ue ** 2)))
    print(f"dofs={mesh.num_nodes} mg_levels={len(levels)} "
          f"iters={res.iterations} converged={res.converged} "
          f"rel_l2_err={rel:.3e}")
    return {"dofs": mesh.num_nodes, "mg_levels": len(levels),
            "iterations": res.iterations,
            "residual_norm": float(res.residual_norm),
            "converged": res.converged, "rel_l2_err": rel,
            "solve_s": seconds, "result": res, "u": u}


if __name__ == "__main__":
    main()
