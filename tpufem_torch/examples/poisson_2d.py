"""2D Poisson through the weak-form frontend, as examples/poisson_2d.py:
the configuration from ``config.py``'s flags, a ``RunLogger`` streaming to
stderr, weak-form ELL assembly, Dirichlet elimination and Jacobi PCG; on
the card every product is the banded ELL kernel (B9).

    python -m tpufem_torch.examples.poisson_2d --cells 64 [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from tpufem_torch.config import add_cli_args, from_cli
from tpufem_torch.examples._common import add_device_arg, device_of, sync
from tpufem_torch.fem.space import FunctionSpace
from tpufem_torch.forms.language import SpatialCoordinate, dot, grad
from tpufem_torch.forms.weakform import WeakForm
from tpufem_torch.mesh.rectangle import RectangleMesh
from tpufem_torch.solve.bc import apply_dirichlet_ell
from tpufem_torch.solve.cg import cg
from tpufem_torch.solve.poisson import model_problem_2d
from tpufem_torch.solve.precond import jacobi
from tpufem_torch.utils.logging import RunLogger


def main(argv=None):
    parser = argparse.ArgumentParser()
    add_cli_args(parser)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    dev = device_of(args)
    prob, solcfg = from_cli(args)
    log = RunLogger(stream=sys.stderr)

    n = prob.cells[0]
    mesh = RectangleMesh(-3.0, 3.0, -3.0, 3.0, n, n)
    log.mesh_stats(mesh)

    # the user's weak form
    V = FunctionSpace(mesh, "Lagrange", prob.degree)
    X = SpatialCoordinate(V)
    f = -2 * (X[0] * X[0] + X[1] * X[1]) + 36
    wf = WeakForm(V, dtype=torch.get_default_dtype(), device=dev).build(
        lambda u, v: dot(grad(u), grad(v)), lambda v: f * v)

    t0 = time.perf_counter()
    A, b = wf.assemble(format="ell")
    A, b = apply_dirichlet_ell(A, b, torch.as_tensor(V.dof_flags,
                                                     device=dev))
    sync(dev)
    log.assembly(num_dofs=V.num_dofs, seconds=time.perf_counter() - t0,
                 format="ell")

    M = jacobi(A) if solcfg.preconditioner == "jacobi" else None
    t0 = time.perf_counter()
    res = cg(A.matvec, b, tol=solcfg.tol, maxiter=solcfg.maxiter, M=M)
    sync(dev)
    log.solve(res, seconds=time.perf_counter() - t0)

    out = {"dofs": V.num_dofs, "iterations": res.iterations,
           "residual_norm": float(res.residual_norm),
           "converged": res.converged, "result": res, "x": res.x,
           "events": log.events}
    _, exact = model_problem_2d()
    if prob.degree == 1:
        ue = exact(mesh.coords)
        err = float(np.sqrt(np.mean((res.x.double().cpu().numpy() - ue)
                                    ** 2)))
        print(f"dofs={V.num_dofs} iters={res.iterations} "
              f"converged={res.converged} nodal_rms_err={err:.3e}")
        out["nodal_rms_err"] = err
    return out


if __name__ == "__main__":
    main()
