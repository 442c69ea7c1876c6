"""Transient heat equation, as examples/heat_equation.py: the mass and
stiffness matrices from one weak-form frontend on one ELL pattern,
implicit Euler with A = M + dt K, a warm-started guarded Jacobi CG at
every step, and a checkpoint of the final state (``io.checkpoint``'s npz,
which the JAX package reads too).  On the card the products are the
banded ELL kernel (B9).

    python -m tpufem_torch.examples.heat_equation --cells 1000 --steps 20
    python -m tpufem_torch.examples.heat_equation --cells 32 --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from tpufem_torch.examples._common import add_device_arg, device_of, sync
from tpufem_torch.fem.space import FunctionSpace
from tpufem_torch.forms.language import dot, grad
from tpufem_torch.forms.weakform import WeakForm
from tpufem_torch.io.checkpoint import save_solution
from tpufem_torch.mesh.adjacency import ell_pattern
from tpufem_torch.mesh.rectangle import RectangleMesh
from tpufem_torch.solve.bc import apply_dirichlet_ell
from tpufem_torch.solve.cg import cg
from tpufem_torch.solve.precond import jacobi
from tpufem_torch.sparse.ell import ELLMatrix


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cells", type=int, default=32)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--dt", type=float, default=0.05)
    parser.add_argument("--checkpoint", default="")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    dev = device_of(args)
    dtype = torch.get_default_dtype()

    mesh = RectangleMesh(-3.0, 3.0, -3.0, 3.0, args.cells, args.cells)
    V = FunctionSpace(mesh, "Lagrange", 1)
    pattern = ell_pattern(V.dof_conn, V.num_dofs, pad_to=8)

    # stiffness K and mass M from the same frontend
    wf_k = WeakForm(V, dtype=dtype, device=dev).build(
        lambda u, v: dot(grad(u), grad(v)))
    wf_m = WeakForm(V, dtype=dtype, device=dev).build(lambda u, v: u * v)
    Kmat, _ = wf_k.assemble(format="ell", pattern=pattern)
    Mmat, _ = wf_m.assemble(format="ell", pattern=pattern)

    # system matrix A = M + dt K (same pattern: the values add)
    A = ELLMatrix(Mmat.data + args.dt * Kmat.data, Kmat.cols,
                  Kmat.row_lengths, Kmat.diag_pos)
    mask = torch.as_tensor(V.dof_flags, device=dev)
    b0 = torch.zeros(V.num_dofs, dtype=dtype, device=dev)
    A_bc, _ = apply_dirichlet_ell(A, b0, mask)
    M_pre = jacobi(A_bc)

    # initial condition: a hot blob
    c = mesh.coords
    u = torch.as_tensor(np.exp(-((c[:, 0]) ** 2 + (c[:, 1]) ** 2)),
                        dtype=dtype, device=dev)
    u = torch.where(mask, 0.0, u)

    def step(u):
        rhs = Mmat.matvec(u)
        rhs = torch.where(mask, 0.0, rhs)
        res = cg(A_bc.matvec, rhs, x0=u, tol=1e-10, maxiter=2000, M=M_pre)
        return res.x, res.iterations, res.residual_norm

    energy0 = float(Mmat.matvec(u) @ u)
    t0 = time.perf_counter()
    iterations = []
    for _ in range(args.steps):
        u, iters, rn = step(u)
        iterations.append(iters)
    sync(dev)
    wall = time.perf_counter() - t0
    energy = float(Mmat.matvec(u) @ u)
    total_iters = sum(iterations)
    print(f"dofs={V.num_dofs} steps={args.steps} dt={args.dt} "
          f"cg_iters_total={total_iters} "
          f"L2^2 {energy0:.4f} -> {energy:.4f} (decaying: "
          f"{energy < energy0}) wall={wall:.2f}s")
    out = {"dofs": V.num_dofs, "steps": args.steps, "dt": args.dt,
           "cg_iters_total": total_iters, "iterations": iterations,
           "l2sq0": energy0, "l2sq": energy, "decaying": energy < energy0,
           "residual_norm": float(rn), "wall_s": wall, "u": u}

    if args.checkpoint:
        save_solution(args.checkpoint, u, iterations=args.steps,
                      residual_norm=float(rn))
        print(f"checkpointed final state to {args.checkpoint}")
    return out


if __name__ == "__main__":
    main()
