"""Modal analysis: the smallest k eigenpairs of the FEM Laplacian on an
unstructured mesh, as examples/modal_analysis.py, by block inverse
subspace iteration (``solve.eigen``):

  1. a perturbed triangle mesh, RCM-renumbered (``rcm_renumber``);
  2. the stiffness (ELL) and the lumped mass assembled on the device;
  3. the q = k + buffer inner solves in LOCKSTEP (``cg_fixed_block``) over
     the multi-RHS banded ELL product (``ELLMatrix.matvec_multi``: B10 on
     the card), preconditioned by the greedy-SA AMG V-cycle's multi-RHS
     cycle (``AMGHierarchy.apply_multi``); ``--serial`` solves column by
     column instead (B9);
  4. mixed precision (the default): the stiffness is assembled in fp64,
     its Dirichlet rows eliminated, and cast to fp32 for the inner solves;
     the refinement residuals and the Gram matrices are fp64, their
     products the fp64 values through ``ell_matvec_multi`` (B10's
     absolute-column form);
  5. the golden check: the Dirichlet eigenvalues of the (-3,3)² square are
     pi² (i² + j²) / 36, met to O(h²).

The subspace iteration runs twice: the first, cold pass is
``walls_s.solve_compile``, the second ``solve_ms``.  ``--outer-chunk c``
runs the outer loop in chunks of c steps, each ending in a synchronize
(the JAX example's one compiled execution per chunk), with ``--outer``
rounded up to whole chunks; the steps are the same, so with a whole number
of chunks the eigenvalues are bit for bit those of ``--outer-chunk 0``.

    python -m tpufem_torch.examples.modal_analysis [--n 700] [--k 5] [--serial]
    python -m tpufem_torch.examples.modal_analysis --n 24 --device cpu
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from tpufem_torch.assemble.dense import assemble_vector
from tpufem_torch.assemble.ell import assemble_ell
from tpufem_torch.assemble.local import element_mass, p1_stiffness
from tpufem_torch.examples._common import add_device_arg, device_of, sync
from tpufem_torch.examples.unstructured_1m import rcm_renumber
from tpufem_torch.fem.elements import P1Triangle
from tpufem_torch.fem.quadrature import triangle_rule
from tpufem_torch.mesh.adjacency import ell_pattern
from tpufem_torch.mesh.rectangle import perturbed_rectangle_mesh
from tpufem_torch.solve.bc import apply_dirichlet_ell
from tpufem_torch.solve.eigen import subspace_stepper
from tpufem_torch.solve.precond import jacobi
from tpufem_torch.sparse.ell import ELLMatrix, ell_matvec_multi


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=700,
                    help="mesh lines per side (700 -> 491,401 DOFs; "
                    "1000 -> 1,002,001)")
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--buffer", type=int, default=3)
    ap.add_argument("--inner", type=int, default=None,
                    help="CG iterations per inverse application "
                    "(default: 20 for amg, 60 otherwise)")
    ap.add_argument("--outer", type=int, default=25)
    ap.add_argument("--inner-precond", choices=["amg", "chebyshev",
                                                "jacobi"],
                    default="amg",
                    help="inner-CG preconditioner.  amg (default): the "
                    "greedy-SA V-cycle through the multi-RHS cycle "
                    "(hier.apply_multi), the only one whose inverse "
                    "application stays accurate as cond(A) ~ 1/h^2 grows; "
                    "chebyshev / jacobi kept for the A/B record")
    ap.add_argument("--serial", action="store_true",
                    help="column-serial inner solves, for the A/B against "
                    "the batched default")
    ap.add_argument("--jitter", type=float, default=0.25)
    ap.add_argument("--no-mixed", action="store_true",
                    help="disable mixed precision (pure fp32): the fp32 "
                    "product's floor eps32 * cond(A) ~ 1/h^2 makes the "
                    "eigenvalues wrong past ~100k DOFs whatever the inner "
                    "solver; kept for the A/B record")
    ap.add_argument("--outer-chunk", type=int, default=None,
                    help="run the outer loop in chunks of this many "
                    "subspace steps, each ending in a synchronize (0 = one "
                    "run; default 5 at >= 800k DOFs, else 0); --outer is "
                    "rounded up to whole chunks")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_of(args)
    mixed = not args.no_mixed
    n = args.n

    t0 = time.perf_counter()
    mesh = perturbed_rectangle_mesh(-3, 3, -3, 3, n, n,
                                    jitter=args.jitter, seed=0)
    mesh = rcm_renumber(mesh)
    pat = ell_pattern(mesh.conn, mesh.num_nodes, pad_to=8)
    t_host = time.perf_counter() - t0
    nn = mesh.num_nodes
    print(f"# {nn} DOFs, {mesh.num_elements} elements, host {t_host:.2f}s",
          file=sys.stderr)

    element = P1Triangle()
    rule = triangle_rule(5)
    # mixed: assemble once in fp64 so the fp64 residual operator is the
    # exact discretization, then cast down for the fp32 inner solves
    asm_dtype = torch.float64 if mixed else torch.float32
    ec = torch.as_tensor(mesh.element_coords(), dtype=asm_dtype, device=dev)
    conn = torch.as_tensor(mesh.conn, device=dev).long()
    bc = torch.as_tensor(mesh.node_flags != 0, device=dev)

    t0 = time.perf_counter()
    A = assemble_ell(pat, p1_stiffness(ec, element))
    A, _ = apply_dirichlet_ell(A, torch.zeros(nn, dtype=ec.dtype,
                                              device=dev), bc)
    Me = element_mass(ec, element, rule)
    mL = assemble_vector(conn, Me.sum(-1), nn)
    # constrained rows carry A = I; unit mass puts them at lambda = 1, far
    # above the smallest interior modes (~pi^2 / 18)
    mL = torch.where(bc, 1.0, mL)
    data64 = None
    if mixed:
        data64 = A.data
        A = ELLMatrix(A.data.float(), A.cols, A.row_lengths, A.diag_pos)
    A.resolve_band()
    sync(dev)
    t_asm = time.perf_counter() - t0

    inner = args.inner
    hier, t_psetup, setup_walls = None, 0.0, {}
    if args.inner_precond == "amg":
        from tpufem_torch.solve.amg import build_amg

        inner = 20 if inner is None else inner
        t0 = time.perf_counter()
        hier = build_amg(A, strength=0.08, walls_out=setup_walls)
        sync(dev)
        t_psetup = time.perf_counter() - t0
        M1, Mq = hier.apply, hier.apply_multi
    elif args.inner_precond == "chebyshev":
        from tpufem_torch.solve.precond import chebyshev, lambda_max_bound

        lmax = lambda_max_bound(A)
        M1 = chebyshev(A.matvec, A.diagonal(), degree=10, lmax=lmax)
        Mq = chebyshev(A.matvec_multi, A.diagonal(), degree=10, lmax=lmax)
    else:
        M1, Mq = jacobi(A), None
    inner = 60 if inner is None else inner

    kw = dict(lumped_mass=mL, M=M1, bc_mask=bc, inner_iters=inner,
              outer_iters=args.outer, buffer=args.buffer,
              dtype=torch.float32, device=dev)
    if not args.serial:
        kw.update(matvec_multi=A.matvec_multi, M_multi=Mq)
    if data64 is not None:
        kw["matvec_hi_multi"] = lambda X: ell_matvec_multi(data64, A.cols, X)

    chunk = args.outer_chunk
    if chunk is None:
        chunk = 5 if nn >= 800_000 else 0
    if chunk:
        # whole chunks only; round the outer count up and report it
        args.outer = -(-args.outer // chunk) * chunk
        kw["outer_iters"] = args.outer
    X0, step, finish = subspace_stepper(A.matvec, nn, args.k, **kw)
    runs = [chunk] * (args.outer // chunk) if chunk else [args.outer]

    def full_pass():
        X = X0
        for steps in runs:
            for _ in range(steps):
                X = step(X)
            sync(dev)
        res = finish(X)
        sync(dev)
        return res, X

    t0 = time.perf_counter()
    full_pass()                                      # cold
    t_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    res, X = full_pass()                             # warm, timed
    t_solve = time.perf_counter() - t0

    lam = res.eigenvalues.double().cpu().numpy()
    exact = np.array(sorted(np.pi ** 2 / 36 * (i * i + j * j)
                            for i in range(1, 6)
                            for j in range(1, 6)))[:args.k]
    lam_err = float(np.abs(lam - exact).max() / exact.max())
    out = {
        "metric": "modal_smallest_k_unstructured",
        "dofs": nn,
        "k": args.k,
        "mode": "serial" if args.serial else "batched",
        "outer_chunk": chunk,
        "precision": "mixed" if mixed else "fp32",
        "inner_precond": args.inner_precond,
        "inner_iters": inner,
        "outer_iters": args.outer,
        "eigenvalues": [round(float(v), 8) for v in lam],
        "exact": [round(float(v), 8) for v in exact],
        "rel_eig_err_vs_analytic": lam_err,
        "max_residual": float(res.residual_norms.max()),
        "solve_ms": round(t_solve * 1e3, 2),
        "walls_s": {"host": round(t_host, 2),
                    "assemble": round(t_asm, 2),
                    "precond_setup": round(t_psetup, 2),
                    "precond_setup_detail": {
                        k: (round(v, 2) if isinstance(v, float) else v)
                        for k, v in setup_walls.items()},
                    "solve_compile": round(t_wall, 2)},
    }
    print(json.dumps(out))
    # O(h^2) discretization + fp32 floor; written as `not (ok)` so a NaN
    # eigenvalue fails
    ret = {**out, "result": res, "X": X, "A": A, "data64": data64,
           "mL": mL, "hier": hier}
    if not (lam_err <= 5e-3 + 40.0 / (n * n)):
        raise SystemExit(1)
    return ret


if __name__ == "__main__":
    main()
