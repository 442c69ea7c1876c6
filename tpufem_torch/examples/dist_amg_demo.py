"""Distributed unstructured AMG, as examples/dist_amg_demo.py: an
8-way sharded W-cycle PCG on the port's single-controller device mesh
(``dist.mesh``).

  1. a perturbed, randomly numbered triangle mesh;
  2. host RCM renumbering (``unstructured_1m.rcm_renumber``);
  3. ELL scatter assembly + Dirichlet elimination;
  4. ``build_dist_amg``: an interval-aggregation hierarchy sharded so
     that every transfer is shard-local;
  5. ``dist_amg_pcg``: W-cycle-preconditioned CG on the shards, halo
     exchanges for every product, shard-ordered sums for the dots, one
     gather for the dense coarsest solve.

The shards live on the card by default (every shard on ``cuda:0`` with one
card); ``--cpu`` puts them on the host.  The JAX example defaults to a
virtual CPU mesh instead.  No hand-written kernel runs here, as in the
reference.

    python -m tpufem_torch.examples.dist_amg_demo [--n 96] [--devices 8]
    python -m tpufem_torch.examples.dist_amg_demo --n 24 --cpu
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from tpufem_torch.assemble.dense import assemble_vector
from tpufem_torch.assemble.ell import assemble_ell
from tpufem_torch.assemble.local import element_load, p1_stiffness
from tpufem_torch.dist.amg import build_dist_amg, dist_amg_pcg
from tpufem_torch.dist.mesh import make_mesh
from tpufem_torch.examples._common import add_device_arg, device_of
from tpufem_torch.examples.unstructured_1m import rcm_renumber
from tpufem_torch.fem.elements import P1Triangle
from tpufem_torch.fem.quadrature import triangle_rule
from tpufem_torch.mesh.adjacency import ell_pattern
from tpufem_torch.mesh.rectangle import perturbed_rectangle_mesh
from tpufem_torch.solve.bc import apply_dirichlet_ell
from tpufem_torch.solve.poisson import model_problem_2d


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=96, help="mesh lines per side")
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--cpu", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="shards on the host (default: on the card)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    if args.cpu:
        args.device = "cpu"
    dev = device_of(args)

    mesh = perturbed_rectangle_mesh(-3, 3, -3, 3, args.n, args.n,
                                    jitter=0.25, seed=0)
    mesh = rcm_renumber(mesh)
    pat = ell_pattern(mesh.conn, mesh.num_nodes, pad_to=8)
    ec = torch.as_tensor(mesh.element_coords(),
                         dtype=torch.get_default_dtype(), device=dev)
    element = P1Triangle()
    A = assemble_ell(pat, p1_stiffness(ec, element))
    f, exact = model_problem_2d()
    b = assemble_vector(mesh.conn,
                        element_load(ec, element, triangle_rule(5), f),
                        mesh.num_nodes)
    A, b = apply_dirichlet_ell(A, b, torch.as_tensor(mesh.node_flags != 0,
                                                     device=dev))

    h = build_dist_amg(A.data, A.cols, args.devices,
                       coarse_n=max(300, args.n))
    print(f"# levels {[st.local_rows * args.devices for st in h.static]}"
          f" + coarse {h.coarse_inv.shape[0]}, halos"
          f" {[st.halo for st in h.static]}", file=sys.stderr)

    dmesh = make_mesh(args.devices, ("rows",), device=dev)
    x, res = dist_amg_pcg(h, b.cpu().numpy(), dmesh, tol=args.tol,
                          maxiter=100)

    u = x.double().cpu().numpy()
    ue = exact(mesh.coords)
    err = float(np.sqrt(np.mean((u - ue) ** 2))
                / np.sqrt(np.mean(ue ** 2)))
    out = {
        "metric": "dist_amg_wcycle_pcg",
        "rows": mesh.num_nodes,
        "devices": args.devices,
        "pcg_iters": int(res.iterations),
        "relres": float(res.residual_norm),
        "converged": bool(res.converged),
        "rel_l2_error_vs_exact": err,
    }
    print(json.dumps(out))
    if not bool(res.converged):
        raise SystemExit(1)
    return {**out, "x": x, "result": res, "hierarchy": h}


if __name__ == "__main__":
    main()
