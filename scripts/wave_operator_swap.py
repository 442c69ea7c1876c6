"""Which of the fp32 wave's two parts sets its period-return error and its
energy drift: the assembled operator or the time stepping.

    python scripts/physics_jax_reference.py wave 250 ops.npz
    python scripts/wave_operator_swap.py ops.npz --device cpu

The first command (the JAX package, fp32) writes its fp32 stiffness and
lumped mass, the same assembled in fp64 and cast to fp32, and its run's
u0, mask, dt and steps.  This script (torch only) assembles the port's
operators of the same mesh the same two ways and steps each of the four
with the port's leapfrog_wave at the JAX run's dt and steps (examples/
wave_equation.py's one period of the (1,1) mode).  One JSON line per
operator: its return error, its energy drift, the largest |row sum| of
its interior rows (zero in exact arithmetic) and its largest difference
from the JAX package's operator assembled the same way.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main():
    from tpufem_torch.fem.space import FunctionSpace
    from tpufem_torch.forms.language import dot, grad
    from tpufem_torch.forms.weakform import WeakForm
    from tpufem_torch.mesh.rectangle import unit_square_mesh
    from tpufem_torch.solve.dynamics import leapfrog_wave, lumped_mass
    from tpufem_torch.sparse.ell import ELLMatrix

    parser = argparse.ArgumentParser()
    parser.add_argument("ops")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    dev = args.device
    z = np.load(args.ops)
    n = z["u0"].shape[0]
    cells = int(round(n ** 0.5)) - 1
    V = FunctionSpace(unit_square_mesh(cells, cells), degree=1)
    port = {}
    for tag, asm in (("fp32", torch.float32), ("cast", torch.float64)):
        K, _ = WeakForm(V, dtype=asm, device=dev).build(
            lambda u, v: dot(grad(u), grad(v))).assemble(format="ell")
        port[tag] = (K, K.data.float(), lumped_mass(V, asm, device=dev)
                     .float())
    K0 = port["fp32"][0]
    if not np.array_equal(K0.cols.cpu().numpy(), z["cols"]):
        raise SystemExit("the two packages' ELL patterns differ")
    mask = torch.as_tensor(z["mask"], device=dev)
    u0 = torch.as_tensor(z["u0"], device=dev)
    dt, steps = float(z["fp32_dt"]), int(z["fp32_steps"])
    interior = ~mask
    for who in ("jax", "port"):
        for tag in ("fp32", "cast"):
            if who == "jax":
                data = torch.as_tensor(z[f"{tag}_data"], device=dev)
                mL = torch.as_tensor(z[f"{tag}_mL"], device=dev)
            else:
                _, data, mL = port[tag]
            K = ELLMatrix(data, K0.cols, K0.row_lengths, K0.diag_pos)
            res = leapfrog_wave(K.matvec, mL, u0, torch.zeros_like(u0), dt,
                                steps, bc_mask=mask)
            e = res.energy.double()
            d64 = data.double()
            print(json.dumps({
                "operator": f"{who} {tag}", "cells": cells, "steps": steps,
                "dt": dt, "device": dev,
                "period_return_err": (torch.linalg.vector_norm(
                    (res.u - u0).double()) / torch.linalg.vector_norm(
                        u0.double())).item(),
                "energy_drift": ((e - e[0]).abs().max()
                                 / e[0].abs()).item(),
                "max_interior_row_sum": d64.sum(1)[interior].abs().max()
                .item(),
                "max_abs_diff_from_jax": (d64 - torch.as_tensor(
                    z[f"{tag}_data"], device=dev).double()).abs().max()
                .item()}))


if __name__ == "__main__":
    main()
