"""Explicit wave equation, as examples/wave_equation.py: lumped-mass
leapfrog over M u'' + K u = 0 on the unit square, the stiffness from the
weak-form frontend in ELL format.  Each step is one product of K (the
banded ELL kernel, B9, on the card) plus elementwise updates, and nothing
is read back to the host inside the loop (``solve.dynamics``).  Prints the
discrete-energy drift (central differences conserve it exactly: about
1e-12 in fp64) and the period-return error of the (1,1) standing mode.

The run is repeated, as the JAX example runs its jitted program once cold
and once timed; ``wall`` is the second run's.  It computes in torch's
default dtype (fp32 unless ``torch.set_default_dtype`` says otherwise),
where the JAX example computes in JAX's default float.

    python -m tpufem_torch.examples.wave_equation --cells 1000 --periods 1
    python -m tpufem_torch.examples.wave_equation --cells 16 --device cpu
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
from tpufem_torch.mesh.rectangle import unit_square_mesh
from tpufem_torch.solve.dynamics import leapfrog_wave, lumped_mass, stable_dt


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cells", type=int, default=64)
    parser.add_argument("--periods", type=float, default=1.0)
    parser.add_argument("--steps-per-period", type=int, default=0,
                        help="0 = as many as CFL requires")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    dev = device_of(args)
    dtype = torch.get_default_dtype()

    t0 = time.perf_counter()
    mesh = unit_square_mesh(args.cells, args.cells)
    V = FunctionSpace(mesh, degree=1)
    K, _ = WeakForm(V, dtype=dtype, device=dev).build(
        lambda u, v: dot(grad(u), grad(v))).assemble(format="ell")
    mL = lumped_mass(V, dtype, device=dev)
    mask = torch.as_tensor(V.dof_flags, device=dev)

    c = mesh.coords
    u0 = torch.as_tensor(np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1]),
                         dtype=dtype, device=dev)
    u0 = torch.where(mask, 0.0, u0)
    sync(dev)
    t_build = time.perf_counter() - t0

    omega = np.sqrt(2.0) * np.pi
    period = 2 * np.pi / omega
    t0 = time.perf_counter()
    dt_cap = stable_dt(K.matvec, mL)
    t_dt = time.perf_counter() - t0
    spp = args.steps_per_period or int(np.ceil(period / dt_cap))
    steps = int(round(spp * args.periods))
    dt = args.periods * period / steps

    def run():
        return leapfrog_wave(K.matvec, mL, u0, torch.zeros_like(u0), dt,
                             steps, bc_mask=mask)

    run()                                # the cold run
    sync(dev)
    t0 = time.perf_counter()
    res = run()
    sync(dev)
    wall = time.perf_counter() - t0

    e = res.energy.cpu().numpy()
    drift = float(np.abs(e - e[0]).max() / abs(e[0]))
    rel = float(np.linalg.norm(res.u.cpu().numpy() - u0.cpu().numpy())
                / np.linalg.norm(u0.cpu().numpy()))
    print(f"dofs={V.num_dofs} steps={steps} dt={dt:.3e} "
          f"energy_drift={drift:.2e} period_return_err={rel:.4f} "
          f"wall={wall:.3f}s ({steps / wall:.0f} steps/s)")
    return {"dofs": V.num_dofs, "steps": steps, "dt": dt,
            "energy_drift": drift, "period_return_err": rel, "wall_s": wall,
            "walls_s": {"build": t_build, "stable_dt": t_dt},
            "result": res, "u0": u0, "K": K, "mL": mL, "mask": mask}


if __name__ == "__main__":
    main()
