"""The JAX package's own CPU numbers for chip_smoke.py's nonlinear and wave
paths, in fp32 (x64 off, as the TPU ran them), the XLA gather products
(TPUFEM_BAND_DISPATCH=0).

    python scripts/physics_jax_reference.py nonlinear 512   # 263,169 DOFs
    python scripts/physics_jax_reference.py wave 1000       # 1,002,001 DOFs
    python scripts/physics_jax_reference.py wave 250 ops.npz


Each prints one JSON line.  nonlinear: examples/nonlinear_poisson.py's own
line (Newton steps, inner CG iterations, relres, rel L2 error).  wave:
examples/wave_equation.py's steps of one period of the (1,1) mode on the
unit square (the weak form's ELL stiffness, the lumped mass, stable_dt's
step, leapfrog_wave) with its energy drift and period-return error at
full precision, and the same again with the stiffness and the mass
assembled in fp64 and cast to fp32 ("operator_fp64_cast").  With a third
argument the wave case also writes both operators (K's values and
columns, M_L), the mask, u0, dt and the steps to that .npz, for
scripts/wave_operator_swap.py to step with the port.
"""
import json
import os
import sys
import time

os.environ.setdefault("TPUFEM_BAND_DISPATCH", "0")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def wave(cells, cast, ops=None):
    """One period in fp32; ``cast``: K and M_L assembled in fp64 (x64 on
    for the assembly only) and cast to fp32; ``ops``: a dict the operator
    and the run's inputs are put in."""
    import jax.numpy as jnp

    from tpufem import FunctionSpace, unit_square_mesh
    from tpufem.forms.language import dot, grad
    from tpufem.forms.weakform import WeakForm
    from tpufem.solve.dynamics import leapfrog_wave, lumped_mass, stable_dt
    from tpufem.sparse.ell import ELLMatrix

    mesh = unit_square_mesh(cells, cells)
    V = FunctionSpace(mesh, degree=1)
    if cast:
        jax.config.update("jax_enable_x64", True)
    K, _ = WeakForm(V).build(lambda u, v: dot(grad(u), grad(v))).assemble(
        format="ell")
    mL = lumped_mass(V)
    if cast:
        K = ELLMatrix(np.asarray(K.data, np.float32), np.asarray(K.cols),
                      np.asarray(K.row_lengths), np.asarray(K.diag_pos))
        mL = np.asarray(mL, np.float32)
        jax.config.update("jax_enable_x64", False)
        K = ELLMatrix(jnp.asarray(K.data), jnp.asarray(K.cols),
                      jnp.asarray(K.row_lengths), jnp.asarray(K.diag_pos))
        mL = jnp.asarray(mL)
    mask = jnp.asarray(V.dof_flags)
    c = mesh.coords
    u0 = jnp.asarray(np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1]),
                     jnp.float32)
    u0 = jnp.where(mask, 0.0, u0)
    omega = np.sqrt(2.0) * np.pi
    period = 2 * np.pi / omega
    dt_cap = stable_dt(K.matvec, mL)
    steps = int(np.ceil(period / dt_cap))
    dt = period / steps
    run = jax.jit(lambda K, mL, mask, u: leapfrog_wave(
        K.matvec, mL, u, jnp.zeros(V.num_dofs, jnp.float32), dt,
        steps=steps, bc_mask=mask))
    t0 = time.perf_counter()
    res = run(K, mL, mask, u0)
    res.u.block_until_ready()
    wall = time.perf_counter() - t0
    e = np.asarray(res.energy, np.float64)
    u, u0n = np.asarray(res.u, np.float64), np.asarray(u0, np.float64)
    if ops is not None:
        tag = "cast" if cast else "fp32"
        ops.update({f"{tag}_data": np.asarray(K.data),
                    f"{tag}_mL": np.asarray(mL), "cols": np.asarray(K.cols),
                    "mask": np.asarray(mask), "u0": np.asarray(u0),
                    f"{tag}_dt": dt, f"{tag}_steps": steps})
    return {"case": "wave" + ("_operator_fp64_cast" if cast else ""),
            "cells": cells, "dofs": V.num_dofs, "steps": steps, "dt": dt,
            "energy_drift": float(np.abs(e - e[0]).max() / abs(e[0])),
            "period_return_err": float(np.linalg.norm(u - u0n)
                                       / np.linalg.norm(u0n)),
            "wall_s": round(wall, 2)}


def main():
    case, n = sys.argv[1], int(sys.argv[2])
    if case == "nonlinear":
        from examples.nonlinear_poisson import main as run

        run(["--n", str(n), "--interpret"])
    elif case == "wave":
        ops = {} if len(sys.argv) > 3 else None
        for cast in (False, True):
            print(json.dumps(wave(n, cast, ops)))
        if ops is not None:
            np.savez(sys.argv[3], **ops)
    else:
        raise SystemExit(f"unknown case {case!r}")


if __name__ == "__main__":
    main()
