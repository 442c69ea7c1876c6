"""The JAX package's own CPU numbers for chip_smoke.py's nonlinear, wave
and stokes paths, in fp32 (x64 off, as the TPU ran them), the XLA gather
products (TPUFEM_BAND_DISPATCH=0).

    python scripts/physics_jax_reference.py nonlinear 512   # 263,169 DOFs
    python scripts/physics_jax_reference.py wave 1000       # 1,002,001 DOFs
    python scripts/physics_jax_reference.py wave 250 ops.npz
    python scripts/physics_jax_reference.py stokes 180      # 260,642 + 32,761
    python scripts/physics_jax_reference.py stokes_small 48


Each prints one JSON line.  nonlinear: examples/nonlinear_poisson.py's own
line (Newton steps, inner CG iterations, relres, rel L2 error).  wave:
examples/wave_equation.py's steps of one period of the (1,1) mode on the
unit square (the weak form's ELL stiffness, the lumped mass, stable_dt's
step, leapfrog_wave) with its energy drift and period-return error at
full precision, and the same again with the stiffness and the mass
assembled in fp64 and cast to fp32 ("operator_fp64_cast").  With a third
argument the wave case also writes both operators (K's values and
columns, M_L), the mask, u0, dt and the steps to that .npz, for
scripts/wave_operator_swap.py to step with the port.  stokes:
examples/stokes_cavity.py's solve (the regularized lid, fp32, the
scalar-AMG velocity preconditioner, tol 1e-6, maxiter 50,000,
check_every 4): MINRES iterations, relres, the DOF counts and the
centerline u_x minimum.  stokes_small: the same cavity in fp64 to 1e-8,
once with "jacobi" and once with "amg": the counts, the norms of u and p,
u at every 601st and p at every 151st DOF, and the projections of u and p
on cos(0.37 k i), k = 1..4 (what chip_smoke.py holds the port to).
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


def _lid(X):
    """examples/stokes_cavity.py's regularized lid."""
    on_top = (np.abs(X[..., 1] - 1.0) < 1e-12).astype(float)
    profile = 16.0 * (X[..., 0] * (1 - X[..., 0])) ** 2
    return np.stack([on_top * profile, 0.0 * X[..., 0]], axis=-1)


def _cavity(n, dtype, tol, vprecond):
    from tpufem.mesh.rectangle import rectangle_mesh
    from tpufem.solve.stokes import solve_stokes

    mesh = rectangle_mesh(0.0, 1.0, 0.0, 1.0, n, n)
    t0 = time.perf_counter()
    sol = solve_stokes(mesh, bc_velocity=_lid, dtype=dtype, tol=tol,
                       maxiter=50_000, check_every=4,
                       velocity_precond=vprecond)
    sol.u.block_until_ready()
    wall = time.perf_counter() - t0
    u = np.asarray(sol.u, np.float64)
    X = sol.V.scalar_dof_coords
    center = np.abs(X[:, 0] - 0.5) < 1e-9
    return sol, u, {
        "n": n, "vprecond": vprecond, "velocity_dofs": sol.V.num_dofs,
        "pressure_dofs": sol.Q.num_scalar_dofs,
        "iterations": int(sol.res.iterations),
        "relres": float(sol.res.residual_norm),
        "converged": bool(sol.res.converged),
        "centerline_ux_min": float(u.reshape(-1, 2)[center, 0].min()),
        "wall_s": round(wall, 2)}


def _projections(v):
    i = np.arange(v.size, dtype=np.float64)
    return [float(np.dot(np.cos(0.37 * k * i), v)) for k in range(1, 5)]


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
    elif case == "stokes":
        import jax.numpy as jnp

        print(json.dumps({"case": "stokes", **_cavity(
            n, jnp.float32, 1e-6, "amg")[2]}))
    elif case == "stokes_small":
        jax.config.update("jax_enable_x64", True)
        import jax.numpy as jnp

        for vprecond in ("jacobi", "amg"):
            sol, u, out = _cavity(n, jnp.float64, 1e-8, vprecond)
            p = np.asarray(sol.p, np.float64)
            out.update({"u_norm": float(np.linalg.norm(u)),
                        "p_norm": float(np.linalg.norm(p)),
                        "u_samples": u[::601].tolist(),
                        "p_samples": p[::151].tolist(),
                        "u_proj": _projections(u),
                        "p_proj": _projections(p)})
            print(json.dumps({"case": "stokes_small", **out}))
    else:
        raise SystemExit(f"unknown case {case!r}")


if __name__ == "__main__":
    main()
