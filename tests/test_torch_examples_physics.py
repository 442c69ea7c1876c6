"""The port's physics examples (tpufem_torch.examples: nonlinear_poisson,
wave_equation, stokes_cavity, and saxpy_cuda beside saxpy_pallas) against
the JAX package's (examples/), on the CPU at small sizes: each
``main(argv + ["--device", "cpu"])`` beside the JAX example's ``main`` on
the same flags, printing the same JSON keys or the same fields.

nonlinear_poisson computes in fp32 in both packages (the JAX example
fixes it); the others compute in fp64 here: JAX's default float with the
test configuration's x64, torch's default dtype set to match
(``float64_default``), and ``--f64`` for stokes_cavity.  The modal
example's tests are in tests/test_torch_examples_modal.py.
"""
import importlib
import re

import numpy as np
import pytest
import torch

from example_runs import (assert_close, float64_default,  # noqa: F401
                          jax_host_forms, jax_main, json_line,
                          one_blas_thread, port_main)

torch.set_num_threads(1)


def fields(text):
    """key=value pairs of a printed line."""
    return dict(re.findall(r"(\w+)=([-+\w.]+)", text))


@pytest.mark.parametrize("precond,n", [("jacobi", 24), ("amg", 40)])
def test_nonlinear_poisson(precond, n):
    """"amg" at n = 40 (1,681 DOFs, above build_amg's coarse_n of 1,200
    rows, so it builds a real interval-W hierarchy), "jacobi" at n = 24.
    fp32 Newton to 1e-6: the Newton count equal; the inner CG total within
    10%.  Each inner solve stops at an Eisenstat-Walker tolerance set by
    the last two residual norms, and CG carries the two packages' rounding
    differences up by orders of magnitude a Newton step: even in fp64 the
    fifth step's tolerance differs at 1e-7 and its count by a check batch
    of 4 (Jacobi, n = 40); in fp32 with AMG the two runs take 296 and 276.
    The error against the exact solution within 1% (the discretization's
    O(h²) sets it, not the solver's last digits)."""
    argv = ["--n", str(n), "--precond", precond]
    jout = json_line(jax_main("nonlinear_poisson", argv)[1])
    out, text = port_main("nonlinear_poisson", argv)
    pout = json_line(text)
    assert jout.keys() == pout.keys()
    assert jout["walls_s"].keys() == pout["walls_s"].keys()
    assert pout["dofs"] == jout["dofs"] == (n + 1) ** 2
    assert pout["precond"] == jout["precond"] == precond
    assert out["converged"] and jout["converged"]
    assert out["x"].dtype == torch.float32
    assert pout["newton_iters"] == jout["newton_iters"]
    assert (abs(pout["inner_cg_iters_total"] - jout["inner_cg_iters_total"])
            <= 0.1 * jout["inner_cg_iters_total"])
    assert pout["relres"] <= 1e-6
    assert pout["rel_l2_error_vs_exact"] == pytest.approx(
        jout["rel_l2_error_vs_exact"], rel=1e-2)
    # the second run repeats the first, cold one bit for bit
    assert torch.equal(out["cold"].x, out["x"])
    assert (out["hier"] is not None) == (precond == "amg")
    if precond == "amg":
        assert len(out["hier"].levels) >= 1


def test_wave_equation(float64_default):
    """--cells 16, one period, fp64: the same step count and dt (stable_dt
    draws its start from another generator, but 50 power iterations give
    the same ceiling), the final state within 1e-10 of the JAX run's
    largest entry, the energy trace within 1e-12 relative (central
    differences conserve it to rounding), the same printed fields."""
    argv = ["--cells", "16", "--periods", "1"]
    ref, jtext = jax_main("wave_equation", argv)
    out, text = port_main("wave_equation", argv)
    jf, pf = fields(jtext), fields(text)
    assert jf.keys() == pf.keys()
    for key in ("dofs", "steps", "dt", "period_return_err"):
        assert pf[key] == jf[key], key
    res = out["result"]
    assert res.u.dtype == torch.float64 and out["steps"] == int(jf["steps"])
    assert_close(res.u, ref.u, 1e-10)
    assert_close(res.energy, ref.energy, 1e-12)
    assert out["energy_drift"] <= 1e-10
    jdrift = float(np.abs(np.asarray(ref.energy) - ref.energy[0]).max()
                   / abs(ref.energy[0]))
    assert jdrift <= 1e-10


@pytest.mark.parametrize("vprecond,rel", [("amg", 1e-12), ("jacobi", 1e-8)])
def test_stokes_cavity(vprecond, rel, monkeypatch):
    """--n 8 --f64 --tol 1e-8 with each velocity preconditioner: the MINRES
    count equal, u and p within ``rel`` of the JAX solution's largest
    entry, the centerline minimum within ``rel`` too.  Both run the same
    recurrence from the same start in fp64; the two packages' summation
    orders differ in the last bits, which AMG's 52 iterations keep near
    1e-15 and Jacobi's 184 carry to about 5e-10 in p, so Jacobi is held to
    the solve's own tolerance.  The same JSON keys but walls_s's
    solve_compile, which has no counterpart (nothing is compiled)."""
    from tpufem.solve import stokes as jst

    sols = []
    solve = jst.solve_stokes

    def capture(*a, **kw):
        sols.append(solve(*a, **kw))
        return sols[-1]

    monkeypatch.setattr(jst, "solve_stokes", capture)
    argv = ["--n", "8", "--f64", "--tol", "1e-8", "--vprecond", vprecond]
    jout = json_line(jax_main("stokes_cavity", argv)[1])
    out, text = port_main("stokes_cavity", argv)
    pout = json_line(text)
    assert jout.keys() == pout.keys()
    assert jout["walls_s"].keys() - {"solve_compile"} \
        == pout["walls_s"].keys()
    for key in ("dtype", "vprecond", "velocity_dofs", "pressure_dofs",
                "minres_iters", "converged"):
        assert pout[key] == jout[key], key
    assert pout["converged"]
    sol, ref = out["solution"], sols[0]
    assert sol.u.dtype == torch.float64
    assert_close(sol.u, ref.u, rel)
    assert_close(sol.p, ref.p, rel)
    assert pout["centerline_ux_min"] == pytest.approx(
        jout["centerline_ux_min"], abs=rel)


def test_saxpy():
    """The fixed n = 524,288 fp32: the same two printed lines as the JAX
    example's (whose CPU branch computes a x + y without its kernel), and
    the output bit for bit the plain a x + y."""
    _, jtext = jax_main("saxpy_pallas", None, call=lambda mod: mod.main())
    out, text = port_main("saxpy_cuda", [])
    assert text == jtext
    assert out["n"] == 32 * 128 * 128 and out["max_abs_err"] < 1e-4
    x = torch.arange(out["n"], dtype=torch.float32)
    assert torch.equal(out["out"], torch.tensor(5.1, dtype=torch.float32)
                       * x + 2.0 * x)


@pytest.mark.parametrize("name,argv", [
    ("nonlinear_poisson", ["--n", "8"]),
    ("wave_equation", ["--cells", "4"]),
    ("modal_analysis", ["--n", "8"]),
    ("stokes_cavity", ["--n", "4"]),
    ("saxpy_cuda", [])])
def test_runs_on_the_card_unless_asked(name, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    mod = importlib.import_module(f"tpufem_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)
