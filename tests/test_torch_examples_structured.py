"""The port's examples (tpufem_torch.examples) against the JAX package's
(examples/), the structured and host-only ones, on the CPU at small
sizes: each ``main(argv + ["--device", "cpu"])`` beside the JAX
example's ``main`` on the same flags.  The counts agree (within one where
the two packages round differently), the solutions within 1e-5 of their
largest entry in fp32 and 1e-10 in fp64, and both print the same fields.

The JAX examples compute in JAX's default float, float64 here (the test
configuration enables x64); the port's in torch's default dtype, which
the ``float64_default`` fixture sets to match.  poisson_10m's JAX
``solve_poisson_fast`` and elasticity_1m's JAX solve run as the JAX
package's own tests run them on the CPU (interpret mode; ``sys.argv``).
"""
import ast
import importlib
import re
import sys

import numpy as np
import pytest
import torch

from example_runs import (assert_close, float64_default,  # noqa: F401
                          jax_host_forms, jax_main, one_blas_thread,
                          port_main)

torch.set_num_threads(1)


def fields(text):
    """key=value pairs of a printed line."""
    return dict(re.findall(r"(\w+)=([-+\w.]+)", text))


def test_poisson_2d(float64_default):
    ref, jtext = jax_main("poisson_2d", ["--cells", "16"])
    out, text = port_main("poisson_2d", ["--cells", "16"])
    assert out["result"].x.dtype == torch.float64
    assert out["iterations"] == int(ref.iterations) and out["converged"]
    assert_close(out["x"], ref.x, 1e-10)
    jf, pf = fields(jtext), fields(text)
    assert jf.keys() == pf.keys() and jf["dofs"] == pf["dofs"] == "289"
    assert pf["nodal_rms_err"] == jf["nodal_rms_err"]


def test_heat_equation_and_its_checkpoint(float64_default, tmp_path):
    from tpufem.io.checkpoint import load_solution as jax_load

    argv = ["--cells", "16", "--steps", "3"]
    ref, jtext = jax_main("heat_equation", argv)
    path = str(tmp_path / "heat.npz")
    out, text = port_main("heat_equation", argv + ["--checkpoint", path])
    jf, pf = fields(jtext), fields(text)
    assert abs(int(pf["cg_iters_total"]) - int(jf["cg_iters_total"])) <= 1
    assert out["cg_iters_total"] == int(pf["cg_iters_total"])
    assert_close(out["u"], ref, 1e-10)
    l2 = re.search(r"L2\^2 (\S+) -> (\S+)", jtext).groups()
    assert (f"{out['l2sq0']:.4f}", f"{out['l2sq']:.4f}") == l2
    assert out["decaying"]
    # the port's checkpoint reads back in the JAX package, bit for bit
    x, info = jax_load(path)
    np.testing.assert_array_equal(np.asarray(x), out["u"].numpy())
    assert info["iterations"] == 3
    assert info["residual_norm"] == out["residual_norm"]


@pytest.mark.parametrize("n", [8, 16])
def test_poisson_3d_multigrid(n):
    argv = ["--n", str(n)]
    ref, jtext = jax_main("poisson_3d_multigrid", argv + ["--no-pallas"])
    out, text = port_main("poisson_3d_multigrid", argv)
    assert abs(out["iterations"] - int(ref.iterations)) <= 1
    assert out["converged"] and bool(ref.converged)
    assert_close(out["result"].x, ref.x, 1e-5)
    jf, pf = fields(jtext), fields(text)
    assert jf.keys() == pf.keys()
    assert (pf["dofs"], pf["mg_levels"]) == (jf["dofs"], jf["mg_levels"])


def test_poisson_10m(monkeypatch):
    from tpufem.solve import structured_fast as jsf

    sols = []

    def interpreted(*a, **kw):
        sols.append(jsf.solve_poisson_fast(*a, interpret=True, **kw))
        return sols[-1]

    mod = importlib.import_module("examples.poisson_10m")
    monkeypatch.setattr(mod, "solve_poisson_fast", interpreted)
    _, jtext = jax_main("poisson_10m", ["--n", "16"])
    out, text = port_main("poisson_10m", ["--n", "16"])
    ref = sols[0]
    assert abs(out["iterations"] - int(ref.cg.iterations)) <= 1
    assert out["converged"] and out["dofs"] == ref.num_dofs == 17 ** 3
    assert_close(out["u"], ref.u, 1e-5)
    jf, pf = fields(jtext), fields(text)
    assert jf.keys() == pf.keys()
    assert float(pf["rel_l2_err"]) == pytest.approx(float(jf["rel_l2_err"]),
                                                    rel=1e-3)


def test_elasticity_1m(monkeypatch):
    import json

    from tpufem.solve import elasticity_structured as jes

    sols = []
    solve = jes.solve_elasticity_box

    def capture(*a, **kw):
        sols.append(solve(*a, **kw))
        return sols[-1]

    monkeypatch.setattr(jes, "solve_elasticity_box", capture)
    monkeypatch.setattr(sys, "argv", ["elasticity_1m", "--n", "8"])
    _, jtext = jax_main("elasticity_1m", None,
                        call=lambda mod: mod.main())
    out, text = port_main("elasticity_1m", ["--n", "8"])
    ref, jout, pout = sols[0], json.loads(jtext), json.loads(text)
    assert jout.keys() == pout.keys()
    assert abs(out["pcg_iters"] - int(ref.cg.iterations)) <= 1
    assert out["converged"] and out["num_dofs"] == 3 * 9 ** 3
    assert_close(out["u"], np.asarray(ref.u), 1e-5)
    assert pout["rel_l2_error_vs_exact"] == pytest.approx(
        jout["rel_l2_error_vs_exact"], rel=1e-4)
    assert pout["pcg_iter_ms"] > 0 and pout["device"] == "cpu"


def test_reduction_bench():
    _, jtext = jax_main("reduction_bench", None, call=lambda mod: mod.main())
    out, text = port_main("reduction_bench", [])
    assert out["n"] == 1 << 20 and out["match"]
    jchecks = [ast.literal_eval(line.split(":", 1)[1].strip())
               for line in jtext.splitlines() if "sum:" in line]
    assert len(jchecks) == 3
    for jc, name in zip(jchecks, ("fused", "block", "segment")):
        pc = out["checks"][name]
        assert pc["cpu"] == jc["cpu"] and pc["match"] and jc["match"]
        assert pc["device"] == pytest.approx(jc["device"], rel=1e-5)
    assert out["bandwidth_gbs"] > 0 and "bandwidth" in text
