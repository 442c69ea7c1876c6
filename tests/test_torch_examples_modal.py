"""The port's modal_analysis example against the JAX package's
(examples/modal_analysis.py) on the CPU at small sizes: ``main(argv +
["--device", "cpu"])`` beside the JAX example's ``main`` on the same
flags, both printing the same JSON keys.

The two packages draw their random start subspace from different
generators, so the port is given the JAX run's: the JAX example runs with
``--outer-chunk``, which makes its start eagerly (outside its compiled
chunks), where the test takes it, and the port's ``subspace_stepper``
then starts from it.  From the same start and the same operators the
outer steps give the same Ritz values up to the rounding of the inner
solves (fp32 in every mode).
"""
import numpy as np
import pytest
import torch

from example_runs import (jax_host_forms, jax_main,  # noqa: F401
                          json_line, one_blas_thread, port_main)

torch.set_num_threads(1)


def _run_both(argv, monkeypatch):
    """(JAX JSON, port JSON, port's returned dict), the port started from
    the JAX run's start subspace."""
    from tpufem.solve import eigen as jeigen

    from tpufem_torch.examples import modal_analysis

    starts = []
    jstepper = jeigen.subspace_stepper

    def keep_start(*a, **kw):
        kit = jstepper(*a, **kw)
        if not starts:                  # the eager call: a concrete start
            starts.append(np.array(kit[0]))
        return kit

    monkeypatch.setattr(jeigen, "subspace_stepper", keep_start)
    jout = json_line(jax_main("modal_analysis", argv)[1])

    stepper = modal_analysis.subspace_stepper

    def from_jax_start(*a, **kw):
        X0, step, finish = stepper(*a, **kw)
        return (torch.as_tensor(starts[0], dtype=X0.dtype,
                                device=X0.device), step, finish)

    monkeypatch.setattr(modal_analysis, "subspace_stepper", from_jax_start)
    out, text = port_main("modal_analysis", argv)
    return jout, json_line(text), out


@pytest.mark.parametrize("argv,rel", [
    (["--n", "40", "--outer", "4", "--outer-chunk", "2"], 2e-6),
    (["--n", "16", "--inner-precond", "chebyshev", "--outer", "3",
      "--inner", "10", "--outer-chunk", "1"], 2e-6),
    (["--n", "16", "--serial", "--inner-precond", "jacobi", "--no-mixed",
      "--outer", "4", "--inner", "30", "--outer-chunk", "2"], 4e-6)],
    ids=["amg-mixed-batched", "chebyshev-mixed", "jacobi-serial-fp32"])
def test_modal_analysis(argv, rel, monkeypatch):
    """Every flag of the example once: the default (greedy-SA AMG inner
    solves in lockstep, mixed precision) at n = 40 (1,681 DOFs, above
    build_amg's coarse_n, so a real hierarchy), --serial with Chebyshev,
    and --inner-precond jacobi with --no-mixed, each from the JAX run's
    start.  The eigenvalues within ``rel`` of the largest (the JSON's
    eight places beside): the inner solves are fp32 in every mode and the
    two packages' fp32 products round differently, so the Ritz values
    differ by a few fp32 ulps (2e-7 to 6e-7 measured); mixed precision
    forms the Ritz pencil in fp64 and decomposes it in fp32 (2e-6),
    --no-mixed does all of it in fp32 (4e-6).  The same printed fields,
    the max residual within 1e-4 relative.  Both runs also pass the
    example's own gate (5e-3 + 40 / n²), or main would exit."""
    jout, pout, out = _run_both(argv, monkeypatch)
    assert jout.keys() == pout.keys()
    assert jout["walls_s"].keys() == pout["walls_s"].keys()
    for key in ("dofs", "k", "mode", "outer_chunk", "precision",
                "inner_precond", "inner_iters", "outer_iters", "exact"):
        assert pout[key] == jout[key], key
    lam = out["result"].eigenvalues.double().numpy()
    jlam = np.asarray(jout["eigenvalues"])
    assert np.abs(lam - jlam).max() <= rel * np.abs(jlam).max() + 1e-8
    assert pout["max_residual"] == pytest.approx(jout["max_residual"],
                                                 rel=1e-4)
    assert out["result"].iterations == pout["outer_iters"]


def test_modal_outer_chunks_repeat_the_single_run():
    """--outer-chunk 2 runs the same four steps as --outer-chunk 0, so the
    same eigenvalues and subspace bit for bit; --outer-chunk 3 rounds
    --outer 4 up to two whole chunks (6 steps), as the JAX example does."""
    argv = ["--n", "24", "--inner-precond", "jacobi", "--inner", "10",
            "--outer", "4"]
    runs = {c: port_main("modal_analysis", argv + ["--outer-chunk", str(c)])
            for c in (0, 2, 3)}
    (one, t1), (two, t2), (three, t3) = runs[0], runs[2], runs[3]
    assert json_line(t1)["outer_chunk"] == 0
    assert json_line(t2)["outer_chunk"] == 2
    assert one["outer_iters"] == two["outer_iters"] == 4
    assert torch.equal(one["result"].eigenvalues, two["result"].eigenvalues)
    assert torch.equal(one["X"], two["X"])
    assert json_line(t3)["outer_iters"] == 6
    assert three["result"].iterations == 6
