"""The port's examples (tpufem_torch.examples) against the JAX package's
(examples/), the unstructured ones, on the CPU at small sizes: each
``main(argv + ["--device", "cpu"])`` beside the JAX example on the same
flags.  The counts agree (within one where the two packages round
differently), the solutions within 1e-5 of their largest entry in fp32
and 1e-10 in fp64, and both print the same JSON keys.

The JAX unstructured_1m solves through its executable cache, whose
compiled solve is wrapped here to keep its result; elasticity_unstructured
runs with the JAX example's ``--interpret --no-aot``.  dist_amg_demo's JAX
side is the demo's own composition with ``dist_amg_pcg`` staged under
``jax.jit`` (its ``shard_map`` region is never dispatched eagerly), in
float64, JAX's default float here (the port's default dtype is set to
match).
"""
import numpy as np
import pytest
import torch

from example_runs import (assert_close, float64_default,  # noqa: F401
                          jax_host_forms, jax_main, json_line,
                          one_blas_thread, port_main)

torch.set_num_threads(1)


@pytest.mark.parametrize("precond", ["chebyshev", "amg"])
def test_unstructured_1m(precond, monkeypatch):
    from tpufem.utils import aot

    results = {}
    get = aot.CompiledCache.get

    def keeping(self, fn, example_args, *, tag="", **kw):
        compiled = get(self, fn, example_args, tag=tag, **kw)

        def call(*args):
            results[tag] = compiled(*args)
            return results[tag]

        return call

    monkeypatch.setattr(aot.CompiledCache, "get", keeping)
    argv = ["--n", "40", "--precond", precond]
    jout = json_line(jax_main("unstructured_1m", argv)[1])
    out, text = port_main("unstructured_1m", argv)
    pout = json_line(text)
    ref = results["unstr_solve"]
    assert jout.keys() == pout.keys()
    assert jout["walls_s"].keys() == pout["walls_s"].keys()
    for key in ("rows", "elements", "rcm_bandwidth", "precond"):
        assert pout[key] == jout[key], key
    assert abs(out["pcg_iters"] - int(ref.iterations)) <= 1
    assert out["converged"]
    assert_close(out["x"], ref.x, 1e-5)
    # the same renumbered mesh: the error against the exact solution too
    assert pout["rel_l2_error_vs_exact"] == pytest.approx(
        jout["rel_l2_error_vs_exact"], rel=1e-3)


def test_rcm_renumber_matches():
    from examples.unstructured_1m import rcm_renumber as jax_rcm
    from tpufem.mesh.rectangle import perturbed_rectangle_mesh as jax_mesh

    from tpufem_torch.examples.unstructured_1m import rcm_renumber
    from tpufem_torch.mesh.rectangle import perturbed_rectangle_mesh

    m = rcm_renumber(perturbed_rectangle_mesh(-3, 3, -3, 3, 30, 30,
                                              jitter=0.25, seed=0))
    jm = jax_rcm(jax_mesh(-3, 3, -3, 3, 30, 30, jitter=0.25, seed=0))
    np.testing.assert_array_equal(m.conn, jm.conn)
    np.testing.assert_array_equal(m.coords, jm.coords)
    np.testing.assert_array_equal(m.node_flags, jm.node_flags)


def test_rcm_renumber_lets_a_native_failure_raise(monkeypatch):
    from tpufem_torch import native
    from tpufem_torch.examples.unstructured_1m import rcm_renumber
    from tpufem_torch.mesh.rectangle import perturbed_rectangle_mesh

    def broken(*a, **kw):
        raise OSError("native library failed")

    monkeypatch.setattr(native, "node_adjacency", broken)
    with pytest.raises(OSError, match="native library failed"):
        rcm_renumber(perturbed_rectangle_mesh(-3, 3, -3, 3, 6, 6))


def _jax_dist_demo(n, devices, tol=1e-8):
    """examples/dist_amg_demo.py's composition in the JAX package, with
    dist_amg_pcg staged under jax.jit: (x, CGResult)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from examples.unstructured_1m import rcm_renumber
    from tpufem.assemble.dense import assemble_vector
    from tpufem.assemble.ell import assemble_ell
    from tpufem.assemble.local import element_load, p1_stiffness
    from tpufem.dist.amg import build_dist_amg, dist_amg_pcg
    from tpufem.fem.elements import P1Triangle
    from tpufem.fem.quadrature import triangle_rule
    from tpufem.mesh.adjacency import ell_pattern
    from tpufem.mesh.rectangle import perturbed_rectangle_mesh
    from tpufem.solve.bc import apply_dirichlet_ell
    from tpufem.solve.poisson import model_problem_2d

    mesh = rcm_renumber(perturbed_rectangle_mesh(-3, 3, -3, 3, n, n,
                                                 jitter=0.25, seed=0))
    pat = ell_pattern(mesh.conn, mesh.num_nodes, pad_to=8)
    ec = jnp.asarray(mesh.element_coords())
    element = P1Triangle()
    A = assemble_ell(pat, p1_stiffness(ec, element))
    f, _ = model_problem_2d()
    b = assemble_vector(jnp.asarray(mesh.conn),
                        element_load(ec, element, triangle_rule(5), f),
                        mesh.num_nodes)
    A, b = apply_dirichlet_ell(A, b, jnp.asarray(mesh.node_flags != 0))
    h = build_dist_amg(np.asarray(A.data), np.asarray(A.cols), devices,
                       coarse_n=max(300, n))
    dmesh = Mesh(np.array(jax.devices()[:devices]), ("rows",))
    b = np.asarray(b)
    return jax.jit(lambda: dist_amg_pcg(h, b, dmesh, tol=tol,
                                        maxiter=100))()


def test_dist_amg_demo(float64_default):
    x_ref, ref = _jax_dist_demo(24, 8)
    out, text = port_main("dist_amg_demo", ["--n", "24", "--devices", "8"])
    pout = json_line(text)
    assert out["x"].dtype == torch.float64
    assert pout["rows"] == 625 and pout["devices"] == 8
    assert pout["converged"] and bool(ref.converged)
    assert out["pcg_iters"] == int(ref.iterations)
    assert_close(out["x"], x_ref, 1e-10)
    assert set(pout) == {"metric", "rows", "devices", "pcg_iters", "relres",
                         "converged", "rel_l2_error_vs_exact"}


def test_dist_amg_demo_runs_on_the_card_unless_asked():
    from tpufem_torch.examples import dist_amg_demo

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist_amg_demo.main(["--n", "8"])


@pytest.mark.parametrize("precond", ["jacobi", "amg"])
def test_elasticity_unstructured(precond, monkeypatch):
    from tpufem.solve import elasticity as jel

    sols = []
    solve = jel.solve_elasticity

    def capture(*a, **kw):
        sols.append(solve(*a, **kw))
        return sols[-1]

    monkeypatch.setattr(jel, "solve_elasticity", capture)
    argv = ["--n", "20", "--precond", precond]
    jout = json_line(jax_main("elasticity_unstructured",
                              argv + ["--interpret", "--no-aot"])[1])
    out, text = port_main("elasticity_unstructured", argv)
    pout = json_line(text)
    ref = sols[0]
    assert jout.keys() == pout.keys()
    assert (pout["dofs"], pout["elements"]) == (jout["dofs"],
                                                jout["elements"]) == (882,
                                                                      800)
    assert pout["matvec"] == "cuda" and jout["matvec"] == "pallas"
    assert abs(out["pcg_iters"] - int(ref.cg.iterations)) <= 1
    assert out["converged"]
    assert_close(out["u"], ref.u, 1e-5)


def test_generic_assembly_20m():
    import jax.numpy as jnp

    from tpufem.assemble.ell import assemble_ell
    from tpufem.assemble.local import p1_stiffness
    from tpufem.fem.elements import P1Triangle
    from tpufem.mesh.adjacency import ell_pattern
    from tpufem.mesh.rectangle import rectangle_mesh

    argv = ["--nx", "40", "--ny", "20"]
    jout = json_line(jax_main("generic_assembly_20m", argv)[1])
    out, text = port_main("generic_assembly_20m", argv)
    pout = json_line(text)
    assert jout.keys() == pout.keys()
    assert jout["walls_s"].keys() == pout["walls_s"].keys()
    for key in ("elements", "rows", "ell_width", "chunks"):
        assert pout[key] == jout[key], key
    assert pout["max_rel_row_sum"] < 1e-5 and jout["max_rel_row_sum"] < 1e-5
    assert out["max_abs_diff_sort_scatter"] <= 1e-4 * float(
        out["data"].abs().max())
    # the chunked sum is the JAX package's one-pass ELL assembly
    mesh = rectangle_mesh(-3.0, 3.0, -3.0, 3.0, 20, 40)
    pat = ell_pattern(mesh.conn, mesh.num_nodes, pad_to=8)
    ref = assemble_ell(pat, p1_stiffness(jnp.asarray(
        mesh.element_coords(), jnp.float32), P1Triangle()))
    assert_close(out["data"], ref.data, 1e-5)
