"""Port hygiene: tpufem_torch never imports JAX or the JAX package, its
root exports what the JAX package's does (as far as ported) without
building a kernel, the ported members keep the reference's signatures, and
on CPU tensors no wrapper launches a kernel (K1-K4, B4, B5, B8-B15)."""
import dataclasses
import inspect
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from tpufem_torch.ops import fused_system_cuda, mg_transfer_cuda, stencil_cuda
from tpufem_torch.mesh.rectangle import perturbed_rectangle_mesh
from tpufem_torch.solve.multigrid import (build_poisson_multigrid,
                                          mg_preconditioner)
from tpufem_torch.solve.poisson import (model_problem_3d_planes,
                                        solve_poisson_dense,
                                        solve_poisson_ell)
from tpufem_torch.solve.structured_fast import solve_poisson_fast
from tpufem_torch.sparse import ell_cuda
from tpufem_torch.fem.space import FunctionSpace
from tpufem_torch.forms.language import dot, grad
from tpufem_torch.forms.weakform import WeakForm, integrate
from tpufem_torch.mesh.box import box_mesh
from tpufem_torch.solve.bc import apply_dirichlet_ell
from tpufem_torch.solve.elasticity import solve_elasticity

# several pytest workers share the CPU: one intra-op thread each keeps
# the many small tensor ops from oversubscribing it
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """One BLAS thread a test, as one torch thread: numpy's OpenBLAS
    threads spin against the other workers on the shared CPU (a 729 x 729
    inverse takes seconds on eight, 0.07 s on one)."""
    with threadpool_limits(1, user_api="blas"):
        yield

REPO = Path(__file__).resolve().parent.parent

# the JAX package's examples/ that the port runs as tpufem_torch.examples.*
_EXAMPLES = ("reduction_bench", "poisson_2d", "heat_equation",
             "poisson_3d_multigrid", "poisson_10m", "unstructured_1m",
             "dist_amg_demo", "elasticity_unstructured", "elasticity_1m",
             "generic_assembly_20m", "nonlinear_poisson", "wave_equation",
             "modal_analysis", "stokes_cavity", "saxpy_cuda")
# the JAX example each port example differs from in name (saxpy_cuda is
# the Pallas example's counterpart)
_JAX_EXAMPLE = {"saxpy_cuda": "saxpy_pallas"}

_PORT_MODULES = [
    "tpufem_torch", "tpufem_torch.convert",
    "tpufem_torch.assemble.planar", "tpufem_torch.assemble.structured",
    "tpufem_torch.sparse.stencil", "tpufem_torch.sparse.ell",
    "tpufem_torch.sparse.ell_cuda",
    "tpufem_torch.mesh.core", "tpufem_torch.mesh.rectangle",
    "tpufem_torch.mesh.adjacency", "tpufem_torch.fem.quadrature",
    "tpufem_torch.fem.elements", "tpufem_torch.fem.space",
    "tpufem_torch.assemble.local", "tpufem_torch.assemble.dense",
    "tpufem_torch.assemble.ell", "tpufem_torch.solve.precond",
    "tpufem_torch.ops._build", "tpufem_torch.ops.stencil_cuda",
    "tpufem_torch.ops.fused_system_cuda", "tpufem_torch.ops.mg_transfer_cuda",
    "tpufem_torch.solve.bc", "tpufem_torch.solve.cg",
    "tpufem_torch.solve.multigrid",
    "tpufem_torch.solve.refine", "tpufem_torch.solve.structured_fast",
    "tpufem_torch.solve.poisson", "tpufem_torch.utils.timing",
    "tpufem_torch.mesh.box", "tpufem_torch.forms.language",
    "tpufem_torch.forms.weakform", "tpufem_torch.sparse.bcsr",
    "tpufem_torch.solve.elasticity", "tpufem_torch.assemble.stencil",
    "tpufem_torch.ops.assemble_cuda", "tpufem_torch.ops.reduction",
    "tpufem_torch.ops.saxpy_cuda",
    "tpufem_torch.dist", "tpufem_torch.dist.mesh",
    "tpufem_torch.dist.partition", "tpufem_torch.dist.stencil",
    "tpufem_torch.dist.cg", "tpufem_torch.dist.assembly",
    "tpufem_torch.dist.multigrid", "tpufem_torch.dist.ell",
    "tpufem_torch.dist.dynamics", "tpufem_torch.dist.stencil2d",
    "tpufem_torch.dist.dryrun", "tpufem_torch.dist.amg",
    "tpufem_torch.solve.amg", "tpufem_torch.solve.amg_block",
    "tpufem_torch.solve.elasticity_structured",
    "tpufem_torch.native",
    "tpufem_torch.fem.facets", "tpufem_torch.assemble.coo",
    "tpufem_torch.sparse.matfree", "tpufem_torch.forms.symbolic",
    "tpufem_torch.solve.newton", "tpufem_torch.solve.dynamics",
    "tpufem_torch.solve.eigen", "tpufem_torch.solve.minres",
    "tpufem_torch.solve.stokes",
    "tpufem_torch.utils.logging", "tpufem_torch.utils.debug",
    "tpufem_torch.utils.profiling", "tpufem_torch.io.checkpoint",
    "tpufem_torch.config", "tpufem_torch.examples",
    "tpufem_torch.examples._common",
    *[f"tpufem_torch.examples.{name}" for name in _EXAMPLES],
    "chip_smoke",
]

# the names tpufem_torch's root exports: eagerly, then lazily
_EXPORTS = [
    "Mesh", "rectangle_mesh", "unit_square_mesh", "RectangleMesh",
    "UnitSquareMesh", "box_mesh", "unit_cube_mesh", "BoxMesh",
    "UnitCubeMesh", "ell_pattern", "node_adjacency", "FunctionSpace",
    "VectorFunctionSpace", "triangle_rule", "tetrahedron_rule",
    "rule_for_cell", "cg", "CGResult", "ELLMatrix", "StencilMatrix",
    "WeakForm", "solve_poisson_fast", "build_poisson_multigrid",
    "solve_elasticity", "solve_poisson_ell", "build_amg",
    "build_block_amg", "build_dist_amg", "rectangle_quad_mesh",
    "box_hex_mesh", "greedy_element_coloring", "newton_krylov",
    "smallest_eigenpairs", "leapfrog_wave", "solve_stokes", "minres"]
# the JAX package's other root names, with the ROADMAP item that ports each
_NOT_PORTED: dict = {}


def test_port_imports_no_jax():
    """Every port module and every exported name, in a fresh interpreter:
    no JAX, and importing the package builds no kernel; neither the
    package (its exports included) nor chip_smoke imports SymPy (only
    forms.symbolic does)."""
    code = (
        "import importlib, sys\n"
        "import tpufem_torch\n"
        "from tpufem_torch.ops import _build\n"
        "assert not _build._LOADED, _build._LOADED\n"
        f"for name in {_EXPORTS!r}: getattr(tpufem_torch, name)\n"
        "import chip_smoke\n"
        "assert 'sympy' not in sys.modules\n"
        f"for m in {_PORT_MODULES!r}: importlib.import_module(m)\n"
        "assert not _build._LOADED, _build._LOADED\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'jaxlib' or m == 'tpufem' or "
        "m.startswith('tpufem.') or m == 'examples' or "
        "m.startswith('examples.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("kw", [dict(), dict(precond="general",
                                             g=lambda x, y, z: x - z)],
                         ids=["const", "general+dirichlet"])
def test_cpu_slice_launches_no_kernel(kw):
    # n=16: a two-level hierarchy, so the transfer wrappers run too
    sol = solve_poisson_fast((-3.0, 3.0), 16, model_problem_3d_planes(),
                             tol=1e-5, dtype=torch.float32, device="cpu",
                             **kw)
    levels = build_poisson_multigrid((-3.0, 3.0), 16, operator="const",
                                     device="cpu")
    mg_preconditioner(levels, fuse_transfers=False)(
        torch.ones(levels[0].plan.num_store_rows))
    assert sol.cg.converged
    assert fused_system_cuda.build_poisson_system.launches == 0
    assert stencil_cuda.stencil_apply.launches == 0
    assert stencil_cuda.stencil_fused_apply.launches == 0
    assert stencil_cuda.const_stencil_apply.launches == 0
    assert mg_transfer_cuda.const_residual_restrict_embedded.launches == 0
    assert mg_transfer_cuda.const_prolong_add_smooth_embedded.launches == 0


_ELL_COUNTERS = [(ell_cuda.ell_matvec_cuda, "launches"),
                 (ell_cuda.ell_matvec_cuda, "launches_per_block"),
                 (ell_cuda.ell_matvec_multi_cuda, "launches"),
                 (ell_cuda.ell_gather_matvec_cuda, "launches"),
                 (ell_cuda.ell_gather_matvec_multi_cuda, "launches"),
                 (ell_cuda.bcsr_matvec_cuda, "launches"),
                 (ell_cuda.bcsr_matvec_cuda, "launches_per_block"),
                 (ell_cuda.bcsr_gather_matvec_cuda, "launches")]


@pytest.mark.parametrize("kw", [dict(precond="chebyshev", matvec="pallas"),
                                dict(), dict(precondition=False,
                                             matvec="pallas")],
                         ids=["chebyshev+banded", "jacobi", "banded-plan"])
def test_cpu_ell_path_launches_no_kernel(kw):
    """The ELL path on CPU tensors runs the plain versions only, and its
    entry points run on the card unless the caller asks for the CPU."""
    before = [getattr(fn, attr) for fn, attr in _ELL_COUNTERS]
    mesh = perturbed_rectangle_mesh(-3, 3, -3, 3, 10, 10, seed=1)
    sol = solve_poisson_ell(mesh, tol=1e-8, device="cpu", **kw)
    assert sol.cg.converged and sol.u.device.type == "cpu"
    assert [getattr(fn, attr) for fn, attr in _ELL_COUNTERS] == before
    for entry in (solve_poisson_ell, solve_poisson_dense):
        assert inspect.signature(entry).parameters["device"].default \
            == "cuda"


@pytest.mark.parametrize("matvec", ["gather", "pallas"])
@pytest.mark.parametrize("dim", [2, 3])
def test_cpu_elasticity_path_launches_no_kernel(matvec, dim):
    """The elasticity path and the weak-form assembly on CPU tensors run the
    plain versions only (B12's included), and their entry points run on
    the card unless the caller asks for the CPU."""
    before = [getattr(fn, attr) for fn, attr in _ELL_COUNTERS]
    mesh = (perturbed_rectangle_mesh(-1, 1, -1, 1, 6, 6, seed=2) if dim == 2
            else box_mesh(-1, 1, -1, 1, -1, 1, 3, 3, 3))
    sol = solve_elasticity(mesh, bc_values=1.0, tol=1e-8, matvec=matvec,
                           device="cpu")
    assert sol.cg.converged and sol.u.device.type == "cpu"
    wf = WeakForm(FunctionSpace(mesh), device="cpu").build(
        lambda u, v: dot(grad(u), grad(v)))
    A, _ = wf.assemble(format="ell")
    apply_dirichlet_ell(A, torch.ones(A.shape[0], dtype=torch.float64),
                        mesh.node_flags != 0)
    assert [getattr(fn, attr) for fn, attr in _ELL_COUNTERS] == before
    for entry in (solve_elasticity, WeakForm, integrate):
        assert inspect.signature(entry).parameters["device"].default \
            == "cuda"


def test_root_exports_match_the_reference():
    import tpufem
    import tpufem_torch

    for name in _EXPORTS:
        port, ref = getattr(tpufem_torch, name), getattr(tpufem, name)
        assert getattr(port, "__name__", None) == getattr(ref, "__name__",
                                                          None), name
    for name, item in _NOT_PORTED.items():
        assert hasattr(tpufem, name)
        with pytest.raises(AttributeError, match=f"ROADMAP {item}"):
            getattr(tpufem_torch, name)
    with pytest.raises(AttributeError, match="no attribute"):
        tpufem_torch.no_such_name


def _members():
    """(port member, reference member) pairs whose signatures must agree."""
    from tpufem.assemble import planar as jplanar
    from tpufem.assemble import stencil as jstencil
    from tpufem.assemble import structured as jstructured
    from tpufem.fem.quadrature import QuadratureRule as JaxRule
    from tpufem.mesh.core import Mesh as JaxMesh
    from tpufem.ops import reduction as jreduction
    from tpufem.sparse import stencil as jsparse
    from tpufem.utils.timing import PhaseTimer as JaxTimer

    from tpufem_torch.assemble import planar, stencil, structured
    from tpufem_torch.fem.quadrature import QuadratureRule
    from tpufem_torch.mesh.core import Mesh
    from tpufem_torch.ops import reduction
    from tpufem_torch.sparse import stencil as sparse
    from tpufem_torch.utils.timing import PhaseTimer

    pairs = [(getattr(Mesh, m), getattr(JaxMesh, m)) for m in
             ("interior_nodes", "print_mesh", "neighbor_nodes_list")]
    pairs += [(QuadratureRule.barycentric, JaxRule.barycentric),
              (structured.StructuredPlan.embed_field,
               jstructured.StructuredPlan.embed_field),
              (sparse.StencilMatrix.to_dense, jsparse.StencilMatrix.to_dense),
              (PhaseTimer.start, JaxTimer.start),
              (PhaseTimer.stop, JaxTimer.stop),
              (sparse.stencil_pattern, jsparse.stencil_pattern),
              (reduction.segment_reduce, jreduction.segment_reduce),
              (reduction.reduction_check, jreduction.reduction_check)]
    pairs += [(getattr(mod, name), getattr(ref, name)) for mod, ref, names in (
        (planar, jplanar, ("p1_stiffness_views", "element_load_views",
                           "element_coords_bt", "p1_stiffness_bt",
                           "element_load_bt", "element_coord_views")),
        (structured, jstructured, ("structured_plan",
                                   "assemble_stencil_structured",
                                   "assemble_vector_structured",
                                   "assemble_stencil_structured_bt",
                                   "assemble_vector_structured_bt",
                                   "stencil_pattern_structured")),
        (stencil, jstencil, ("stencil_values", "assemble_stencil")))
        for name in names]
    pairs += _a3_members()
    pairs += _a4_members()
    pairs += _a5_members()
    return pairs


# the auxiliaries (A5): every name of the JAX module's __all__; classes by
# their public methods or dataclass fields
_A5_MODULES = ("utils.timing", "utils.logging", "utils.debug",
               "utils.profiling", "io.checkpoint", "config")
# members that place tensors and add the port's keyword-only device=
_A5_DEVICE = {"load_system", "load_solution"}


def _a5_members():
    import importlib

    pairs = []
    for name in _A5_MODULES:
        port = importlib.import_module(f"tpufem_torch.{name}")
        ref = importlib.import_module(f"tpufem.{name}")
        names = [n for n in ref.__all__ if not n.startswith("V5E_")]
        assert set(names) <= set(port.__all__), name
        for n in names:
            p, r = getattr(port, n), getattr(ref, n)
            if dataclasses.is_dataclass(r):
                assert [(f.name, f.default) for f in dataclasses.fields(p)] \
                    == [(f.name, f.default) for f in dataclasses.fields(r)], n
                pairs += [(getattr(p, m), getattr(r, m)) for m in vars(r)
                          if callable(getattr(r, m)) and not m.startswith("_")]
            elif isinstance(r, type):
                pairs += [(getattr(p, m), getattr(r, m)) for m in vars(r)
                          if callable(getattr(r, m))]
            elif n not in _A5_DEVICE:
                pairs.append((p, r))
    # the examples' entry points: main(argv=None) everywhere (the JAX
    # elasticity_1m and reduction_bench read sys.argv, saxpy_pallas takes
    # no flags), and the helpers other examples import
    import examples.elasticity_unstructured as jel
    import examples.unstructured_1m as jun

    from tpufem_torch.examples import elasticity_unstructured as el
    from tpufem_torch.examples import unstructured_1m as un

    import examples.stokes_cavity as jsc

    from tpufem_torch.examples import stokes_cavity as sc

    pairs += [(un.rcm_renumber, jun.rcm_renumber),
              (el.body_force, jel.body_force), (sc.lid, jsc.lid)]
    for name in _EXAMPLES:
        port = importlib.import_module(f"tpufem_torch.examples.{name}")
        ref = importlib.import_module(
            f"examples.{_JAX_EXAMPLE.get(name, name)}")
        if name in ("elasticity_1m", "reduction_bench", "saxpy_cuda"):
            assert not inspect.signature(ref.main).parameters
            assert list(inspect.signature(port.main).parameters) == ["argv"]
        else:
            pairs.append((port.main, ref.main))
    return pairs


# the physics solvers' modules (A4a-d): every name of the JAX module's
# __all__, and the block CG and the semilinear load beside them
_A4_MODULES = ("solve.newton", "solve.dynamics", "solve.eigen",
               "solve.minres", "solve.stokes")
# members whose port adds a keyword-only device= (the card by default)
# before a trailing **kwargs, checked on their own
_A4_DEVICE_BEFORE_KWARGS = {"build_velocity_amg"}


def _a4_members():
    import importlib

    from tpufem.assemble import local as jlocal
    from tpufem.solve import cg as jcg

    from tpufem_torch.assemble import local
    from tpufem_torch.solve import cg

    pairs = [(cg.cg_fixed_block, jcg.cg_fixed_block),
             (local.element_nonlinear_load, jlocal.element_nonlinear_load)]
    for name in _A4_MODULES:
        port = importlib.import_module(f"tpufem_torch.{name}")
        ref = importlib.import_module(f"tpufem.{name}")
        assert port.__all__ == ref.__all__, name
        for n in ref.__all__:
            p, r = getattr(port, n), getattr(ref, n)
            if dataclasses.is_dataclass(r):         # the Stokes operator
                assert [f.name for f in dataclasses.fields(p)] \
                    == [f.name for f in dataclasses.fields(r)], n
            elif isinstance(r, type):               # the result tuples
                assert p._fields == r._fields, n
            elif n not in _A4_DEVICE_BEFORE_KWARGS:
                pairs.append((p, r))
    return pairs


# the weak-form frontend's modules: every name of the JAX module's __all__
_A3_MODULES = ("fem.elements", "fem.facets", "fem.quadrature",
               "assemble.coo", "sparse.matfree", "forms.symbolic")


def _a3_members():
    import importlib

    from tpufem.forms import weakform as jwf
    from tpufem.mesh import adjacency as jadj
    from tpufem.mesh import box as jbox
    from tpufem.mesh import rectangle as jrect

    from tpufem_torch.forms import weakform as twf
    from tpufem_torch.mesh import adjacency, box, rectangle

    pairs = []
    for name in _A3_MODULES:
        port = importlib.import_module(f"tpufem_torch.{name}")
        ref = importlib.import_module(f"tpufem.{name}")
        assert set(ref.__all__) <= set(port.__all__), name
        for n in ref.__all__:
            if callable(getattr(ref, n)):
                pairs.append((getattr(port, n), getattr(ref, n)))
            else:                                  # the fp32 tables
                np.testing.assert_array_equal(getattr(port, n),
                                              getattr(ref, n))
    pairs += [(getattr(mod, n), getattr(ref, n)) for mod, ref, names in (
        (rectangle, jrect, ("rectangle_quad_mesh", "perturbed_quad_mesh")),
        (box, jbox, ("box_hex_mesh",)),
        (adjacency, jadj, ("greedy_element_coloring", "pattern_unique_keys",
                           "slots_for_conn")),
        (twf.WeakForm, jwf.WeakForm, ("build_boundary",
                                      "boundary_element_matrices",
                                      "boundary_element_vectors")))
        for n in names]
    return pairs


def test_ported_members_keep_the_reference_signatures():
    import jax.numpy as jnp

    def shape(fn):
        return [(p.name, p.kind, p.default)
                for p in inspect.signature(fn).parameters.values()]

    def as_ref(fn, require_device=False):
        """The port's parameters with torch's float64 for jnp's, the
        port's trailing device= (the card by default) checked and left
        out; with ``require_device`` it must be there."""
        ours = [(n, k, jnp.float64 if d is torch.float64 else d)
                for n, k, d in shape(fn)]
        assert not require_device or ours[-1][0] == "device", \
            fn.__qualname__
        if ours and ours[-1][0] == "device":
            assert ours.pop() == ("device", inspect.Parameter.KEYWORD_ONLY,
                                  "cuda"), fn.__qualname__
        return ours

    for port, ref in _members():
        assert as_ref(port) == shape(ref), port.__qualname__
    # B14 under the reference's name: its data arguments and default block
    # (interpret= is the TPU's and is not ported)
    from tpufem.ops.reduction import pallas_block_reduce as jax_reduce

    from tpufem_torch.ops.reduction import pallas_block_reduce

    assert shape(pallas_block_reduce) == shape(jax_reduce)[:2]
    # integrate_boundary and the physics solvers' entry points that place
    # their results take torch's float64 for jnp's and add the port's
    # device= (keyword-only, the card by default)
    from tpufem.forms.weakform import integrate_boundary as jax_ib
    from tpufem.solve import dynamics as jdyn
    from tpufem.solve import eigen as jeig
    from tpufem.solve import stokes as jst

    from tpufem.io import checkpoint as jck

    from tpufem_torch.forms.weakform import integrate_boundary
    from tpufem_torch.io import checkpoint as ck
    from tpufem_torch.solve import dynamics, eigen, stokes

    for port, ref in ((integrate_boundary, jax_ib),
                      (dynamics.lumped_mass, jdyn.lumped_mass),
                      (eigen.subspace_stepper, jeig.subspace_stepper),
                      (eigen.smallest_eigenpairs, jeig.smallest_eigenpairs),
                      (stokes.build_stokes, jst.build_stokes),
                      (stokes.solve_stokes, jst.solve_stokes),
                      (ck.load_system, jck.load_system),
                      (ck.load_solution, jck.load_solution)):
        assert as_ref(port, require_device=True) == shape(ref), \
            port.__qualname__
    # build_velocity_amg: the device= goes before the trailing **amg_kw
    ours = [(n, k, jnp.float64 if d is torch.float64 else d)
            for n, k, d in shape(stokes.build_velocity_amg)]
    assert ours.pop(-2) == ("device", inspect.Parameter.KEYWORD_ONLY,
                            "cuda")
    assert ours == shape(jst.build_velocity_amg)
    assert shape(stokes.velocity_amg_precond) \
        == shape(jst.velocity_amg_precond)


def test_ported_members_match_the_reference():
    import io

    from tpufem.fem.quadrature import tetrahedron_rule as jax_rule
    from tpufem.mesh.box import box_mesh as jax_box_mesh

    from tpufem_torch.fem.quadrature import tetrahedron_rule
    from tpufem_torch.utils.timing import PhaseTimer

    m, jm = (f(-1, 1, -1, 1, -1, 1, 2, 1, 3) for f in (box_mesh,
                                                       jax_box_mesh))
    np.testing.assert_array_equal(m.interior_nodes(), jm.interior_nodes())
    for a, b in zip(m.neighbor_nodes_list(), jm.neighbor_nodes_list(30)):
        assert a.shape[0] == b.shape[0]
    for a, b in zip(m.neighbor_nodes_list(30), jm.neighbor_nodes_list(30)):
        np.testing.assert_array_equal(a, b)
    out, jout = io.StringIO(), io.StringIO()
    m.print_mesh(out)
    jm.print_mesh(jout)
    assert out.getvalue() == jout.getvalue()
    assert out.getvalue().startswith(f"number of nodes = {m.num_nodes}")
    np.testing.assert_array_equal(tetrahedron_rule(3).barycentric(),
                                  jax_rule(3).barycentric())
    timer = PhaseTimer()
    assert timer.start("a") is timer
    seconds = timer.stop()
    assert seconds >= 0.0 and timer.report() == {"a": seconds}
    with timer("b"):
        pass
    assert set(timer.report()) == {"a", "b"}


def test_cpu_assembly_reduction_saxpy_launch_no_kernel():
    """B13, B14 and B15 on CPU tensors run their plain versions."""
    from tpufem_torch.assemble.structured import structured_plan
    from tpufem_torch.ops import assemble_cuda, reduction, saxpy_cuda

    counters = (assemble_cuda.assemble_stencil_cuda, reduction.block_reduce,
                saxpy_cuda.saxpy)
    before = [fn.launches for fn in counters]
    mesh = box_mesh(0, 1, 0, 1, 0, 1, 2, 2, 2)
    plan = structured_plan(mesh, embed=True)
    A = assemble_cuda.assemble_stencil_cuda(plan, torch.as_tensor(
        assemble_cuda.element_coords_bt_embedded(mesh, plan)))
    assert A.data.device.type == "cpu"
    reduction.block_reduce(torch.ones(10))
    saxpy_cuda.saxpy(torch.ones(1), torch.ones(3), torch.ones(3))
    assert [fn.launches for fn in counters] == before


# the reference's dist/* names the port keeps, by module; ``interpret`` is
# the TPU's (Pallas interpret mode) and is not ported
_DIST_NAMES = {
    "partition": ("padded_size", "pad_rows"),
    "stencil": ("halo_exchange", "sharded_stencil_matvec"),
    "cg": ("stencil_cg_sharded", "distributed_stencil_solve"),
    "assembly": ("build_poisson_system_sharded",
                 "solve_poisson_dist_general"),
    "multigrid": ("build_dist_hierarchy", "shard_specs", "put_hierarchy",
                  "grid_stencil_matvec", "mgpcg_dist", "solve_poisson_dist"),
    "ell": ("pad_identity_rows", "sharded_pcg_loop", "ell_partition",
            "sharded_ell_matvec", "ell_cg_sharded", "distributed_ell_solve",
            "bcsr_partition", "sharded_bcsr_matvec", "bcsr_cg_sharded",
            "distributed_bcsr_solve"),
    "dynamics": ("leapfrog_wave_sharded",),
    "stencil2d": ("halo_exchange_grid", "grid_stencil_matvec_2d",
                  "grid_cg_sharded_2d", "solve_grid_cg_2d"),
    "amg": ("build_dist_amg", "dist_amg_apply", "dist_amg_pcg"),
}


def test_dist_names_keep_the_reference_signatures():
    import importlib

    def shape(fn):
        return [(p.name, p.kind, p.default)
                for p in inspect.signature(fn).parameters.values()
                if p.name != "interpret"]

    for module, names in _DIST_NAMES.items():
        port = importlib.import_module(f"tpufem_torch.dist.{module}")
        ref = importlib.import_module(f"tpufem.dist.{module}")
        for name in names:
            assert shape(getattr(port, name)) == shape(getattr(ref, name)), \
                f"{module}.{name}"
    for module, cls in (("multigrid", "DistMGLevel"),
                        ("ell", "ELLPartition"), ("ell", "BCSRPartition"),
                        ("amg", "DistAMGHierarchy")):
        port = getattr(importlib.import_module(f"tpufem_torch.dist.{module}"),
                       cls)
        ref = getattr(importlib.import_module(f"tpufem.dist.{module}"), cls)
        assert shape(port) == shape(ref), cls


def test_cpu_dist_path_launches_no_kernel():
    """The sharded build on a host mesh runs B8's plain version: B8's and
    K1's counters stay at their values; the mesh runs on the card unless
    asked for the CPU."""
    from tpufem_torch.assemble.structured import structured_plan
    from tpufem_torch.dist.assembly import build_poisson_system_sharded
    from tpufem_torch.dist.mesh import make_mesh
    from tpufem_torch.fem.quadrature import tetrahedron_rule
    from tpufem_torch.solve.multigrid import _light_grid

    counters = (fused_system_cuda.build_poisson_stripe,
                fused_system_cuda.build_poisson_system)
    before = [fn.launches for fn in counters]
    info, coords, _ = _light_grid((-1.0, 1.0), 6, 3)
    plan = structured_plan(info, embed=True)
    C = fused_system_cuda.node_coords_embedded_from_grid(coords, plan)
    data, _ = build_poisson_system_sharded(
        plan, C, make_mesh(4, ("z",), device="cpu"),
        model_problem_3d_planes(), tetrahedron_rule(2))
    assert all(s.device.type == "cpu" for s in data.shards)
    assert [fn.launches for fn in counters] == before
    assert inspect.signature(make_mesh).parameters["device"].default is None
