"""Port hygiene: tpufem_torch never imports JAX or the JAX package, and on
CPU tensors no wrapper launches a kernel (K1-K4, B4, B5, B9-B12)."""
import inspect
import subprocess
import sys
from pathlib import Path

import pytest
import torch

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

REPO = Path(__file__).resolve().parent.parent

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
    "tpufem_torch.solve.elasticity",
    "chip_smoke",
]


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_PORT_MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'jaxlib' or m == 'tpufem' or "
        "m.startswith('tpufem.'))\n"
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
