"""Port hygiene: tpufem_torch never imports JAX or the JAX package, and on
CPU tensors no wrapper launches a kernel."""
import subprocess
import sys
from pathlib import Path

import torch

from tpufem_torch.ops import fused_system_cuda, mg_transfer_cuda, stencil_cuda
from tpufem_torch.solve.poisson import model_problem_3d_planes
from tpufem_torch.solve.structured_fast import solve_poisson_fast

# several pytest workers share the CPU: one intra-op thread each keeps
# the many small tensor ops from oversubscribing it
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

_PORT_MODULES = [
    "tpufem_torch", "tpufem_torch.convert",
    "tpufem_torch.ops._build", "tpufem_torch.ops.stencil_cuda",
    "tpufem_torch.ops.fused_system_cuda", "tpufem_torch.ops.mg_transfer_cuda",
    "tpufem_torch.solve.cg", "tpufem_torch.solve.multigrid",
    "tpufem_torch.solve.refine", "tpufem_torch.solve.structured_fast",
    "tpufem_torch.solve.poisson", "tpufem_torch.utils.timing",
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


def test_cpu_slice_launches_no_kernel():
    # n=16: a two-level hierarchy, so the transfer wrappers run too
    sol = solve_poisson_fast((-3.0, 3.0), 16, model_problem_3d_planes(),
                             tol=1e-5, dtype=torch.float32)
    assert sol.cg.converged
    assert fused_system_cuda.build_poisson_system.launches == 0
    assert stencil_cuda.stencil_apply.launches == 0
    assert mg_transfer_cuda.const_residual_restrict_embedded.launches == 0
    assert mg_transfer_cuda.const_prolong_add_smooth_embedded.launches == 0
