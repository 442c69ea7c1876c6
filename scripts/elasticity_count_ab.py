"""The fp32 elasticity path's iteration count from two checkouts of this
repository on one NVIDIA GPU, in turns A, B, B, A, two solves a turn:
whether the count moves with the checkout or from run to run.

    python scripts/elasticity_count_ab.py <checkout A> <checkout B>

Each turn is a fresh process that imports ``tpufem_torch`` from its
checkout and runs ``chip_smoke.py``'s "elasticity" solve twice:
``solve_elasticity`` on the 700 x 700 perturbed mesh (jitter 0.2, seed 0;
982,802 DOFs), body force (1, -0.5), fp32, block-Jacobi PCG to 1e-6 on the
banded BCSR product (B12).  Each solve prints its iteration count and the
sha256 of its assembled matrix (the operator B12 multiplies, after the
Dirichlet elimination) and of its solution, so a count that moves can be
traced to the operator's bits or to the solve.  Prints the card's name and
power limit first.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

_TURN = r"""
import hashlib, sys
import torch
sys.path.insert(0, ".")
from tpufem_torch.mesh.rectangle import perturbed_rectangle_mesh
from tpufem_torch.solve.elasticity import solve_elasticity


def digest(t):
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()[:16]


def f(x):
    return torch.stack([0 * x[..., 0] + 1.0, 0 * x[..., 1] - 0.5], dim=-1)


mesh = perturbed_rectangle_mesh(-1.0, 1.0, -1.0, 1.0, 700, 700, jitter=0.2,
                                seed=0)
for run in range(2):
    sol = solve_elasticity(mesh, body_force=f, dtype=torch.float32, tol=1e-6,
                           maxiter=3300, matvec="pallas", precond="jacobi",
                           device="cuda")
    print(f"solve {run}: {sol.cg.iterations} iterations, matrix sha256 "
          f"{digest(sol.A.data)}, u sha256 {digest(sol.u)}", flush=True)
"""


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    dirs = {"A": Path(sys.argv[1]).resolve(), "B": Path(sys.argv[2]).resolve()}
    for key in ("A", "B", "B", "A"):
        proc = subprocess.run([sys.executable, "-c", _TURN], cwd=dirs[key],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return 1
        for line in proc.stdout.strip().splitlines():
            print(f"# {key} ({dirs[key]}): {line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
