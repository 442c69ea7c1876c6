"""Time kernel K1 (the fused 3D system build of tpufem_torch) from two
checkouts of this repository on one NVIDIA GPU, in turns A, B, B, A.

    python scripts/fused_build_ab.py <checkout A> <checkout B> [n]

Each turn is a fresh process that imports ``tpufem_torch`` from its
checkout, builds K1 from that checkout's CUDA source, and times
``build_poisson_system`` on the uniform box with n cells a side (default
96: 912,673 DOFs, fp32, the degree-2 rule) as the median of 50 launches
with CUDA events, the stream queued ahead.  It also hashes the planes and
the RHS, so the two checkouts' outputs can be held to each other bit for
bit.  Prints one line per turn and, last, one JSON object with each
checkout's mean over its two turns, the ratio B / A and whether all four
outputs agree.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

_TURN = r"""
import hashlib, json, sys
import numpy as np, torch
sys.path.insert(0, ".")
from tpufem_torch.assemble.structured import structured_plan
from tpufem_torch.fem.quadrature import tetrahedron_rule
from tpufem_torch.ops.fused_system_cuda import (build_poisson_system,
                                                node_coords_embedded_from_grid)
from tpufem_torch.solve.multigrid import _light_grid
from tpufem_torch.solve.poisson import model_problem_3d_planes
from tpufem_torch.utils.timing import cuda_ms

n = int(sys.argv[1])
info, coords, _ = _light_grid((-3.0, 3.0), n)
plan = structured_plan(info, embed=True)
C = torch.as_tensor(node_coords_embedded_from_grid(coords, plan, np.float32),
                    device="cuda")
f, rule = model_problem_3d_planes(), tetrahedron_rule(2)
A, b = build_poisson_system(plan, C, f, rule)
torch.cuda.synchronize()
digest = hashlib.sha256(A.data.cpu().numpy().tobytes()
                        + b.cpu().numpy().tobytes()).hexdigest()[:16]
ms = cuda_ms(lambda: build_poisson_system(plan, C, f, rule), reps=50)
print(json.dumps({"ms": ms, "sha256": digest}))
"""


def main() -> int:
    if len(sys.argv) not in (3, 4):
        print(__doc__, file=sys.stderr)
        return 2
    dirs = {"A": Path(sys.argv[1]).resolve(), "B": Path(sys.argv[2]).resolve()}
    n = sys.argv[3] if len(sys.argv) == 4 else "96"
    runs = {"A": [], "B": []}
    for key in ("A", "B", "B", "A"):
        out = subprocess.run([sys.executable, "-c", _TURN, n], cwd=dirs[key],
                             capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            print(out.stderr, file=sys.stderr)
            return 1
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        print(f"# {key} ({dirs[key]}): K1 n={n} {rec['ms']:.4f} ms, "
              f"output sha256 {rec['sha256']}")
        runs[key].append(rec)
    ms = {k: sum(r["ms"] for r in v) / len(v) for k, v in runs.items()}
    same = len({r["sha256"] for v in runs.values() for r in v}) == 1
    print(json.dumps({"n": int(n), "ms_A": ms["A"], "ms_B": ms["B"],
                      "ratio_B_over_A": ms["B"] / ms["A"],
                      "outputs_equal": same}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
