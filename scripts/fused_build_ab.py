"""Time the fused 3D system builds K1 and B8 of tpufem_torch from two
checkouts of this repository on one NVIDIA GPU, in turns A, B, B, A.

    python scripts/fused_build_ab.py <checkout A> <checkout B>

Each turn is a fresh process that imports ``tpufem_torch`` from its
checkout, builds csrc/fused_system.cu from that checkout's source, and
times, as the median of 20 launches with CUDA events (the stream queued
ahead), with the degree-2 rule and the quadrature RHS:

  * K1, ``build_poisson_system``, on the uniform box with n = 96 cells a
    side (912,673 DOFs, the main path's) and n = 384 (57,066,625 DOFs,
    the scale path's), each in fp32 and fp64;
  * B8, ``build_poisson_stripe``, on the second of 4 z-stripes of 26
    store planes of the n = 96 box with its interior nodes jittered by
    +-0.15 h (default_rng(0), as chip_smoke.py's dist_assembly), fp32;
  * the four-stripe build, ``dist.assembly.build_poisson_system_sharded``
    on a 4-shard mesh on the one card, of the same box.

Each output (planes and RHS) is hashed, so the two checkouts' outputs can
be compared; at n = 96 each is also held to its own checkout's plain
version (``*_plain``) bit for bit.  Prints the card's name and power
limit, one line per case and turn and, last, one JSON object with each
case's mean over its two turns per checkout, the ratio B / A, whether the
checkouts' outputs agree and whether each turn's kernel equalled its plain
version.
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
from tpufem_torch.dist.assembly import build_poisson_system_sharded
from tpufem_torch.dist.mesh import make_mesh, unshard
from tpufem_torch.fem.quadrature import tetrahedron_rule
from tpufem_torch.ops import fused_system_cuda as fs
from tpufem_torch.solve.multigrid import _light_grid
from tpufem_torch.solve.poisson import model_problem_3d_planes
from tpufem_torch.utils.timing import cuda_ms

dev = torch.device("cuda", 0)
f, rule = model_problem_3d_planes(), tetrahedron_rule(2)


def digest(ts):
    h = hashlib.sha256()
    for t in ts:
        for part in t.reshape(-1).split(1 << 24):   # 128 MB at a time
            h.update(part.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def box(n, dtype, jitter=0.0):
    info, coords, bc = _light_grid((-3.0, 3.0), n)
    plan = structured_plan(info, embed=True)
    if jitter:
        h = 6.0 / n
        pert = np.random.default_rng(0).uniform(-jitter * h, jitter * h,
                                                size=coords.shape)
        coords = coords + np.where(~np.broadcast_to(bc, coords.shape), pert,
                                   0.0)
    return plan, torch.as_tensor(fs.node_coords_embedded_from_grid(
        coords, plan, dtype), device=dev)


def case(name, run, plain=None, joined=None):
    out = run() if joined is None else joined(run())
    torch.cuda.synchronize()
    outs = tuple(o.data if hasattr(o, "offsets") else o for o in out)
    rec = {"case": name, "sha256": digest(outs)}
    if plain is not None:
        ref = plain()
        ref = tuple(r.data if hasattr(r, "offsets") else r for r in ref)
        rec["plain_equal"] = all(torch.equal(o, r) for o, r in zip(outs, ref))
        del ref
    del out, outs
    rec["ms"] = cuda_ms(run, reps=20)
    torch.cuda.empty_cache()
    print(json.dumps(rec), flush=True)


for n, dt in ((96, np.float32), (96, np.float64), (384, np.float32),
              (384, np.float64)):
    plan, C = box(n, dt)
    case(f"K1 n={n} {np.dtype(dt).name}",
         lambda: fs.build_poisson_system(plan, C, f, rule),
         (lambda: fs.build_poisson_system_plain(plan, C, f, rule))
         if n == 96 else None)
    del C
    torch.cuda.empty_cache()

plan, C = box(96, np.float32, jitter=0.15)
depth = plan.store_grid[0] // 4
Cx = C[:, depth - 1:2 * depth + 1].contiguous()
case("B8 n=96 fp32 stripe 1 of 4",
     lambda: fs.build_poisson_stripe(plan, Cx, depth, f, rule),
     lambda: fs.build_poisson_stripe_plain(plan, Cx, depth, f, rule))
mesh = make_mesh(4, ("z",), device=dev)
case("four-stripe build n=96 fp32",
     lambda: build_poisson_system_sharded(plan, C, mesh, f, rule),
     joined=lambda out: tuple(unshard(t) for t in out))
"""


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    dirs = {"A": Path(sys.argv[1]).resolve(), "B": Path(sys.argv[2]).resolve()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    runs = {"A": [], "B": []}
    for key in ("A", "B", "B", "A"):
        out = subprocess.run([sys.executable, "-c", _TURN], cwd=dirs[key],
                             capture_output=True, text=True, timeout=1200)
        if out.returncode != 0:
            print(out.stderr, file=sys.stderr)
            return 1
        recs = [json.loads(line) for line in out.stdout.splitlines()
                if line.startswith("{")]
        for rec in recs:
            extra = ("" if "plain_equal" not in rec else
                     f", equal to its plain version: {rec['plain_equal']}")
            print(f"# {key} {rec['case']}: {rec['ms']:.4f} ms, output "
                  f"sha256 {rec['sha256']}{extra}", flush=True)
        runs[key].append({r["case"]: r for r in recs})
    summary = []
    for name in runs["B"][0]:
        ms = {k: sum(t[name]["ms"] for t in v) / len(v)
              for k, v in runs.items()}
        summary.append({
            "case": name, "ms_A": ms["A"], "ms_B": ms["B"],
            "ratio_B_over_A": ms["B"] / ms["A"],
            "outputs_equal": len({t[name]["sha256"] for v in runs.values()
                                  for t in v}) == 1,
            "plain_equal": {k: [t[name].get("plain_equal") for t in v]
                            for k, v in runs.items()}})
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
