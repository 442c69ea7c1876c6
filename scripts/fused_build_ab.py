"""Time the structured builds of tpufem_torch, K1 and B8 (3D system),
B13 (Kuhn-tet stiffness from element coordinates) and B7 (2D system),
from two checkouts of this repository on one NVIDIA GPU, in turns A, B, B,
A.

    python scripts/fused_build_ab.py <checkout A> <checkout B> [--tiles]

Each turn is a fresh process that imports ``tpufem_torch`` from its
checkout, builds the kernels from that checkout's sources, and times, as
the median of 20 launches with CUDA events (the stream queued ahead), with
the degree-2 rule and the quadrature RHS:

  * K1, ``build_poisson_system``, on the uniform box with n = 96 cells a
    side (912,673 DOFs, the main path's) and n = 384 (57,066,625 DOFs,
    the scale path's), each in fp32 and fp64;
  * B8, ``build_poisson_stripe``, on the second of 4 z-stripes of 26
    store planes of the n = 96 box with its interior nodes jittered by
    +-0.15 h (default_rng(0), as chip_smoke.py's dist_assembly), fp32;
  * the four-stripe build, ``dist.assembly.build_poisson_system_sharded``
    on a 4-shard mesh on the one card, of the same box;
  * B13, ``assemble_stencil_cuda``, on the element coordinates of the
    n = 96 Kuhn box of (-3, 3)^3 (the assembly path's) in fp32 and fp64
    and of the 5 x 4 x 6 box of chip_smoke.py, fp32;
  * B7, the 2D ``build_poisson_system`` with the elimination, on the
    square (-3, 3)^2 with n = 1024 cells a side (1,050,625 DOFs, the 2d
    paths'), in fp32 and fp64 (2d_dirichlet's type).

Each output (planes and RHS) is hashed, so the two checkouts' outputs can
be compared; at n = 96 (K1), in every B8, B13 and B7 case, each is also
held to its own checkout's plain version (``*_plain``) bit for bit.
Prints the card's name and power limit, one line per case and turn and,
last, one JSON object with each case's mean over its two turns per
checkout, the ratio B / A, whether the checkouts' outputs agree and
whether each turn's kernel equalled its plain version.

``--tiles`` first sweeps checkout B's B13 and B7 tiles, each time with
the chooser forced: B13 at n = 96 (fp32, fp64) over every built (columns,
rows) tile and marches of 6 .. 52 planes, B7 at
n = 1024 (fp32, fp64) over every built tile and bands of 2 .. 12 rows,
the choosers' picks marked.
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
from tpufem_torch.fem.quadrature import tetrahedron_rule, triangle_rule
from tpufem_torch.mesh.box import box_mesh
from tpufem_torch.ops import assemble_cuda as ac
from tpufem_torch.ops import fused_system_cuda as fs
from tpufem_torch.solve.multigrid import _light_grid
from tpufem_torch.solve.poisson import (model_problem_2d_planes,
                                        model_problem_3d_planes)
from tpufem_torch.utils.timing import cuda_ms

dev = torch.device("cuda", 0)
f, rule = model_problem_3d_planes(), tetrahedron_rule(2)
f2, rule2 = model_problem_2d_planes(), triangle_rule(2)


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


def assembly_box(shape):
    # (plan, X_emb fp64 on the card): the Kuhn box of (-3, 3)^3 with shape
    # cells a side, or chip_smoke.py's box with shape = (nx, ny, nz) cells
    if isinstance(shape, tuple):
        mesh = box_mesh(-1, 2, 0, 1, -2, 0, *shape)
    else:
        mesh = box_mesh(-3, 3, -3, 3, -3, 3, shape, shape, shape)
    plan = structured_plan(mesh, embed=True)
    return plan, torch.as_tensor(ac.element_coords_bt_embedded(
        mesh, plan, dtype=np.float64), device=dev)


def square(n, dtype):
    info, coords, _ = _light_grid((-3.0, 3.0), n, 2)
    plan = structured_plan(info, embed=True)
    return plan, torch.as_tensor(fs.node_coords_embedded_from_grid(
        coords, plan, dtype), device=dev)


def data_of(out):
    out = out if isinstance(out, tuple) else (out,)
    return tuple(o.data if hasattr(o, "offsets") else o for o in out)


def case(name, run, plain=None, joined=None):
    out = run() if joined is None else joined(run())
    torch.cuda.synchronize()
    outs = data_of(out)
    rec = {"case": name, "sha256": digest(outs)}
    if plain is not None:
        ref = data_of(plain())
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
del C, Cx
torch.cuda.empty_cache()

for shape, dts in ((96, (torch.float32, torch.float64)),
                   ((5, 4, 6), (torch.float32,))):
    plan, X64 = assembly_box(shape)
    label = (f"n={shape}" if not isinstance(shape, tuple)
             else "box {}x{}x{}".format(*shape))
    for dt in dts:
        X = X64.to(dt)
        case(f"B13 {label} {str(dt)[6:]}",
             lambda: ac.assemble_stencil_cuda(plan, X),
             lambda: ac.assemble_stencil_plain(plan, X))
        del X
    del X64
    torch.cuda.empty_cache()

for dt in (np.float32, np.float64):
    plan, C = square(1024, dt)
    case(f"B7 2D n=1024 {np.dtype(dt).name}",
         lambda: fs.build_poisson_system(plan, C, f2, rule2),
         lambda: fs.build_poisson_system_plain(plan, C, f2, rule2))
    del C
    torch.cuda.empty_cache()
"""

# checkout B's B13 and B7 tiles, each chooser forced in turn
_SWEEP = r"""
import sys
import numpy as np, torch
sys.path.insert(0, ".")
from tpufem_torch.assemble.structured import structured_plan
from tpufem_torch.fem.quadrature import triangle_rule
from tpufem_torch.mesh.box import box_mesh
from tpufem_torch.ops import assemble_cuda as ac
from tpufem_torch.ops import fused_system_cuda as fs
from tpufem_torch.solve.multigrid import _light_grid
from tpufem_torch.solve.poisson import model_problem_2d_planes
from tpufem_torch.utils.timing import cuda_ms

dev = torch.device("cuda", 0)
mesh = box_mesh(-3, 3, -3, 3, -3, 3, 96, 96, 96)
plan = structured_plan(mesh, embed=True)
X64 = torch.as_tensor(ac.element_coords_bt_embedded(mesh, plan,
                                                     dtype=np.float64),
                      device=dev)
real = ac.assemble_tiling
for dt in (torch.float32, torch.float64):
    X = X64.to(dt)
    pick = real(X.element_size(), tuple(plan.store_grid))[:3]
    for tx, ty in ac.ASSEMBLE_TILES:
        for tz in sorted({6, 13, 21, 26, 35, 52, pick[2]}):
            t = (tx, ty, tz)
            ac.assemble_tiling = lambda i, g, t=t: (*t, 0, None)
            ms = cuda_ms(lambda: ac.assemble_stencil_cuda(plan, X), reps=20)
            mark = "  <- pick" if t == pick else ""
            print(f"# tiles B13 n=96 {str(dt)[6:]} {t}: {ms:.4f} ms{mark}",
                  flush=True)
    ac.assemble_tiling = real
    del X
del X64
torch.cuda.empty_cache()

info, coords, _ = _light_grid((-3.0, 3.0), 1024, 2)
plan = structured_plan(info, embed=True)
f2, rule2 = model_problem_2d_planes(), triangle_rule(2)
real = fs.fused_2d_tiling
for dt in (np.float32, np.float64):
    C = torch.as_tensor(fs.node_coords_embedded_from_grid(coords, plan, dt),
                        device=dev)
    pick = real(C.element_size(), tuple(plan.store_grid))[:2]
    for tx in fs.FUSED_2D_TILES:
        for rows in sorted({2, 3, 4, 5, 6, 8, 12, pick[1]}):
            fs.fused_2d_tiling = (lambda i, g, t=(tx, rows): (*t, 0, None))
            ms = cuda_ms(lambda: fs.build_poisson_system(plan, C, f2, rule2),
                         reps=20)
            mark = "  <- pick" if (tx, rows) == pick else ""
            print(f"# tiles B7 2D n=1024 {np.dtype(dt).name} {(tx, rows)}: "
                  f"{ms:.4f} ms{mark}", flush=True)
    fs.fused_2d_tiling = real
    del C
"""


def main() -> int:
    args = [a for a in sys.argv[1:] if a != "--tiles"]
    if len(args) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    dirs = {"A": Path(args[0]).resolve(), "B": Path(args[1]).resolve()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    if "--tiles" in sys.argv:
        out = subprocess.run([sys.executable, "-c", _SWEEP], cwd=dirs["B"],
                             capture_output=True, text=True, timeout=1200)
        print(out.stdout.strip(), flush=True)
        if out.returncode != 0:
            print(out.stderr, file=sys.stderr)
            return 1
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
