"""Where the time of the tiled fused system build K1 (and B8, its stripe
instance) goes, on one NVIDIA GPU: K1 timed as built from
csrc/fused_system.cu and from copies with one part of its work taken out,
and a sweep of its tiles.

    python scripts/fused_build_ablation.py [--parent CHECKOUT] [--tiles]

The copies (written under tpufem_torch/_build/, built in parallel) are
timing probes only: their outputs are wrong by construction.

  * ``empty``: every block returns at once: the launch and the blocks'
    scheduling;
  * ``copies``: only the staging of the coordinate planes (no cell phase,
    no node phase, no stores);
  * ``cells``: the copies and the cell phase (each tetrahedron's
    geometry, stiffness entries and loads into shared memory), no node
    phase and no stores;
  * ``nodes``: the copies and the node phase (the tile's terms added into
    the accumulators) and the stores, no cell phase (the values are what
    shared memory held);
  * ``nostore``: everything but the epilogue and the stores of the K + 1
    output planes (``base`` less this is what they cost);
  * ``notet``: each tetrahedron's 14 values replaced by one staged
    coordinate (the cell phase's loop, zeros, stores and barrier remain);
  * ``fma``: the kernel as it is, built without ``-fmad=false`` (what
    rounding each product and sum on its own costs);
  * ``norcp``: the reciprocal of the determinant replaced by the
    determinant (what the correctly rounded reciprocal costs);
  * ``nosync``: no barrier between the cell and the node phase of a
    round (races; the probe times the rest).

Each is the median of 20 launches with CUDA events (the stream queued
ahead) of ``build_poisson_system`` on the uniform box (degree-2 rule,
quadrature RHS) at n=96 in fp32 and fp64 and at n=384 in fp32, with the
tiles ``fused_tiling`` picks; ``base`` is also timed with the ``interp``
RHS (f at the vertices, no quadrature points).  ``--parent`` also times
the parent checkout's K1 at the same shapes (in a process of its own, its
source built there): the build that computed each tetrahedron once per
vertex.  ``--tiles`` times ``base`` at n=96 (fp32, fp64) and at one
26-plane stripe of 4 (B8) for every tile (columns, rounds of types) in
``FUSED_TILES`` and march of 3 .. 26 planes, and prints each instance's
registers and spills (``-Xptxas -v``) and shared memory per block.  Prints the card's name and
power limit first, then one line per shape and variant.
"""
from __future__ import annotations

import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

_CELL = ("      cell_phase<T, TX, NR>(lo, hi, vals, r, y0, x0, zok, m1, m2, "
         "rhs_mode);\n", "")
_NODE = ("      node_phase<T, TX, NR>(vals + me, r, cur, nxt);\n", "")
_STORE = ("    if (s > 0 && sy < S1) {",
          "    if (s > 0 && sy < S1 && rhs_mode == 7) {")
_EMPTY = ("  using Tl = Tile<T, TX, NR>;\n  constexpr int PS = Tl::PS;\n",
          "  if (tz > 0) return;\n  using Tl = Tile<T, TX, NR>;\n"
          "  constexpr int PS = Tl::PS;\n")
_RCP = ("  const T inv_det = rcp_rn(det);", "  const T inv_det = det;")
_TET = ("  T X[4][3];\n#pragma unroll\n  for (int n = 0; n < 4; ++n) {\n",
        "  if (rhs_mode >= 0) {\n"
        "    for (int v = 0; v < kVals; ++v) out[v * stride] = lo[j];\n"
        "    return;\n  }\n"
        "  T X[4][3];\n#pragma unroll\n  for (int n = 0; n < 4; ++n) {\n")
_SYNC = ("      __syncthreads();\n      node_phase<T, TX, NR>",
         "      node_phase<T, TX, NR>")
VARIANTS = {"base": [], "empty": [_EMPTY],
            "copies": [_CELL, _NODE, _STORE], "cells": [_NODE, _STORE],
            "nodes": [_CELL], "nostore": [_STORE], "notet": [_TET],
            "norcp": [_RCP], "nosync": [_SYNC], "fma": []}
# built without -fmad=false: products and sums contract into fused
# multiply-adds (the outputs then differ from the plain version's)
_FMA = {"fma"}

_PARENT = r"""
import sys
import numpy as np, torch
sys.path.insert(0, ".")
from tpufem_torch.assemble.structured import structured_plan
from tpufem_torch.fem.quadrature import tetrahedron_rule
from tpufem_torch.ops.fused_system_cuda import (build_poisson_system,
                                                node_coords_embedded_from_grid)
from tpufem_torch.solve.multigrid import _light_grid
from tpufem_torch.solve.poisson import model_problem_3d_planes
from tpufem_torch.utils.timing import cuda_ms

f, rule = model_problem_3d_planes(), tetrahedron_rule(2)
for n, dt in ((96, np.float32), (96, np.float64), (384, np.float32)):
    info, coords, _ = _light_grid((-3.0, 3.0), n)
    plan = structured_plan(info, embed=True)
    C = torch.as_tensor(node_coords_embedded_from_grid(coords, plan, dt),
                        device="cuda")
    ms = cuda_ms(lambda: build_poisson_system(plan, C, f, rule), reps=20)
    print(f"# n={n} {np.dtype(dt).name} parent   {ms:.4f} ms", flush=True)
    del C
    torch.cuda.empty_cache()
"""


def _box(n, dtype, dev):
    import numpy as np
    import torch

    from tpufem_torch.assemble.structured import structured_plan
    from tpufem_torch.ops.fused_system_cuda import \
        node_coords_embedded_from_grid
    from tpufem_torch.solve.multigrid import _light_grid

    info, coords, _ = _light_grid((-3.0, 3.0), n)
    plan = structured_plan(info, embed=True)
    return plan, torch.as_tensor(node_coords_embedded_from_grid(
        coords, plan, dtype), device=dev)


def _ptxas(build_dir, stem):
    """Registers and spills of each kernel instance of a built source."""
    for log in sorted(build_dir.glob(f"{stem}-*.log")):
        name = None
        for line in log.read_text().splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1]
            elif name and ("registers" in line or "spill" in line):
                print(f"# ptxas {name}: {line.strip()}")


def main() -> int:
    import numpy as np
    import torch

    from tpufem_torch.fem.quadrature import tetrahedron_rule
    from tpufem_torch.ops import fused_system_cuda as fs
    from tpufem_torch.ops._build import BUILD_DIR, CSRC_DIR, load_library
    from tpufem_torch.solve.poisson import model_problem_3d_planes
    from tpufem_torch.utils.timing import cuda_ms

    if not torch.cuda.is_available():
        print("fused_build_ablation: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    parent = args[args.index("--parent") + 1] if "--parent" in args else None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    f, rule = model_problem_3d_planes(), tetrahedron_rule(2)
    dev = torch.device("cuda", 0)
    plan96, _ = _box(8, np.float32, "cpu")
    header = {"tpufem_fused_tables.h": fs.tables_header(plan96, rule,
                                                         f.c_expr)}
    source = (CSRC_DIR / "fused_system.cu").read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, subs in VARIANTS.items():
        text = source
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} is not in "
                                 "csrc/fused_system.cu")
            text = text.replace(old, new)
        path = BUILD_DIR / f"fused_system_{name}.cu"
        path.write_text(text)
        paths[name] = str(path)
    with ThreadPoolExecutor(len(paths)) as pool:
        libs = dict(zip(paths, pool.map(
            lambda kv: load_library(kv[1], fs._SIGNATURES[3], header,
                                    flags=() if kv[0] in _FMA
                                    else fs._FLAGS[3]), paths.items())))
    built = fs._lib
    try:
        for n, dt in ((96, np.float32), (96, np.float64),
                      (384, np.float32)):
            plan, C = _box(n, dt, dev)
            dname = np.dtype(dt).name
            tile = fs.fused_tiling(C.element_size(),
                                   tuple(plan.store_grid))[:4]
            for name, lib in libs.items():
                fs._lib = lambda *a, lib=lib: lib
                for mode in ("quadrature", "interp")[:2 if name == "base"
                                                     else 1]:
                    ms = cuda_ms(lambda: fs.build_poisson_system(
                        plan, C, f, rule, rhs_mode=mode), reps=20)
                    label = name if mode == "quadrature" else "interp"
                    print(f"# n={n} {dname} tile {tile} {label:8s} "
                          f"{ms:.4f} ms", flush=True)
            if "--tiles" in args and n == 96:
                fs._lib = lambda *a: libs["base"]
                _sweep(fs, plan, C, f, rule, dname, cuda_ms)
            del C
            torch.cuda.empty_cache()
    finally:
        fs._lib = built
    if "--tiles" in args:
        for it in (4, 8):
            for tx, nr in fs.FUSED_TILES:
                print(f"# shared memory: itemsize {it}, {tx} columns, {nr} "
                      f"rounds: {fs.fused_smem(it, tx, nr)} B")
        _ptxas(BUILD_DIR, "fused_system_base")
    if parent is not None:
        out = subprocess.run([sys.executable, "-c", _PARENT], cwd=parent,
                             capture_output=True, text=True, timeout=900)
        print(out.stdout.strip())
        if out.returncode != 0:
            print(out.stderr, file=sys.stderr)
            return 1
    return 0


def _sweep(fs, plan, C, f, rule, dname, cuda_ms):
    """K1 and one B8 stripe (26 planes of 4) at every tile."""
    import torch

    real = fs.fused_tiling
    sg = tuple(plan.store_grid)
    depth = sg[0] // 4
    z = depth
    Cx = C[:, z - 1:z + depth + 1].contiguous()
    pick = (real(C.element_size(), sg)[:4],
            real(C.element_size(), (depth,) + sg[1:])[:4])
    try:
        for tx, nr in fs.FUSED_TILES:
            for tz in (3, 4, 6, 8, 13, 26):
                fs.fused_tiling = (lambda i, g, tx=tx, nr=nr, tz=tz:
                                   (tx, 256 // tx, nr, tz, 0, None))
                k1 = cuda_ms(lambda: fs.build_poisson_system(plan, C, f,
                                                             rule), reps=20)
                b8 = (cuda_ms(lambda: fs.build_poisson_stripe(
                    plan, Cx, z, f, rule), reps=20) if tz <= depth else None)
                tile = (tx, 256 // tx, nr, tz)
                mark = ("K1 pick " if tile == pick[0] else "") + (
                    "B8 pick" if tile == pick[1] else "")
                print(f"# tiles n=96 {dname} {tile}: K1 {k1:.4f} ms"
                      + (f", B8 stripe {b8:.4f} ms" if b8 else "")
                      + (f"  <- {mark}" if mark else ""), flush=True)
    finally:
        fs.fused_tiling = real
    del Cx
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
