"""Where the time of the structured builds B13 (csrc/assemble.cu) and B7
(csrc/fused_system_2d.cu) goes, on one NVIDIA GPU: each timed as built
from its source and from copies with one part of its work taken out.

    python scripts/structured_build_ablation.py

The copies (written under tpufem_torch/_build/, built in parallel) are
timing probes only: their outputs are wrong by construction.

  * ``empty``: every block returns at once: the launch and the blocks'
    scheduling;
  * ``loads``: the cell phase's coordinate loads only (each
    tetrahedron's or cell's coordinates summed into one shared value), no
    geometry, no node phase, no stores;
  * ``cells``: the loads and the cell phase (geometry and the element
    values into shared memory), no node phase and no stores;
  * ``nodes``: no cell phase (the values are what shared memory held):
    the node phase and the stores;
  * ``nostore``: everything but the stores of the output planes (``base``
    less this is what they cost);
  * ``fma``: the kernel as it is, built without ``-fmad=false`` (B7 only:
    what rounding each product and sum on its own costs).

Each is the median of 20 launches with CUDA events (the stream queued
ahead) with the tiles the choosers pick (``base`` also at every tile of
``B13_SWEEP`` and ``B7_SWEEP``, and held to its plain version): B13 on
the element coordinates of the n = 96 Kuhn box of (-3, 3)^3 (the
assembly path's) in fp32 and fp64, B7 with the quadrature RHS and the
elimination on the square (-3, 3)^2 with n = 1024 cells a side (the 2d
paths') in fp32 and fp64.
Prints the card's name and power limit first, then one line per shape
and variant, then each instance's registers and spills.
"""
from __future__ import annotations

import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

_SMEM = "  extern __shared__ __align__(16) unsigned char smem[];\n"
_EMPTY = (_SMEM, "  if (S0 > 0) return;\n" + _SMEM)

# B13 (csrc/assemble.cu)
_B13_CELL = ("      cell_phase<T, TX, TY>(X, vals, c, y0, x0, m1, m2, plane, "
             "ns, S2);\n", "")
_B13_NODE = [("      TPUFEM_ASM_FOR_LATE(TPUFEM_ASM_LATE_SUM, "
              "TPUFEM_ASM_LATE_KEPT)\n", ""),
             ("    TPUFEM_ASM_FOR_EARLY(TPUFEM_ASM_EARLY_SUM, "
              "TPUFEM_ASM_EARLY_KEEP)\n", "")]
_B13_STORE = ("      if (sy < S1) {\n", "      if (sy < S1 && S0 < 0) {\n")
_B13_LOADS = ("  T J[3][3];\n",
              "  {\n    T sum = T(0);\n    for (int n = 0; n < 4; ++n)\n"
              "      for (int d = 0; d < 3; ++d) sum += V[n][d];\n"
              "    out[0] = sum;\n    return;\n  }\n  T J[3][3];\n")
B13_VARIANTS = {
    "base": [], "empty": [_EMPTY],
    "loads": [_B13_LOADS, *_B13_NODE, _B13_STORE],
    "cells": [*_B13_NODE, _B13_STORE], "nodes": [_B13_CELL],
    "nostore": [_B13_STORE]}
# B13 tiles timed for ``base``: (columns, rows, planes)
B13_SWEEP = [(tx, ty, tz) for tx, ty in ((64, 4), (32, 4)) for tz in (13, 21)]

# B7 (csrc/fused_system_2d.cu)
_B7_CELL = ("      cell_phase<T, TX>(C, ring + (s % kRing) * Tl::ROW, c, xc, "
            "m1, ns, S1,\n                        rhs_mode);\n", "")
_B7_NODE = ("    TPUFEM_FOR_TA(TPUFEM_NODE_TERM)\n", "")
_B7_STORE = ("    rhs[idx] = racc;\n",
             "    rhs[idx] = racc;\n    }\n")
_B7_STORE_OPEN = ("    const long long idx = static_cast<long long>(sy) * S1 "
                  "+ sx;\n",
                  "    const long long idx = static_cast<long long>(sy) * S1 "
                  "+ sx;\n    if (S0 < 0) {\n")
_B7_LOADS = ("#define TPUFEM_TYPE_TRI(",
             "  {\n    T sum = T(0);\n    for (int y = 0; y < 2; ++y)\n"
             "      for (int x = 0; x < 2; ++x)\n"
             "        sum += Q[y][x][0] + Q[y][x][1];\n"
             "    row[lx] = sum;\n    return;\n  }\n"
             "#define TPUFEM_TYPE_TRI(")
B7_VARIANTS = {
    "base": [], "empty": [_EMPTY],
    "loads": [_B7_LOADS, _B7_NODE, _B7_STORE_OPEN, _B7_STORE],
    "cells": [_B7_NODE, _B7_STORE_OPEN, _B7_STORE], "nodes": [_B7_CELL],
    "nostore": [_B7_STORE_OPEN, _B7_STORE], "fma": []}
# B7 tiles timed for ``base``: (threads, band rows)
B7_SWEEP = [(64, rows) for rows in (3, 5)]


def _write(source, variants, stem, build_dir, csrc):
    text0 = (csrc / source).read_text()
    paths = {}
    for name, subs in variants.items():
        text = text0
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{stem} variant {name}: {old!r} is not in "
                                 f"csrc/{source}")
            text = text.replace(old, new)
        path = build_dir / f"{stem}_{name}.cu"
        path.write_text(text)
        paths[name] = str(path)
    return paths


def _ptxas(build_dir, stem):
    for log in sorted(build_dir.glob(f"{stem}_*-*.log")):
        name = None
        for line in log.read_text().splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1]
            elif name and ("registers" in line or "spill" in line):
                print(f"# ptxas {log.stem.split('-')[0]} {name}: "
                      f"{line.strip()}")


def main() -> int:
    import numpy as np
    import torch

    from tpufem_torch.assemble.structured import structured_plan
    from tpufem_torch.fem.quadrature import triangle_rule
    from tpufem_torch.mesh.box import box_mesh
    from tpufem_torch.ops import assemble_cuda as ac
    from tpufem_torch.ops import fused_system_cuda as fs
    from tpufem_torch.ops._build import BUILD_DIR, CSRC_DIR, load_library
    from tpufem_torch.solve.multigrid import _light_grid
    from tpufem_torch.solve.poisson import model_problem_2d_planes
    from tpufem_torch.utils.timing import cuda_ms

    if not torch.cuda.is_available():
        print("structured_build_ablation: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)

    mesh = box_mesh(-3, 3, -3, 3, -3, 3, 96, 96, 96)
    plan3 = structured_plan(mesh, embed=True)
    info2, coords2, _ = _light_grid((-3.0, 3.0), 1024, 2)
    plan2 = structured_plan(info2, embed=True)
    f2, rule2 = model_problem_2d_planes(), triangle_rule(2)
    h13 = {"tpufem_assemble_tables.h": ac.tables_header(plan3)}
    h7 = {"tpufem_fused_tables.h": fs.tables_header(plan2, rule2,
                                                    f2.c_expr)}
    p13 = _write("assemble.cu", B13_VARIANTS, "assemble", BUILD_DIR,
                 CSRC_DIR)
    p7 = _write("fused_system_2d.cu", B7_VARIANTS, "fused_system_2d",
                BUILD_DIR, CSRC_DIR)
    jobs = ([("B13", n, p, h13, ac._SIGNATURES, ()) for n, p in p13.items()]
            + [("B7", n, p, h7, fs._SIGNATURES[2],
                () if n == "fma" else fs._FLAGS[2]) for n, p in p7.items()])
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = list(pool.map(lambda j: load_library(j[2], j[4], j[3],
                                                    flags=j[5]), jobs))
    built13, built7 = ac._lib, fs._lib
    try:
        X64 = torch.as_tensor(ac.element_coords_bt_embedded(
            mesh, plan3, dtype=np.float64), device=dev)
        for dt in (torch.float32, torch.float64):
            X = X64.to(dt)
            tile = ac.assemble_tiling(X.element_size(),
                                      tuple(plan3.store_grid))[:3]
            for (kern, name, *_), lib in zip(jobs, libs):
                if kern != "B13":
                    continue
                ac._lib = lambda *a, lib=lib: lib
                ms = cuda_ms(lambda: ac.assemble_stencil_cuda(plan3, X),
                             reps=20)
                same = ""
                if name == "base":
                    same = ", equal to its plain version: " + str(torch.equal(
                        ac.assemble_stencil_cuda(plan3, X).data,
                        ac.assemble_stencil_plain(plan3, X).data))
                print(f"# B13 n=96 {str(dt)[6:]} tile {tile} {name:8s} "
                      f"{ms:.4f} ms{same}", flush=True)
                if name != "base":
                    continue
                real = ac.assemble_tiling
                try:
                    for t in B13_SWEEP:
                        ac.assemble_tiling = lambda i, g, t=t: (*t, 0, None)
                        ms = cuda_ms(lambda: ac.assemble_stencil_cuda(
                            plan3, X), reps=20)
                        print(f"# B13 n=96 {str(dt)[6:]} tile {t} "
                              f"{name:8s} {ms:.4f} ms", flush=True)
                finally:
                    ac.assemble_tiling = real
            del X
        del X64
        torch.cuda.empty_cache()
        for np_dt in (np.float32, np.float64):
            C = torch.as_tensor(fs.node_coords_embedded_from_grid(
                coords2, plan2, np_dt), device=dev)
            tile = fs.fused_2d_tiling(C.element_size(),
                                      tuple(plan2.store_grid))[:2]
            for (kern, name, *_), lib in zip(jobs, libs):
                if kern != "B7":
                    continue
                fs._lib = lambda *a, lib=lib: lib
                ms = cuda_ms(lambda: fs.build_poisson_system(plan2, C, f2,
                                                             rule2), reps=20)
                same = ""
                if name == "base":
                    out = fs.build_poisson_system(plan2, C, f2, rule2)
                    ref = fs.build_poisson_system_plain(plan2, C, f2, rule2)
                    same = ", equal to its plain version: " + str(
                        torch.equal(out[0].data, ref[0].data)
                        and torch.equal(out[1], ref[1]))
                    del out, ref
                print(f"# B7 2D n=1024 {np.dtype(np_dt).name} tile {tile} "
                      f"{name:8s} {ms:.4f} ms{same}", flush=True)
                if name != "base":
                    continue
                real = fs.fused_2d_tiling
                try:
                    for t in B7_SWEEP:
                        fs.fused_2d_tiling = lambda i, g, t=t: (*t, 0, None)
                        ms = cuda_ms(lambda: fs.build_poisson_system(
                            plan2, C, f2, rule2), reps=20)
                        print(f"# B7 2D n=1024 {np.dtype(np_dt).name} tile "
                              f"{t} {name:8s} {ms:.4f} ms", flush=True)
                finally:
                    fs.fused_2d_tiling = real
            del C
    finally:
        ac._lib, fs._lib = built13, built7
    _ptxas(BUILD_DIR, "assemble")
    _ptxas(BUILD_DIR, "fused_system_2d")
    return 0


if __name__ == "__main__":
    sys.exit(main())
