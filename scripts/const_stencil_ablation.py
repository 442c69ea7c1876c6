"""Where the time of the staged const stencil kernel B5 (also B5b's route)
goes, on one NVIDIA GPU: the sweep timed as built from
csrc/const_stencil.cu and from copies with one part of its work taken
out.

    python scripts/const_stencil_ablation.py

The copies (written under tpufem_torch/_build/, built in parallel) are
timing probes only: their outputs are wrong by construction.

  * ``empty``: every block returns at once: the launch and the blocks'
    scheduling; ``empty0`` the same launched without dynamic shared
    memory;
  * ``nowait``: no wait for the staged planes' copies (a time equal to
    ``base`` means the copies had landed before they were needed);
  * ``nostage``: no copies at all (the staged planes hold what the shared
    memory held): what moving x, code and b costs;
  * ``noform``: no masked planes formed (the taps read what the ring
    held);
  * ``notaps``: the K taps replaced by one read;
  * ``nosync``: no barrier a step (races: the probe times the rest);
  * ``bdirect``: b read from device memory in the epilogue, not staged
    (a design probe: its fields are right where every tile row lies in
    the grid);
  * ``bare``: ``nostage``, ``noform`` and ``notaps`` at once: the loops,
    barriers, epilogue, stores and launch that remain.

Each is the median of 30 launches with CUDA events (the stream queued
ahead) of the sweep (``const_stencil_apply("smooth", ...)``), fp32, with
the tiles ``const_tiling`` picks, on the finest const level of 3D n=96,
2D n=1024 and 3D n=384 (B5b's shape).  Prints the card's name and power
limit, then one line per shape and variant.
"""
from __future__ import annotations

import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

_EMPTY = ("  const int x0 = blockIdx.x * kTileX;",
          "  if (tz > 0) return;\n  const int x0 = blockIdx.x * kTileX;")
_WAIT = ("    tpufem::cp_async_wait_all();\n", "")
_STAGE = [("  stage_plane(p0, 0);\n", ""),
          ("    if (i + 1 < nf) stage_plane(p0 + i + 1, (i + 1) % NRAW);\n",
           ""),
          ("    if (EPI != kMatvec && qs >= z0 && qs < z1) "
           "stage_b(qs, (i + 1) & 1);\n", "")]
_FORM = ("      for (int k = threadIdx.x; k < RY * NC; k += kThreads) {",
         "      for (int k = threadIdx.x; k < 0; k += kThreads) {")
_TAPS = ("tpufem::taps<K, RW>(below, mid, above, j, op)", "mid[j]")
_SYNC = ("    tpufem::cp_async_wait_all();\n    __syncthreads();",
         "    tpufem::cp_async_wait_all();")
_SMEM0 = ("        <<<grid, kThreads, smem, s>>>",
          "        <<<grid, kThreads, 0, s>>>")
_BDIRECT = [_STAGE[2],
            ("bb[row * kTileX + col]",
             "b[(static_cast<long long>(HZ ? q : 0) * g.s1 + yy) * g.s2 + x0"
             " + col]")]
VARIANTS = {"base": [], "empty": [_EMPTY], "empty0": [_EMPTY, _SMEM0],
            "nowait": [_WAIT], "nostage": _STAGE, "noform": [_FORM],
            "notaps": [_TAPS], "nosync": [_SYNC],
            "bdirect": _BDIRECT, "bare": _STAGE + [_FORM, _TAPS]}


def main() -> int:
    import torch

    from tpufem_torch.ops import stencil_cuda as sc
    from tpufem_torch.ops._build import BUILD_DIR, CSRC_DIR, load_library
    from tpufem_torch.solve.multigrid import build_poisson_multigrid
    from tpufem_torch.utils.timing import cuda_ms

    if not torch.cuda.is_available():
        print("const_stencil_ablation: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    source = (CSRC_DIR / "const_stencil.cu").read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, subs in VARIANTS.items():
        text = source
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} is not in "
                                 "csrc/const_stencil.cu")
            text = text.replace(old, new)
        path = BUILD_DIR / f"const_stencil_{name}.cu"
        path.write_text(text)
        paths[name] = str(path)
    with ThreadPoolExecutor(len(paths)) as pool:
        libs = dict(zip(paths, pool.map(
            lambda p: load_library(p, sc._CONST_SIGNATURES), paths.values())))
    dev = torch.device("cuda", 0)
    built = sc._const_lib
    try:
        for dim, n in ((3, 96), (2, 1024), (3, 384)):
            lv = build_poisson_multigrid((-3.0, 3.0), n, dim,
                                         operator="const", device=dev,
                                         levels=1)[0]
            g = torch.Generator(device=dev).manual_seed(n)
            x, b = (torch.where(lv.code != 0, torch.randn(
                lv.code.shape, generator=g, device=dev), 0.0)
                for _ in range(2))
            tile = sc.const_tiling(len(lv.weights), 4,
                                   tuple(lv.plan.store_grid), 4)[:2]
            for name, lib in libs.items():
                sc._const_lib = lambda lib=lib: lib
                ms = cuda_ms(lambda: sc.const_stencil_apply(
                    "smooth", lv.weights, lv.code, x, lv.plan.offsets, b=b),
                    reps=30)
                print(f"# {dim}D n={n} fp32 smooth, tile {tile} "
                      f"{name:8s} {ms:.4f} ms")
            del lv, x, b
            torch.cuda.empty_cache()
    finally:
        sc._const_lib = built
    return 0


if __name__ == "__main__":
    sys.exit(main())
