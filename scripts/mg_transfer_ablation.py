"""Where the time of the tiled transfer kernels K3 and K4 goes, on one
NVIDIA GPU: each kernel timed as built from csrc/mg_transfer.cu and from
copies with one part of its work taken out.

    python scripts/mg_transfer_ablation.py

The copies (written under tpufem_torch/_build/, built in parallel) are
timing probes only: their outputs are wrong by construction.

  * ``nowait``: no wait for the staged planes' copies (a time equal to
    ``base`` means the copies had landed before they were needed);
  * ``nostage``: no copies at all (the staged planes hold what the shared
    memory held): what moving e, code and r costs;
  * ``notaps``: A's 15 taps replaced by one read;
  * ``noprolong``: K4's prolongation P ec replaced by 0 (K3 has none);
  * ``bare``: ``nostage``, ``notaps`` and ``noprolong`` at once: the
    loops, barriers, stores and launch that remain.

Each is the median of 30 launches with CUDA events (the stream queued
ahead), fp32, on the finest level pair of the const hierarchy at
96 -> 48 and 384 -> 192, with the tiles ``transfer_tiling`` picks.
Prints the card's name and power limit, then one line per shape and
variant.
"""
from __future__ import annotations

import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

_WAIT = ("    cp_async_wait_all();\n    __syncthreads();\n    stage(i);",
         "    __syncthreads();\n    stage(i);")
_STAGE = ("    stage(i);\n", "    cp_async_commit();\n")
_TAPS = ("tpufem::taps<kOffsets, RW>(below, mid, above, j, op)", "mid[j]")
_PROLONG = ("  const bool ok_lo = az.ok_lo && ay.ok_lo && ax.ok_lo;",
            "  if (g.n0 >= 0) return T(0);\n"
            "  const bool ok_lo = az.ok_lo && ay.ok_lo && ax.ok_lo;")
VARIANTS = {"base": (), "nowait": (_WAIT,), "nostage": (_STAGE,),
            "notaps": (_TAPS,), "noprolong": (_PROLONG,),
            "bare": (_STAGE, _TAPS, _PROLONG)}


def main() -> int:
    import torch

    from tpufem_torch.ops import mg_transfer_cuda as mt
    from tpufem_torch.ops._build import BUILD_DIR, CSRC_DIR, load_library
    from tpufem_torch.solve.multigrid import build_poisson_multigrid
    from tpufem_torch.utils.timing import cuda_ms

    if not torch.cuda.is_available():
        print("mg_transfer_ablation: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    source = (CSRC_DIR / "mg_transfer.cu").read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, subs in VARIANTS.items():
        text = source
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} is not in "
                                 "csrc/mg_transfer.cu")
            text = text.replace(old, new)
        path = BUILD_DIR / f"mg_transfer_{name}.cu"
        path.write_text(text)
        paths[name] = str(path)
    with ThreadPoolExecutor(len(paths)) as pool:
        libs = dict(zip(paths, pool.map(
            lambda p: load_library(p, mt._SIGNATURES), paths.values())))
    dev = torch.device("cuda", 0)
    built = mt._lib
    try:
        for n in (96, 384):
            lf, lc = build_poisson_multigrid((-3.0, 3.0), n,
                                             operator="const", device=dev,
                                             levels=2)[:2]
            g = torch.Generator(device=dev).manual_seed(n)

            def rand(code):
                v = torch.randn(code.shape, generator=g, device=dev)
                return torch.where(code != 0, v, 0.0)

            r, e, ec = rand(lf.code), rand(lf.code), rand(lc.code)
            for name, lib in libs.items():
                mt._lib = lambda lib=lib: lib
                k3 = cuda_ms(lambda: mt.const_residual_restrict_embedded(
                    lf.weights, lf.code, lc.code, r, e, lf.plan, lc.plan),
                    reps=30)
                k4 = cuda_ms(lambda: mt.const_prolong_add_smooth_embedded(
                    lf.weights, lf.code, ec, r, e, lf.plan, lc.plan),
                    reps=30)
                print(f"# {n}->{n // 2} fp32 {name:10s} K3 {k3:.4f} ms  "
                      f"K4 {k4:.4f} ms")
            del lf, lc, r, e, ec
            torch.cuda.empty_cache()
    finally:
        mt._lib = built
    return 0


if __name__ == "__main__":
    sys.exit(main())
