"""Where the time of the banded SpMV kernels B12 (``bcsr_matvec_cuda``) and
B10 (``ell_matvec_multi_cuda``, with B9 at q = 1 beside it) goes, on one
NVIDIA GPU: each timed on the paths' shapes with three column patterns
of the same band and, in a checkout whose ``BCSR_TILE_ROWS`` /
``ell_multi_designs`` exist, with every design their choosers pick from
and with the slots loaded ahead of their use set at build time.

    python scripts/spmv_ablation.py [checkout]

The column patterns (half bandwidth as in ``chip_smoke.py``):

  * ``random``: ``chip_smoke.py``'s, each slot's column drawn at random
    within the band: a warp's gather for one slot touches about one cache
    line per row;
  * ``shifted``: slot k of row i reads column i + o_k (offsets spread over
    the band): the same band and bytes, but a warp's gather is one or two
    lines;
  * ``diagonal``: every slot reads column i.

B10 is also timed in its absolute-column form on the random pattern's
matrix (row-major data and int32 columns, never staged; its groups are
16 bytes of a row whatever ``ahead``), in each block size.

The difference between ``random`` and ``shifted`` is what the scattered
gathers cost the kernel; ``shifted`` against the bound is what the
streamed values and indices cost.  The designs: B12's block rows a
block (``BCSR_TILE_ROWS``), B10's (threads a block; X rows staged in
shared memory, 0: none), each built with N = 1, 2, 4, 8 slots loaded ahead
(``ahead=N``: ``-DTPUFEM_BCSR_AHEAD`` / ``-DTPUFEM_ELL_AHEAD``, the
probes of ``csrc/spmv_probe.cuh``, whose defaults are 4 in fp32 and 2 in
fp64 for B12, 2 for B10), B12's with and without (``unordered``:
``-DTPUFEM_BCSR_ORDER=0``) the compiler fence that keeps the loads issued
ahead of their uses.  Each time is the median of 50 launches with
CUDA events (the stream queued ahead); every output is checked bit for
bit against the kernel's plain version first.  Prints the card's name
and power limit, then one line per case.
"""
from __future__ import annotations

import contextlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HBM = 3.35e12

# (label, rows, slots, half bandwidth, b, block rows): chip_smoke.py's
BCSR = (("B12 2D", 491_401, 8, 701, 2, 1024),
        ("B12 3D", 68_921, 16, 1723, 3, 4096))
ELL = ("B10", 1_002_001, 8, 1001, 8192)
PATTERNS = ("random", "shifted", "diagonal")
AHEAD = (1, 2, 4, 8)


def _cols(torch, gen, n, k, band, pattern, dev):
    rows = torch.arange(n, device=dev)[:, None]
    if pattern == "random":
        off = torch.randint(-band, band + 1, (n, k), generator=gen,
                            device=dev)
    elif pattern == "shifted":
        off = torch.linspace(-band, band, k, device=dev).round().long()[None]
    else:
        off = torch.zeros((1, k), dtype=torch.long, device=dev)
    return (rows + off).clamp_(0, n - 1).to(torch.int32)


def main() -> int:
    root = Path(sys.argv[1] if len(sys.argv) > 1 else
                Path(__file__).resolve().parent.parent).resolve()
    sys.path.insert(0, str(root))
    import torch

    from tpufem_torch.ops._build import load_library
    from tpufem_torch.sparse import ell_cuda as ec
    from tpufem_torch.utils.timing import cuda_ms

    if not torch.cuda.is_available():
        print("spmv_ablation: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"# checkout {root}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(12)
    redesigned = hasattr(ec, "BCSR_TILE_ROWS")

    # the libraries: as the wrappers build them, and the ahead variants
    builds = {"bcsr": ec._bcsr_lib, "ell": ec._lib}
    if redesigned:
        bsig = {**{e: ec._BCSR_ARGS for e in ec._BCSR_ENTRY.values()},
                **{e: ec._GATHER_ARGS for e in ec._GATHER_ENTRY.values()}}
        esig = ec.ell_signatures()
        for a in AHEAD:
            builds[f"ell ahead={a}"] = (
                lambda a=a: load_library("ell.cu", esig, flags=(
                    f"-DTPUFEM_ELL_AHEAD={a}",)))
            for order in (1, 0):
                tag = f"ahead={a}" + ("" if order else " unordered")
                builds[f"bcsr {tag}"] = (
                    lambda a=a, o=order: load_library("bcsr.cu", bsig, flags=(
                        f"-DTPUFEM_BCSR_AHEAD={a}",
                        f"-DTPUFEM_BCSR_ORDER={o}")))
    with ThreadPoolExecutor(len(builds)) as pool:
        libs = dict(zip(builds, pool.map(lambda f: f(), builds.values())))

    @contextlib.contextmanager
    def forced(chooser, design, lib_name, lib):
        saved = {}
        if design is not None:
            saved[chooser] = getattr(ec, chooser)
            setattr(ec, chooser, lambda *a, **kw: design)
        if lib is not None:
            saved[lib_name] = getattr(ec, lib_name)
            setattr(ec, lib_name, lambda: lib)
        try:
            yield
        finally:
            for name, fn in saved.items():
                setattr(ec, name, fn)

    def timed(label, fn, plain, nbytes, variants, chooser, lib_name):
        ref = plain()
        for name, design, lib in variants:
            with forced(chooser, design, lib_name, lib):
                out = fn()
                torch.cuda.synchronize()
                same = torch.equal(out, ref)
                ms = cuda_ms(fn, reps=50)
            bound = nbytes / HBM * 1e3
            print(f"# {label} {name}: {ms:.4f} ms, bound {bound:.4f} ms "
                  f"({bound / ms:.0%}), bit for bit the plain version's: "
                  f"{same}")
            if not same:
                raise SystemExit(f"{label} {name}: output differs")

    def variants(kind, designs, pattern):
        out = [("picked", None, None)]
        if not redesigned or pattern != "random":
            return out
        orders = ("", " unordered") if kind == "bcsr" else ("",)
        return out + [(f"{tag} design {d}", d, libs[f"{kind} {tag}"])
                      for tag in (f"ahead={a}{u}" for a in AHEAD
                                  for u in orders)
                      for d in designs]

    for label, n, k, band, b, R in BCSR:
        data = torch.randn((n, k, b, b), generator=gen, device=dev)
        x32 = torch.randn((b, n), generator=gen, device=dev)
        designs = {dt: list(ec.BCSR_TILE_ROWS) if redesigned else []
                   for dt in (torch.float32, torch.float64)}
        for pattern in PATTERNS:
            cols = _cols(torch, gen, n, k, band, pattern, dev)
            plan, data_t = ec.bcsr_band_plan(data, cols, block_rows=R,
                                             segment=False)
            rel = torch.as_tensor(plan.rel, device=dev)
            for dtype in (torch.float32, torch.float64):
                if pattern != "random" and dtype == torch.float64:
                    continue
                d_t = torch.as_tensor(data_t, device=dev).to(dtype)
                x = x32.to(dtype)
                nbytes = (d_t[..., :n].numel() * d_t.element_size()
                          + rel[:, :n].numel() * rel.element_size()
                          + 2 * x.numel() * x.element_size())
                timed(f"{label} {str(dtype)[6:]} {pattern}",
                      lambda: ec.bcsr_matvec_cuda(plan, d_t, rel, x),
                      lambda: ec.bcsr_band_matvec_plain(plan, d_t, rel, x),
                      nbytes, variants("bcsr", designs[dtype], pattern),
                      "bcsr_band_tiling", "_bcsr_lib")
                del d_t
            del cols, plan, data_t, rel
        del data, x32
        torch.cuda.empty_cache()

    label, n, k, band, R = ELL
    designs = {q: ec.ell_multi_designs(4, q) if redesigned else []
               for q in (3, 8)}
    data = torch.randn((n, k), generator=gen, device=dev)
    for pattern in PATTERNS:
        cols = _cols(torch, gen, n, k, band, pattern, dev)
        plan = ec.ell_band_plan(data, cols, block_rows=R, segment=False)
        d_t = torch.as_tensor(plan.data_t, device=dev)
        rel = torch.as_tensor(plan.rel, device=dev)
        for q in (1, 3, 8):
            X = torch.randn((n, q), generator=gen, device=dev)
            nbytes = (n * k * (d_t.element_size() + rel.element_size())
                      + 2 * X.numel() * X.element_size())
            if q == 1:
                x = X[:, 0].contiguous()
                lay = ec.ell_band_prepare(plan, d_t, rel)
                timed(f"B9 fp32 {pattern}",
                      lambda: ec.ell_matvec_cuda(plan, d_t, rel, x,
                                                 layout=lay),
                      lambda: ec.ell_band_matvec_plain(plan, d_t, rel, x),
                      nbytes, [("picked", None, None)], "", "")
                continue
            timed(f"{label} q={q} fp32 {pattern}",
                  lambda: ec.ell_matvec_multi_cuda(plan, d_t, rel, X),
                  lambda: ec.ell_band_matvec_multi_plain(plan, d_t, rel, X),
                  nbytes, variants("ell", designs[q], pattern),
                  "ell_multi_tiling", "_lib")
            if q == 3 and pattern == "random":
                # the absolute-column form on the same matrix (never staged)
                timed(f"{label} q=3 fp32 absolute columns",
                      lambda: ec.ell_gather_matvec_multi_cuda(data, cols, X),
                      lambda: ec.ell_gather_matvec_multi_plain(data, cols, X),
                      n * k * 8 + 2 * X.numel() * 4,
                      [("picked", None, None)] + [
                          (f"design {(t, 0)}", (t, 0), None)
                          for t in ec.ELL_MULTI_THREADS] if redesigned
                      else [("picked", None, None)],
                      "ell_multi_tiling", "_lib")
        del cols, plan, d_t, rel
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
