"""Time kernels B12g (the BCSR gather-form SpMV), B15 (SAXPY), the
multigrid transfers K3 (residual + restrict) and K4 (prolong + add +
smooth), the const stencil B5 and its blocked route B5b, the banded BCSR
SpMV B12 and the ELL SpMV on q right-hand sides B10 of tpufem_torch from
two checkouts of this repository on one NVIDIA GPU, in turns A, B, B, A.

    python scripts/kernel_ab.py <checkout A> <checkout B> [case prefix ...]
    python scripts/kernel_ab.py --tiles <checkout> [case prefix ...]

Given case prefixes (e.g. ``B12 B10``), only the cases whose names start
with one of them run.

Each turn is a fresh process that imports ``tpufem_torch`` from its
checkout, builds csrc/bcsr.cu and csrc/saxpy.cu from that checkout's
sources, and times, as the median of 50 launches with CUDA events (the
stream queued ahead):

  * B12g, ``bcsr_gather_matvec_cuda``, on the elasticity paths' shapes with
    random numbering (columns anywhere), fp32 and fp64: 2D, 491,401 block
    rows, b = 2, K = 8; 3D, 68,921 block rows, b = 3, K = 16; and both in
    fp32 with banded numbering (columns within 300 rows), whose x gathers
    hit L2 lines the neighbouring rows share: the difference is what the
    random gathers cost;
  * B15, ``saxpy``, fp32, at examples/saxpy_pallas.py's n = 524,288 and at
    n = 2^26 (805.3 MB moved), beside ``torch.add(y, x, alpha=a)``;
  * K3 and K4 (without and with the dot) on the finest level pair of the
    const hierarchy: 96 -> 48 in fp32 and fp64 (the main path's) and
    384 -> 192 in fp32 (the scale path's, 315 MB a fine vector, beyond
    L2), each beside its bound (the bytes it must move at 3.35 TB/s);
  * B5, ``const_stencil_apply``, on the paths' const levels: 3D level 96
    in fp32 and fp64 with all four epilogues (matvec, residual, smooth,
    smooth + dot), 3D level 192 (the scale path's) fp32 smooth, 2D level
    1024 fp32 smooth and matvec; and B5b, ``const_stencil_blocked_apply``,
    at n=384 (the scale path's finest level, 315 MB a vector) in fp32 and
    with a bf16 code plane, all four epilogues; each beside its bound;
  * B12, ``bcsr_matvec_cuda``, on ``chip_smoke.py``'s banded shapes (block
    columns drawn at random within the band): 2D, 491,401 block rows, b =
    2, K = 8, R = 1024, and 3D, 68,921 block rows, b = 3, K = 16, R =
    4096, int16 windows, fp32 and fp64, each beside its bound;
  * B10, ``ell_matvec_multi_cuda``, on ``chip_smoke.py``'s banded ELL
    matrix (1,002,001 rows, K = 8, half bandwidth 1001, R = 8192) at q = 3
    and 8 in fp32, and ``ell_gather_matvec_multi_cuda`` (the absolute-column
    form) at q = 3, each beside its bound.

The inputs come from seeded generators on the card, the same in both
checkouts, and each output is hashed, so the checkouts' outputs are held
to each other bit for bit.  Prints the card's name and power limit, one
line per case and turn and, last, one JSON object with each case's mean
over its two turns per checkout, the ratio B / A and whether all four
outputs agree.

``--tiles`` times B12g in one checkout (one whose ``bcsr_gather_tiling``
returns (tile rows, shared memory)) at the same shapes and random
numbering for every tile of 128 down to 4 rows that fits, and K3 and K4
(one whose ``transfer_tiling`` returns (rows, planes, shared memory,
grid) and whose ``TILE_ROWS`` lists the rows it has kernels for) at the
three transfer shapes for every such tile, each tile the wrapper picks
marked; and B5 / B5b (one whose ``const_tiling`` returns (rows, planes,
shared memory, grid) and whose ``CONST_TILE_ROWS`` lists the rows it has
kernels for) at 3D level 96 (fp32, fp64), 3D level 192, 2D level 1024 (2D
planes are bands of rows) and n=384, the sweep, for every such tile; and
B12 (one whose ``BCSR_TILE_ROWS`` lists its tiles) at its four shapes
and types for every tile, and B10 (one whose ``ell_multi_designs``
lists its (threads, window)) at q = 3 and 8 and in the absolute-column
form for every design.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

_COMMON = r"""
import hashlib, json, sys
import torch
SELECT = sys.argv[1:]
sys.path.insert(0, ".")
from tpufem_torch.ops.saxpy_cuda import saxpy
from tpufem_torch.sparse.ell_cuda import bcsr_gather_matvec_cuda
from tpufem_torch.utils.timing import cuda_ms

dev = torch.device("cuda", 0)


def digest(t):
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def gather_case(nr, k, b, dtype, banded=False):
    g = torch.Generator(device=dev).manual_seed(nr + k)
    data = torch.randn((nr, k, b, b), generator=g, device=dev).to(dtype)
    cols = torch.randint(0, nr, (nr, k), generator=g, device=dev)
    if banded:
        cols = (torch.arange(nr, device=dev)[:, None] + cols % 601
                - 300).clamp_(0, nr - 1)
    x = torch.randn(nr * b, generator=g, device=dev).to(dtype)
    return data, cols.to(torch.int32), x


SHAPES = (("2D", 491401, 8, 2), ("3D", 68921, 16, 3))
TRANSFERS = ((96, torch.float32), (96, torch.float64), (384, torch.float32))


def transfer_case(n, dtype):
    # the const hierarchy's level pair n -> n/2 and random r, e and ec
    # (zero on padding rows), from a seeded generator on the card
    from tpufem_torch.solve.multigrid import build_poisson_multigrid

    lf, lc = build_poisson_multigrid((-3.0, 3.0), n, operator="const",
                                     dtype=dtype, device=dev, levels=2)[:2]
    g = torch.Generator(device=dev).manual_seed(n)

    def rand(code):
        v = torch.randn(code.shape, generator=g, device=dev, dtype=dtype)
        return torch.where(code != 0, v, 0.0)

    return lf, lc, rand(lf.code), rand(lf.code), rand(lc.code)


def transfer_calls(lf, lc, r, e, ec):
    # {case: (call, bytes it must move)} of K3 and K4 (no dot, dot) on one
    # level pair
    from tpufem_torch.ops import mg_transfer_cuda as mt

    fine, coarse = r.numel() * r.element_size(), ec.numel() * r.element_size()
    a4 = (lf.weights, lf.code, ec, r, e, lf.plan, lc.plan)
    return {
        "K3": (lambda: mt.const_residual_restrict_embedded(
            lf.weights, lf.code, lc.code, r, e, lf.plan, lc.plan),
            3 * fine + 2 * coarse),
        "K4": (lambda: mt.const_prolong_add_smooth_embedded(*a4),
               4 * fine + coarse),
        "K4 +dot": (lambda: mt.const_prolong_add_smooth_embedded(
            *a4, with_dot=True), 4 * fine + coarse)}


CONSTS = (("B5 3D 96", 3, 96, torch.float32, None),
          ("B5 3D 96", 3, 96, torch.float64, None),
          ("B5 3D 192", 3, 192, torch.float32, ("smooth",)),
          ("B5 2D 1024", 2, 1024, torch.float32, ("smooth", "matvec")),
          ("B5b 384", 3, 384, torch.float32, None),
          ("B5b 384", 3, 384, torch.bfloat16, None))
EPILOGUES = {"matvec": ("matvec", False), "residual": ("residual", False),
             "smooth": ("smooth", False), "smooth+dot": ("smooth", True)}


def const_case(dim, n, code_dtype):
    # the finest const level of n and random x, b (zero on padding rows)
    # from a seeded generator on the card; fp32 vectors under a bf16 code
    from tpufem_torch.solve.multigrid import build_poisson_multigrid

    vec = torch.float32 if code_dtype == torch.bfloat16 else code_dtype
    lv = build_poisson_multigrid((-3.0, 3.0), n, dim, operator="const",
                                 dtype=vec, device=dev, levels=1)[0]
    g = torch.Generator(device=dev).manual_seed(n + dim)

    def rand():
        v = torch.randn(lv.code.shape, generator=g, device=dev, dtype=vec)
        return torch.where(lv.code != 0, v, 0.0)

    return lv, lv.code.to(code_dtype), rand(), rand()


def const_calls(label, lv, code, x, b, which):
    # {case: (call, bytes it must move)} of B5 (or B5b's route) on a level
    from tpufem_torch.ops import stencil_cuda as sc

    blocked = label.startswith("B5b")
    rows = x.numel()
    out = {}
    for name in which or EPILOGUES:
        ep, wd = EPILOGUES[name]
        kw = dict(b=None if ep == "matvec" else b, with_dot=wd)
        args = (ep, lv.weights, code, x, lv.plan.offsets)
        fn = ((lambda args=args, kw=kw: sc.const_stencil_blocked_apply(
            *args, lv.plan.store_grid, **kw)) if blocked else
              (lambda args=args, kw=kw: sc.const_stencil_apply(*args, **kw)))
        nbytes = rows * (code.element_size()
                         + x.element_size() * (2 + (ep != "matvec")))
        out[name] = (fn, nbytes)
    return out


BANDS = (("B12 2D", 491_401, 8, 701, 2, 1024),
         ("B12 3D", 68_921, 16, 1723, 3, 4096))
ELL_BAND = (1_002_001, 8, 1001, 8192)


def wanted(name):
    # a case, or a group of cases by the start of their names, that one of
    # the selected prefixes reaches
    return not SELECT or any(name.startswith(p) or p.startswith(name)
                             for p in SELECT)


def band_case(n, k, band, b, R):
    # chip_smoke.py's banded BCSR case from a seeded generator on the card:
    # the plan on the host, data_t / rel on the card, x [b, n] fp32
    from tpufem_torch.sparse import ell_cuda as ec

    g = torch.Generator(device=dev).manual_seed(n + k + b)
    cols = (torch.arange(n, device=dev)[:, None] + torch.randint(
        -band, band + 1, (n, k), generator=g, device=dev)).clamp_(
        0, n - 1).to(torch.int32)
    data = torch.randn((n, k, b, b), generator=g, device=dev)
    x = torch.randn((b, n), generator=g, device=dev)
    plan, data_t = ec.bcsr_band_plan(data, cols, block_rows=R,
                                     segment=False)
    return plan, torch.as_tensor(data_t, device=dev), torch.as_tensor(
        plan.rel, device=dev), x


def band_bytes(plan, d_t, rel, x):
    n = plan.n
    return (d_t[..., :n].numel() * d_t.element_size()
            + rel[:, :n].numel() * rel.element_size()
            + 2 * x.numel() * x.element_size())


def ell_case():
    # chip_smoke.py's banded ELL matrix from a seeded generator on the card
    from tpufem_torch.sparse import ell_cuda as ec

    n, k, band, R = ELL_BAND
    g = torch.Generator(device=dev).manual_seed(n)
    cols = (torch.arange(n, device=dev)[:, None] + torch.randint(
        -band, band + 1, (n, k), generator=g, device=dev)).clamp_(
        0, n - 1).to(torch.int32)
    data = torch.randn((n, k), generator=g, device=dev)
    plan = ec.ell_band_plan(data, cols, block_rows=R, segment=False)
    return (plan, torch.as_tensor(plan.data_t, device=dev),
            torch.as_tensor(plan.rel, device=dev), data, cols, g)


def ell_calls(plan, d_t, rel, data, cols, g):
    # {case: (call, bytes it must move)} of B10
    from tpufem_torch.sparse import ell_cuda as ec

    n, k = data.shape
    out = {}
    for q in (3, 8):
        X = torch.randn((n, q), generator=g, device=dev)
        nbytes = n * k * (4 + rel.element_size()) + 2 * X.numel() * 4
        out[f"B10 q={q} fp32"] = (
            lambda X=X: ec.ell_matvec_multi_cuda(plan, d_t, rel, X), nbytes)
        if q == 3:
            out["B10 q=3 fp32 absolute columns"] = (
                lambda X=X: ec.ell_gather_matvec_multi_cuda(data, cols, X),
                n * k * 8 + 2 * X.numel() * 4)
    return out


def transfer_out(res):
    # (sha256 of the field, the dot or None)
    if isinstance(res, tuple):
        return digest(res[0]), res[1].item()
    return digest(res), None
"""


_TURN = _COMMON + r"""
out = {}
for (label, nr, k, b), dtype, banded in (
        [(s, d, False) for s in SHAPES
         for d in (torch.float32, torch.float64)]
        + [(s, torch.float32, True) for s in SHAPES]):
    if not wanted("B12g"):
        break
    data, cols, x = gather_case(nr, k, b, dtype, banded)
    fn = lambda: bcsr_gather_matvec_cuda(data, cols, x)
    name = (f"B12g {label} {str(dtype)[6:]}"
            + (" banded" if banded else ""))
    out[name] = {"ms": cuda_ms(fn, reps=50), "sha256": digest(fn())}
    del data, cols, x
for n in (524288, 1 << 26) if wanted("B15") else ():
    g = torch.Generator(device=dev).manual_seed(n)
    a = torch.tensor([5.1], device=dev)
    x = torch.rand(n, generator=g, device=dev)
    y = torch.rand(n, generator=g, device=dev)
    alpha = a.item()
    fn = lambda: saxpy(a, x, y)
    out[f"B15 n={n}"] = {
        "ms": cuda_ms(fn, reps=50), "sha256": digest(fn()),
        "torch_add_ms": cuda_ms(lambda: torch.add(y, x, alpha=alpha),
                                reps=50)}
    del x, y
for n, dtype in TRANSFERS if wanted("K") else ():
    case = transfer_case(n, dtype)
    for kind, (fn, nbytes) in transfer_calls(*case).items():
        sha, dot = transfer_out(fn())
        out[f"{kind} {n}->{n // 2} {str(dtype)[6:]}"] = {
            "ms": cuda_ms(fn, reps=50), "sha256": sha, "dot": dot,
            "bound_ms": nbytes / 3.35e12 * 1e3}
    del case
    torch.cuda.empty_cache()
for label, dim, n, cdt, which in CONSTS:
    if not wanted(label):
        continue
    lv, code, x, b = const_case(dim, n, cdt)
    for name, (fn, nbytes) in const_calls(label, lv, code, x, b,
                                          which).items():
        sha, dot = transfer_out(fn())
        out[f"{label} {str(cdt)[6:]} {name}"] = {
            "ms": cuda_ms(fn, reps=50), "sha256": sha, "dot": dot,
            "bound_ms": nbytes / 3.35e12 * 1e3}
    del lv, code, x, b
    torch.cuda.empty_cache()
from tpufem_torch.sparse import ell_cuda as ec
for label, n, k, band, b, R in BANDS if wanted("B12 ") else ():
    plan, d_t32, rel, x32 = band_case(n, k, band, b, R)
    for dtype in (torch.float32, torch.float64):
        d_t, x = d_t32.to(dtype), x32.to(dtype)
        fn = lambda: ec.bcsr_matvec_cuda(plan, d_t, rel, x)
        out[f"{label} {str(dtype)[6:]}"] = {
            "ms": cuda_ms(fn, reps=50), "sha256": digest(fn()),
            "bound_ms": band_bytes(plan, d_t, rel, x) / 3.35e12 * 1e3}
        del d_t, x
    del plan, d_t32, rel, x32
    torch.cuda.empty_cache()
if wanted("B10"):
    case = ell_case()
    for name, (fn, nbytes) in ell_calls(*case).items():
        out[name] = {"ms": cuda_ms(fn, reps=50), "sha256": digest(fn()),
                     "bound_ms": nbytes / 3.35e12 * 1e3}
    del case
print(json.dumps({k: v for k, v in out.items() if wanted(k)}))
"""

_TILES = _COMMON + r"""
from tpufem_torch.sparse import ell_cuda

picked = ell_cuda.bcsr_gather_tiling
for (label, nr, k, b), dtype in [(s, d) for s in SHAPES
                                 for d in (torch.float32, torch.float64)]:
    if not wanted("B12g"):
        break
    data, cols, x = gather_case(nr, k, b, dtype)
    itemsize = data.element_size()
    rows0 = picked(itemsize, b, k)[0]
    ref = bcsr_gather_matvec_cuda(data, cols, x)
    for rows in (128, 64, 32, 16, 8, 4):
        if rows * b > 384:
            continue
        ell_cuda.bcsr_gather_tiling = lambda *a, rows=rows: (rows, None)
        try:
            fn = lambda: bcsr_gather_matvec_cuda(data, cols, x)
            same = torch.equal(fn(), ref)
            ms = cuda_ms(fn, reps=50)
        except RuntimeError:               # the ring does not fit
            continue
        finally:
            ell_cuda.bcsr_gather_tiling = picked
        print(f"# B12g {label} {str(dtype)[6:]} random, tile {rows} rows: "
              f"{ms:.4f} ms, equal to the picked tile's output {same}"
              + (" (picked)" if rows == rows0 else ""))
    del data, cols, x

from tpufem_torch.ops import mg_transfer_cuda as mt

chosen = mt.transfer_tiling
TILES = {k: [(ty, tz) for ty in mt.TILE_ROWS[k]
             for tz in ((4, 8, 16, 32) if k == "K4" else (2, 4, 8, 16))]
         for k in ("K4", "K3")}
for n, dtype in TRANSFERS if wanted("K") else ():
    case = transfer_case(n, dtype)
    lf, lc, r = case[0], case[1], case[2]
    calls = transfer_calls(*case)
    for kind in ("K4", "K3"):
        fn, nbytes = calls[kind]
        ref = fn()
        pick = chosen(kind, r.element_size(), tuple(lf.plan.store_grid),
                      tuple(lc.plan.store_grid),
                      tuple(lc.plan.info.node_grid))[:2]
        sg = lf.plan.store_grid if kind == "K4" else lc.plan.store_grid
        cols = 128 if kind == "K4" else 64
        for ty, tz in TILES[kind]:
            smem = mt.transfer_smem(kind, r.element_size(), ty)
            if smem > 232448:
                continue
            mt.transfer_tiling = lambda k, *a, ty=ty, tz=tz, smem=smem: (
                (ty, tz, smem, (sg[2] // cols, -(-sg[1] // ty),
                                -(-sg[0] // tz)))
                if k == kind else chosen(k, *a))
            try:
                same = torch.equal(fn(), ref)
                ms = cuda_ms(fn, reps=50)
            finally:
                mt.transfer_tiling = chosen
            print(f"# {kind} {n}->{n // 2} {str(dtype)[6:]}, tile {ty} rows "
                  f"x {tz} planes ({smem} B): {ms:.4f} ms "
                  f"(bound {nbytes / 3.35e12 * 1e3:.4f} ms), equal to the "
                  f"picked tile's output {same}"
                  + (" (picked)" if (ty, tz) == pick else ""))
    del case, calls, ref
    torch.cuda.empty_cache()

from tpufem_torch.ops import stencil_cuda as sc

picked_const = sc.const_tiling
for label, dim, n, cdt, _ in CONSTS[:-1]:
    if not wanted(label):
        continue
    lv, code, x, b = const_case(dim, n, cdt)
    fn, nbytes = const_calls(label, lv, code, x, b, ("smooth",))["smooth"]
    ref = fn()
    k, sg = len(lv.plan.offsets), tuple(lv.plan.store_grid)
    pick = picked_const(k, x.element_size(), sg, code.element_size())[:2]
    for ty in sc.CONST_TILE_ROWS:
        smem = sc.const_smem(k, x.element_size(), ty, code.element_size())
        for tz in sorted({1, 2, 3, 4, 6, 8, 12, 16, 24, 32, pick[1]}):
            grid = sc._const_grid(k, sg, ty, tz)
            sc.const_tiling = lambda *a, t=(ty, tz, smem, grid): t
            try:
                same = torch.equal(fn(), ref)
                ms = cuda_ms(fn, reps=50)
            finally:
                sc.const_tiling = picked_const
            blocks = grid[0] * grid[1] * grid[2]
            print(f"# {label} {str(cdt)[6:]} smooth, tile {ty} rows x {tz} "
                  f"planes ({smem} B, {blocks} blocks): {ms:.4f} ms (bound "
                  f"{nbytes / 3.35e12 * 1e3:.4f} ms), equal to the picked "
                  f"tile's output {same}"
                  + (" (picked)" if (ty, tz) == pick else ""))
    del lv, code, x, b, ref
    torch.cuda.empty_cache()

picked_band = ell_cuda.bcsr_band_tiling
for label, n, k, band, b, R in BANDS if wanted("B12 ") else ():
    plan, d_t32, rel, x32 = band_case(n, k, band, b, R)
    for dtype in (torch.float32, torch.float64):
        d_t, x = d_t32.to(dtype), x32.to(dtype)
        fn = lambda: ell_cuda.bcsr_matvec_cuda(plan, d_t, rel, x)
        ref = fn()
        pick = picked_band()
        bound = band_bytes(plan, d_t, rel, x) / 3.35e12 * 1e3
        for rows in ell_cuda.BCSR_TILE_ROWS:
            ell_cuda.bcsr_band_tiling = lambda *a, r=rows: r
            try:
                same = torch.equal(fn(), ref)
                ms = cuda_ms(fn, reps=50)
            finally:
                ell_cuda.bcsr_band_tiling = picked_band
            print(f"# {label} {str(dtype)[6:]}, {rows} block rows a block "
                  f"({-(-n // rows)} blocks): {ms:.4f} ms (bound "
                  f"{bound:.4f} ms), equal to the picked tile's output "
                  f"{same}" + (" (picked)" if rows == pick else ""))
        del d_t, x, ref
    del plan, d_t32, rel, x32
    torch.cuda.empty_cache()

picked_multi = ell_cuda.ell_multi_tiling
if wanted("B10"):
    case = ell_case()
    for name, (fn, nbytes) in ell_calls(*case).items():
        ref = fn()
        q = ref.shape[1]
        for design in ell_cuda.ell_multi_designs(4, q):
            if "absolute" in name and design[1]:
                continue                    # the absolute form never stages
            ell_cuda.ell_multi_tiling = lambda *a, d=design: d
            try:
                same = torch.equal(fn(), ref)
                ms = cuda_ms(fn, reps=50)
            finally:
                ell_cuda.ell_multi_tiling = picked_multi
            print(f"# {name}, {design[0]} threads a block, window "
                  f"{design[1]}: {ms:.4f} ms (bound "
                  f"{nbytes / 3.35e12 * 1e3:.4f} ms), equal to the picked "
                  f"design's output {same}"
                  + (" (picked)" if tuple(design) == tuple(picked_multi(4, q))
                     else ""))
    del case
"""


def main() -> int:
    if len(sys.argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    select = sys.argv[3:]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    if sys.argv[1] == "--tiles":
        return subprocess.run([sys.executable, "-c", _TILES, *select],
                              cwd=Path(sys.argv[2]).resolve(),
                              timeout=900).returncode
    dirs = {"A": Path(sys.argv[1]).resolve(), "B": Path(sys.argv[2]).resolve()}
    runs = {"A": [], "B": []}
    for key in ("A", "B", "B", "A"):
        proc = subprocess.run([sys.executable, "-c", _TURN, *select],
                              cwd=dirs[key], capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return 1
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        for case, r in rec.items():
            extra = (f", torch.add {r['torch_add_ms']:.4f} ms"
                     if "torch_add_ms" in r else "")
            if "bound_ms" in r:
                extra += f", bound {r['bound_ms']:.4f} ms"
            if r.get("dot") is not None:
                extra += f", dot {r['dot']!r}"
            print(f"# {key} ({dirs[key]}): {case} {r['ms']:.4f} ms{extra}, "
                  f"output sha256 {r['sha256']}")
        runs[key].append(rec)
    summary = {}
    for case in runs["A"][0]:
        ms = {k: sum(r[case]["ms"] for r in v) / len(v)
              for k, v in runs.items()}
        summary[case] = {
            "ms_A": ms["A"], "ms_B": ms["B"],
            "ratio_B_over_A": ms["B"] / ms["A"],
            "outputs_equal": len({r[case]["sha256"] for v in runs.values()
                                  for r in v}) == 1}
        if "torch_add_ms" in runs["A"][0][case]:
            summary[case]["torch_add_ms"] = sum(
                r[case]["torch_add_ms"] for v in runs.values()
                for r in v) / 4
        if "bound_ms" in runs["B"][0][case]:
            summary[case]["bound_ms"] = runs["B"][0][case]["bound_ms"]
        dots = {k: v[0][case].get("dot") for k, v in runs.items()}
        if dots["B"] is not None:
            summary[case].update(
                dot_A=dots["A"], dot_B=dots["B"],
                dot_reproducible=len({r[case]["dot"] for r in runs["B"]})
                == 1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
