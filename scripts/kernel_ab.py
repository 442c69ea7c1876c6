"""Time kernels B12g (the BCSR gather-form SpMV), B15 (SAXPY) and the
multigrid transfers K3 (residual + restrict) and K4 (prolong + add +
smooth) of tpufem_torch from two checkouts of this repository on one
NVIDIA GPU, in turns A, B, B, A.

    python scripts/kernel_ab.py <checkout A> <checkout B>
    python scripts/kernel_ab.py --tiles <checkout>

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
    L2), each beside its bound (the bytes it must move at 3.35 TB/s).

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
marked.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

_COMMON = r"""
import hashlib, json, sys
import torch
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
    data, cols, x = gather_case(nr, k, b, dtype, banded)
    fn = lambda: bcsr_gather_matvec_cuda(data, cols, x)
    name = (f"B12g {label} {str(dtype)[6:]}"
            + (" banded" if banded else ""))
    out[name] = {"ms": cuda_ms(fn, reps=50), "sha256": digest(fn())}
    del data, cols, x
for n in (524288, 1 << 26):
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
for n, dtype in TRANSFERS:
    case = transfer_case(n, dtype)
    for kind, (fn, nbytes) in transfer_calls(*case).items():
        sha, dot = transfer_out(fn())
        out[f"{kind} {n}->{n // 2} {str(dtype)[6:]}"] = {
            "ms": cuda_ms(fn, reps=50), "sha256": sha, "dot": dot,
            "bound_ms": nbytes / 3.35e12 * 1e3}
    del case
    torch.cuda.empty_cache()
print(json.dumps(out))
"""

_TILES = _COMMON + r"""
from tpufem_torch.sparse import ell_cuda

picked = ell_cuda.bcsr_gather_tiling
for (label, nr, k, b), dtype in [(s, d) for s in SHAPES
                                 for d in (torch.float32, torch.float64)]:
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
for n, dtype in TRANSFERS:
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
"""


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    if sys.argv[1] == "--tiles":
        return subprocess.run([sys.executable, "-c", _TILES],
                              cwd=Path(sys.argv[2]).resolve(),
                              timeout=600).returncode
    dirs = {"A": Path(sys.argv[1]).resolve(), "B": Path(sys.argv[2]).resolve()}
    runs = {"A": [], "B": []}
    for key in ("A", "B", "B", "A"):
        proc = subprocess.run([sys.executable, "-c", _TURN], cwd=dirs[key],
                              capture_output=True, text=True, timeout=600)
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
