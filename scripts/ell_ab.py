"""Time B9 (the banded ELL SpMV) and B9g (its absolute-column form) of
tpufem_torch from two checkouts of this repository on one NVIDIA GPU, in
turns A, B, B, A, at every shape PERF.md's kernel table times them:

    python scripts/ell_ab.py <checkout A> <checkout B> [--data DIR]

First (in this process, with checkout B's package and chip_smoke.py) the
operators are built and saved under DIR (default: a temporary directory,
removed at the end): chip_smoke.py's random banded matrix (1,002,001
rows, K = 8, half bandwidth 1001), the fine operators of the p2 path (P2,
1,002,001 DOFs), of the p2_tet_robin path at n = 50 (1,030,301 DOFs) and
of the quad_hex path (1000^2 quads, 100^3 hexes), and every level
operator (A, Qp, Qr) of the p2 and p2_tet_robin n = 50 AMG hierarchies,
each as its ELL data / cols [n, K] (the slots after a matrix's longest
row saved as what they are, zeros pointing at their own row).  Here each
shape's torch.sparse CSR product of its nonzeros is timed, once.

Then each turn is a fresh process that imports ``tpufem_torch`` from its
checkout (building csrc/ell.cu from that checkout's sources), builds each
operator's banded plan (``ell_band_plan``) and times ``ell_matvec_cuda``
(fp64; the random matrix in fp32 with int16 windows) and, at the random
matrix, the P2-tet and the hex shapes, ``ell_gather_matvec_cuda`` on the
row-major arrays, as the median of 20 launches with CUDA events (the
stream queued ahead), x from a seeded generator.  Each output is hashed:
the two checkouts' outputs must agree bit for bit.

Prints the card's name and power limit, one line per shape and turn, and
last one JSON object with each shape's rows, width, nonzeros, the bound
on the bytes its nonzeros need (value and index of each, x and y once,
at 3.35 TB/s), CSR's time, each checkout's mean over its two turns, B / A
and whether all four outputs agree.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

HBM = 3.35e12

_TURN = r"""
import hashlib, json, sys
from pathlib import Path
import numpy as np
import torch
sys.path.insert(0, ".")
from tpufem_torch.sparse import ell_cuda as ec
from tpufem_torch.utils.timing import cuda_ms

dev = torch.device("cuda", 0)
data_dir = Path(sys.argv[1])
shapes = json.loads((data_dir / "shapes.json").read_text())
out = {}
for s in shapes:
    z = np.load(data_dir / (s["name"] + ".npz"))
    n, K = s["rows"], s["K"]
    live, L = z["live"], z["data"].shape[1]
    data = np.zeros((n, K), z["data"].dtype)
    cols = np.broadcast_to(np.arange(n, dtype=np.int32)[:, None],
                           (n, K)).copy()
    data[live, :L] = z["data"]
    cols[live, :L] = z["cols"]
    del z
    dtype = getattr(torch, s["dtype"])
    g = torch.Generator(device=dev).manual_seed(s["seed"])
    x = torch.randn(n, generator=g, device=dev, dtype=torch.float64).to(dtype)
    if s["form"] == "band":
        plan = ec.ell_band_plan(data, cols)
        d_t = torch.as_tensor(plan.data_t, device=dev).to(dtype)
        rel = torch.as_tensor(plan.rel, device=dev)
        # a checkout whose B9 reads a prepared layout gets it once
        prep = getattr(ec, "ell_band_prepare", None)
        kw = {"layout": prep(plan, d_t, rel)} if prep else {}
        fn = lambda: ec.ell_matvec_cuda(plan, d_t, rel, x, **kw)
        what = getattr(plan, "form", None)
        what = "one thread a row" if what is None else str(what)
        index = rel.element_size()
    else:
        dd = torch.as_tensor(data, device=dev).to(dtype)
        cc = torch.as_tensor(cols, device=dev)
        fn = lambda: ec.ell_gather_matvec_cuda(dd, cc, x)
        what, index = "gather", 4
    y = fn()
    torch.cuda.synchronize()
    ms = cuda_ms(fn, reps=20)
    out[s["name"]] = dict(ms=ms, form=what, index=index, hash=hashlib.sha256(
        y.cpu().numpy().tobytes()).hexdigest()[:16])
    del fn, y
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(out))
"""


def _save(data_dir, shapes, name, data, cols, *, dtype="float64",
          form="band", csr_ms=None):
    """Save an ELL operator's non-empty rows up to its longest row (the
    rest, zeros on their own row, is rebuilt in each turn; where padding
    points elsewhere, every slot) and its shape record."""
    import numpy as np

    data = np.asarray(data)
    cols = np.asarray(cols).astype(np.int32)
    n, K = data.shape
    nz = data != 0
    lens = np.where(nz.any(1), K - np.argmax(nz[:, ::-1], axis=1), 0)
    L = max(1, int(lens.max()))
    live = np.flatnonzero(lens)
    own = np.arange(n)[:, None]
    if not ((cols[:, L:] == own).all()
            and (cols[lens == 0] == own[lens == 0]).all()):
        L, live = K, np.arange(n)
    np.savez(data_dir / (name + ".npz"), live=live, data=data[live, :L],
             cols=cols[live, :L])
    shapes.append(dict(name=name, rows=n, K=K, nnz=int(nz.sum()),
                       dtype=dtype, form=form, seed=len(shapes),
                       csr_ms=csr_ms,
                       item=4 if dtype == "float32" else 8))


def _build(root, data_dir):
    """Build and save every shape (checkout ``root``'s package)."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import chip_smoke as cs
    from tpufem_torch.utils.timing import PhaseTimer, cuda_ms

    dev = torch.device("cuda", 0)
    shapes = []

    def csr(data, cols, dtype):
        d = torch.as_tensor(np.asarray(data), device=dev).to(dtype)
        c = torch.as_tensor(np.asarray(cols), device=dev)
        x = torch.randn(d.shape[0], device=dev, dtype=dtype)
        return cuda_ms(cs._library_ell(d, c, x, nonzeros=True)(), reps=20)

    def add(name, M, **kw):
        data, cols = M.data.cpu().numpy(), M.cols.cpu().numpy()
        _save(data_dir, shapes, name, data, cols,
              csr_ms=csr(data, cols, getattr(torch, kw.get("dtype",
                                                           "float64"))),
              **kw)
        print(f"# saved {name}: {data.shape}", flush=True)
        del data, cols

    # chip_smoke.py's random banded matrix (its _check_ell)
    g = torch.Generator(device=dev).manual_seed(6)
    n, k, band = cs.ELL_ROWS, cs.ELL_SLOTS, cs.ELL_BANDWIDTH
    cols = (torch.arange(n, device=dev)[:, None] + torch.randint(
        -band, band + 1, (n, k), generator=g, device=dev)).clamp_(
        0, n - 1).to(torch.int32)
    data = torch.randn((n, k), generator=g, device=dev)
    M = type("M", (), {"data": data, "cols": cols})
    add("random 1M K=8 fp32 int16", M, dtype="float32")
    add("random 1M K=8 fp32 absolute", M, dtype="float32", form="gather")
    del data, cols

    _, _, _, A_p, _, hier = cs._p2_neumann(cs.N_P2, dev, PhaseTimer(), {})
    add("p2 fine A", A_p)
    for i, lv in enumerate(hier.levels):
        for m in ("A", "Qp", "Qr"):
            if getattr(lv, m) is not None and (i, m) != (0, "A"):
                add(f"p2 level {i} {m}", getattr(lv, m))
    del A_p, hier
    _, _, _, A_p, _, hier = cs._p2_tet_robin(cs.N_P2_TET, dev, PhaseTimer(),
                                             {})
    add("p2_tet fine A", A_p)
    add("p2_tet fine A absolute", A_p, form="gather")
    for i, lv in enumerate(hier.levels):
        for m in ("A", "Qp", "Qr"):
            if getattr(lv, m) is not None and (i, m) != (0, "A"):
                add(f"p2_tet level {i} {m}", getattr(lv, m))
    del A_p, hier
    torch.cuda.empty_cache()
    from tpufem_torch.mesh.box import box_hex_mesh
    from tpufem_torch.mesh.rectangle import perturbed_quad_mesh

    quad = perturbed_quad_mesh(-3, 3, -3, 3, cs.N_QUAD, cs.N_QUAD,
                               jitter=0.25, seed=5)
    add("quad fine A", cs._solve_capturing_amg(quad, dev)[1])
    hexm = box_hex_mesh(-3, 3, -3, 3, -3, 3, cs.N_HEX, cs.N_HEX, cs.N_HEX)
    A_hex = cs._solve_capturing_amg(hexm, dev)[1]
    add("hex fine A", A_hex)
    add("hex fine A absolute", A_hex, form="gather")
    (data_dir / "shapes.json").write_text(json.dumps(shapes))
    return shapes


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("ell_ab: no CUDA device", file=sys.stderr)
        return 2
    args = list(argv)
    if args[:1] == ["--build"]:     # the build step, in checkout B
        _build(Path.cwd(), Path(args[1]))
        return 0
    keep = None
    if "--data" in args:
        i = args.index("--data")
        keep = Path(args[i + 1])
        del args[i:i + 2]
    if len(args) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = (Path(p).resolve() for p in args)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    data_dir = keep or Path(tempfile.mkdtemp(prefix="ell_ab_"))
    data_dir.mkdir(parents=True, exist_ok=True)
    try:
        if not (data_dir / "shapes.json").exists():
            subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--build", str(data_dir)], cwd=b, check=True)
        shapes = json.loads((data_dir / "shapes.json").read_text())
        turns = {}
        for tag, root in (("A", a), ("B", b), ("B", b), ("A", a)):
            run = subprocess.run([sys.executable, "-c", _TURN,
                                  str(data_dir)], cwd=root, check=True,
                                 capture_output=True, text=True)
            res = json.loads(next(line for line in run.stdout.splitlines()
                                  if line.startswith("RESULT "))[7:])
            turns.setdefault(tag, []).append(res)
            for name, r in res.items():
                print(f"# {tag} {root.name}: {name}: {r['ms']:.4f} ms, "
                      f"{r['form']}, hash {r['hash']}", flush=True)
    finally:
        if keep is None:
            shutil.rmtree(data_dir, ignore_errors=True)
    summary = {}
    for s in shapes:
        name = s["name"]
        ms = {t: sum(r[name]["ms"] for r in turns[t]) / 2 for t in "AB"}
        hashes = {r[name]["hash"] for t in "AB" for r in turns[t]}
        index = turns["B"][0][name]["index"]
        needed = s["nnz"] * (s["item"] + index) + 2 * s["rows"] * s["item"]
        summary[name] = dict(
            rows=s["rows"], K=s["K"], nnz=s["nnz"],
            needed_bound_ms=needed / HBM * 1e3, csr_ms=s["csr_ms"],
            A_ms=ms["A"], B_ms=ms["B"], ratio=ms["B"] / ms["A"],
            form_B=turns["B"][0][name]["form"],
            outputs_agree=len(hashes) == 1)
        print(f"# {name}: A {ms['A']:.4f} ms, B {ms['B']:.4f} ms "
              f"({turns['B'][0][name]['form']}), B / A "
              f"{ms['B'] / ms['A']:.3f}, needed bound "
              f"{needed / HBM * 1e3:.4f} ms, CSR {s['csr_ms']:.4f} ms, "
              f"outputs agree {len(hashes) == 1}")
    print(json.dumps(summary))
    return 0 if all(v["outputs_agree"] for v in summary.values()) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
