"""Time the forms of B12's run-time-K instance on every matrix of the
block AMG hierarchies on one NVIDIA GPU, and the AMG-preconditioned PCG
iteration with the first and the shipped form.

    python scripts/bcsr_amg_ab.py [--small]

The hierarchies are ``chip_smoke.py``'s: the 982,802-DOF elasticity
system (700 x 700 perturbed mesh, RCM, rigid body modes: 3 x 3 levels and
transfers) and the n = 40 box (206,763 DOFs: 6 x 6), fp32, built on the
card.  Every level matrix (A, Qp, Qr) that B12 does not run unrolled
(``bcsr_band_design``: all but b = 2, 3 with K = 8, 16) is timed in each
form:

  * "first": a thread a row, one slot at a time, tiles of 384 rows: B12's
    first run-time-K design (built with the probe macro
    ``-DTPUFEM_BCSR_LOOP_AHEAD=1``, csrc/spmv_probe.cuh);
  * "loop": a thread a row, groups of slots loaded ahead, tiles of
    ``bcsr_loop_tiling`` rows;
  * "out": b threads a row (``bcsr_spmv_out``), groups loaded ahead;

in turns first, loop, out, out, loop, first, each the median of 20
launches with CUDA events (stream queued ahead), beside the bound (the
bytes it must move at 3.35 TB/s), torch's BSR product and the form
``bcsr_band_design`` picks; every output must equal the plain version's
bit for bit.  Then 10 fixed AMG-PCG iterations on each system with
"first" and the shipped pick (in turns, CUDA events as issued).  Prints
the card's name and power limit first and one JSON object last.
``--small`` runs a 100 x 100 mesh and the n = 12 box (a quick check of the
script).
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _hierarchy(kind, small, dev):
    import torch

    from chip_smoke import _amg_hierarchy_of, _body_force
    from tpufem_torch.mesh.box import box_mesh
    from tpufem_torch.mesh.rectangle import perturbed_rectangle_mesh
    from tpufem_torch.solve.elasticity import solve_elasticity

    if kind == "2d":
        n = 100 if small else 700
        mesh = perturbed_rectangle_mesh(-1.0, 1.0, -1.0, 1.0, n, n,
                                        jitter=0.2, seed=0)
        block_rows = 1024
    else:
        n = 12 if small else 40
        mesh = box_mesh(-1, 1, -1, 1, -1, 1, n, n, n)
        block_rows = 4096
    # the assembled system, through the entry point (one Jacobi iteration)
    sol = solve_elasticity(mesh, body_force=_body_force(mesh.dim),
                           dtype=torch.float32, tol=1e-6, maxiter=1,
                           matvec="pallas", block_rows=block_rows,
                           device=dev)
    return _amg_hierarchy_of(sol, mesh, dev, block_rows)


def main() -> int:
    import torch

    from chip_smoke import _bound, _library_bcsr
    from tpufem_torch.ops._build import load_library
    from tpufem_torch.solve.cg import cg_fixed
    from tpufem_torch.sparse import ell_cuda as ec
    from tpufem_torch.utils.timing import cuda_ms

    small = "--small" in sys.argv
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)

    shipped = (ec._bcsr_lib, ec.bcsr_loop_tiling, ec.bcsr_band_design)
    sigs = {**{e: ec._BCSR_ARGS for e in ec._BCSR_ENTRY.values()},
            **{e: ec._BCSR_ARGS for e in ec._OUT_ENTRY.values()},
            **{e: ec._GATHER_ARGS for e in ec._GATHER_ENTRY.values()}}
    one = load_library("bcsr.cu", sigs,
                       flags=("-DTPUFEM_BCSR_LOOP_AHEAD=1",))

    def forced(form):
        def design(b, k, rows):
            pick = shipped[2](b, k, rows)
            return pick if pick == "unrolled" else form
        return design

    forms = {"first": (lambda: one, lambda rows: 384, forced("loop")),
             "loop": (shipped[0], shipped[1], forced("loop")),
             "out": (shipped[0], shipped[1], forced("out")),
             "shipped": shipped}

    def use(form):
        ec._bcsr_lib, ec.bcsr_loop_tiling, ec.bcsr_band_design = forms[form]

    out = {"shapes": [], "pcg": {}}
    for kind in ("2d", "3d"):
        hier, mv, _, b_cm = _hierarchy(kind, small, dev)
        gen = torch.Generator(device=dev).manual_seed(3)
        for i, lv in enumerate(hier.levels):
            for name in ("A", "Qp", "Qr"):
                M = getattr(lv, name)
                nr, k, b, _ = M.data.shape
                pick = shipped[2](b, k, nr)
                if pick == "unrolled" or not isinstance(M._band, tuple):
                    continue
                plan, d_t, rel = M._band
                x = torch.randn((b, nr), generator=gen, device=dev)
                ref = ec.bcsr_band_matvec_plain(plan, d_t, rel, x)

                def call():
                    return ec.bcsr_matvec_cuda(plan, d_t, rel, x)

                times = {f: [] for f in ("first", "loop", "out")}
                for form in ("first", "loop", "out", "out", "loop",
                             "first"):
                    use(form)
                    y = call()
                    torch.cuda.synchronize()
                    if not torch.equal(y, ref):
                        raise SystemExit(f"{kind} {name}{i} {form}: not bit "
                                         "for bit the plain version")
                    times[form].append(cuda_ms(call, reps=20))
                use("shipped")
                bound, _ = _bound([d_t[..., :nr], rel[:, :nr], x], [ref],
                                  2 * k * b * b * nr, "float32")
                lib = _library_bcsr(M.data, M.cols, x.T.reshape(-1), True)()
                rec = {"hierarchy": kind, "matrix": f"{name}{i}",
                       "rows": nr, "b": b, "k": k, "pick": pick,
                       "tile": shipped[1](nr), "bound_ms": bound,
                       "bsr_ms": cuda_ms(lib, reps=20),
                       **{f + "_ms": sum(v) / len(v)
                          for f, v in times.items()}}
                out["shapes"].append(rec)
                print(f"# {kind} {name}{i} {nr} rows b={b} K={k}: "
                      + ", ".join(f"{f} {rec[f + '_ms']:.4f}"
                                  for f in times)
                      + f" ms (pick {pick}, loop tile {rec['tile']}), bound "
                      f"{bound:.4f} ms, BSR {rec['bsr_ms']:.4f} ms",
                      flush=True)
        nb = b_cm.shape[0]

        def M_amg(r_cm):
            return hier.apply(r_cm.T.reshape(-1)).reshape(-1, nb).T

        for form in ("first", "shipped", "shipped", "first"):
            use(form)
            ms = cuda_ms(lambda: cg_fixed(mv, b_cm, 10, M=M_amg), reps=3,
                         queue_ahead=False) / 10
            out["pcg"].setdefault(f"{kind} {form}", []).append(ms)
            print(f"# {kind} AMG-PCG {form}: {ms:.4f} ms/iteration as "
                  "issued", flush=True)
        use("shipped")
        del hier, mv, b_cm
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
