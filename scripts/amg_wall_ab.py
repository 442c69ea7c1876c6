"""Time the AMG paths' PCG iterations as issued (the wall a caller waits
for, the host's launch overhead included) from two checkouts of this
repository on one NVIDIA GPU, in alternating turns on the same host:

    python scripts/amg_wall_ab.py <checkout A> <checkout B> [--rounds N]
                                  [--extras] [--out DIR]

Two worker processes, one in each checkout, import that checkout's
``tpufem_torch`` and ``chip_smoke.py`` and build, with chip_smoke.py's own
setup, the systems and AMG hierarchies of four paths: unstructured_amg
(the 1,002,001-row P1 system, fp32, greedy strength-0.08 V-cycle), p2
(1,002,001 P2 DOFs, fp64), and quad_hex's quad (1000^2 Q1) and hex (100^3
Q1).  Both build at once; then each turn lets one worker time alone,
turns A B B A repeated ``--rounds`` times (default 2), the other worker
idle.  A turn times, per path, 10 AMG-PCG iterations (``cg_fixed`` with
the hierarchy's V-cycle), the median of 5 runs with CUDA events around
each run on an idle stream (as issued) and with the stream queued ahead
(device time), per iteration.

With ``--extras`` worker B then times, at the paths' fine operators, p2's
level-1 A and chip_smoke.py's random 1,002,001-row K = 8 fp32 matrix, B9
as "rows" and as "sliced" (forced on the plan; ``ell_band_design``'s
pick printed beside), each output held bit for bit to the plain version,
with the device bytes of each layout beside the plan's planes; and the
device bytes of B9's layouts over each path's hierarchy.

Prints the card's name and power limit, one line per turn and path, and
last one JSON object: per path each checkout's mean over its turns of
the as-issued and device ms per iteration, and B / A.  Each worker's log
goes to DIR as amg_wall_<A|B>.log (without ``--out``, to a temporary
directory removed at the end; a failed worker's last lines are printed).
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HBM = 3.35e12
PATHS = ("unstructured_amg", "p2", "quad", "hex")


def _wait(path: Path, procs, timeout: float):
    """Wait for ``path`` to exist; raise if a worker ended first."""
    t0 = time.monotonic()
    while not path.exists():
        for tag, p in procs.items():
            if p.poll() is not None:
                raise RuntimeError(f"worker {tag} ended (rc {p.returncode}) "
                                   f"before {path.name}")
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"no {path.name} after {timeout} s")
        time.sleep(0.05)


# -- the worker (runs in its checkout) -------------------------------------

def _systems(cs, dev):
    """{path: (A_p, b_p, hierarchy)} from chip_smoke.py's own setup."""
    import torch

    from tpufem_torch.mesh.box import box_hex_mesh
    from tpufem_torch.mesh.rectangle import perturbed_quad_mesh
    from tpufem_torch.solve.amg import build_amg
    from tpufem_torch.utils.timing import PhaseTimer

    out = {}
    keep = {}
    cs._drive_unstructured(dev, keep)
    A, b, _, _ = keep.pop("unstructured")
    out["unstructured_amg"] = (A, b, build_amg(
        A, aggregation="greedy", cycle="V", strength=0.08))
    print("# built unstructured_amg", flush=True)
    _, _, _, A_p, b_p, hier = cs._p2_neumann(cs.N_P2, dev, PhaseTimer(), {})
    out["p2"] = (A_p, b_p, hier)
    print("# built p2", flush=True)
    for name, mesh in (
            ("quad", lambda: perturbed_quad_mesh(
                -3, 3, -3, 3, cs.N_QUAD, cs.N_QUAD, jitter=0.25, seed=5)),
            ("hex", lambda: box_hex_mesh(-3, 3, -3, 3, -3, 3, cs.N_HEX,
                                         cs.N_HEX, cs.N_HEX))):
        _, A_p, hier, _, _ = cs._solve_capturing_amg(mesh(), dev)
        b_p = A_p.matvec(torch.ones(A_p.shape[0], dtype=A_p.dtype,
                                    device=dev))
        out[name] = (A_p, b_p, hier)
        print(f"# built {name}", flush=True)
    torch.cuda.synchronize()
    return out


def _turn(systems, dev):
    from tpufem_torch.solve.cg import cg_fixed
    from tpufem_torch.utils.timing import cuda_ms

    res = {}
    for name in PATHS:
        A_p, b_p, hier = systems[name]

        def run():
            return cg_fixed(A_p.matvec, b_p, 10, M=hier.apply)

        res[name] = dict(issued_ms=cuda_ms(run, reps=5,
                                           queue_ahead=False) / 10,
                         device_ms=cuda_ms(run, reps=5) / 10)
    return res


def _extras(cs, systems, dev):
    """B9's forms and B9's layout bytes (this checkout's kernels; see the
    module's docstring)."""
    import torch

    from tpufem_torch.sparse import ell_cuda as ec
    from tpufem_torch.utils.timing import cuda_ms

    out = {"forms": {}, "layout_bytes": {}}
    g = torch.Generator(device=dev).manual_seed(6)
    n, k, band = cs.ELL_ROWS, cs.ELL_SLOTS, cs.ELL_BANDWIDTH
    rcols = (torch.arange(n, device=dev)[:, None] + torch.randint(
        -band, band + 1, (n, k), generator=g, device=dev)).clamp_(
        0, n - 1).to(torch.int32)
    rdata = torch.randn((n, k), generator=g, device=dev)
    rplan = ec.ell_band_plan(rdata, rcols)
    ops = {"random 1M K=8 fp32": (rplan, torch.as_tensor(
        rplan.data_t, device=dev), torch.as_tensor(rplan.rel, device=dev))}
    for name in PATHS:
        ops[f"{name} fine A"] = systems[name][0]._band
    ops["p2 level 1 A"] = systems["p2"][2].levels[1].A._band

    def nnz_of(d_t):
        return int((d_t != 0).sum())

    for label, (plan, d_t, rel) in ops.items():
        x = torch.randn(plan.n, generator=g, device=dev, dtype=d_t.dtype)
        ref = ec.ell_band_matvec_plain(plan, d_t, rel, x)
        nnz, item = nnz_of(d_t), d_t.element_size()
        needed = nnz * (item + rel.element_size()) + 2 * plan.n * item
        row = {"chosen": str(plan.form), "needed_bound_ms":
               needed / HBM * 1e3, "planes_bytes": d_t.nbytes + rel.nbytes}
        for form in ("rows", "sliced"):
            p = plan._replace(form=ec.EllForm(form, False, 1))
            lay = ec.ell_band_prepare(p, d_t, rel)
            fn = lambda: ec.ell_matvec_cuda(p, d_t, rel, x, layout=lay)
            y = fn()
            torch.cuda.synchronize()
            row[form] = dict(ms=cuda_ms(fn, reps=20),
                             equal=bool(torch.equal(y, ref)),
                             layout_bytes=lay.nbytes())
            del lay, y
        out["forms"][label] = row
        print(f"# forms {label}: " + json.dumps(row), flush=True)
        torch.cuda.empty_cache()

    for name in PATHS:
        A_p, _, hier = systems[name]
        mats = [A_p] + [m for lv in hier.levels for m in (lv.A, lv.Qp, lv.Qr)
                        if m is not None and m is not A_p]
        lay = planes = 0
        for M in mats:
            if isinstance(M._band, tuple):
                lay += M._band_layout(M._band).nbytes()
                planes += M._band[1].nbytes + M._band[2].nbytes
        out["layout_bytes"][name] = dict(layouts=lay, planes=planes)
        print(f"# layout bytes {name}: layouts {lay}, planes {planes}",
              flush=True)
    return out


def _worker(sync: Path, tag: str) -> int:
    import torch

    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    systems = _systems(cs, dev)
    print(f"# {tag}: systems built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    (sync / f"{tag}.ready").write_text("")
    turn = 0
    while True:
        go, extras = sync / f"{tag}.go{turn}", sync / f"{tag}.extras"
        if go.exists():
            res = _turn(systems, dev)
            (sync / f"{tag}.done{turn}").write_text(json.dumps(res))
            turn += 1
        elif extras.exists():
            res = _extras(cs, systems, dev)
            (sync / f"{tag}.extras_done").write_text(json.dumps(res))
            extras.unlink()
        elif (sync / f"{tag}.stop").exists():
            return 0
        else:
            time.sleep(0.05)


# -- the coordinator ---------------------------------------------------------

def main(argv) -> int:
    import torch

    args = list(argv)
    if args[:1] == ["--worker"]:
        return _worker(Path(args[1]), args[2])
    if not torch.cuda.is_available():
        print("amg_wall_ab: no CUDA device", file=sys.stderr)
        return 2
    rounds, extras, out = 2, False, None
    if "--rounds" in args:
        i = args.index("--rounds")
        rounds = int(args[i + 1])
        del args[i:i + 2]
    if "--out" in args:
        i = args.index("--out")
        out = Path(args[i + 1])
        del args[i:i + 2]
    if "--extras" in args:
        extras = True
        args.remove("--extras")
    if len(args) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    roots = dict(zip("AB", (Path(p).resolve() for p in args)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    sync = Path(tempfile.mkdtemp(prefix="amg_wall_ab_"))
    out = sync if out is None else out.resolve()
    out.mkdir(parents=True, exist_ok=True)
    procs, logs = {}, {}
    try:
        for tag, root in roots.items():
            logs[tag] = open(out / f"amg_wall_{tag}.log", "w")
            procs[tag] = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--worker",
                 str(sync), tag], cwd=root, stdout=logs[tag],
                stderr=subprocess.STDOUT)
        for tag in roots:
            _wait(sync / f"{tag}.ready", procs, 1800)
        print("# both checkouts' systems built", flush=True)
        turns = {"A": [], "B": []}
        for _ in range(rounds):
            for tag in "ABBA":
                i = len(turns[tag])
                (sync / f"{tag}.go{i}").write_text("")
                _wait(sync / f"{tag}.done{i}", procs, 600)
                res = json.loads((sync / f"{tag}.done{i}").read_text())
                turns[tag].append(res)
                for name, r in res.items():
                    print(f"# {tag} {roots[tag].name} {name}: "
                          f"{r['issued_ms']:.4f} ms/iteration as issued, "
                          f"{r['device_ms']:.4f} device", flush=True)
        extra = None
        if extras:
            (sync / "B.extras").write_text("")
            _wait(sync / "B.extras_done", procs, 1200)
            extra = json.loads((sync / "B.extras_done").read_text())
        for tag in roots:
            (sync / f"{tag}.stop").write_text("")
        for p in procs.values():
            p.wait(timeout=120)
    except (RuntimeError, TimeoutError):
        for f in logs.values():
            f.flush()
        for tag in logs:
            tail = (out / f"amg_wall_{tag}.log").read_text().splitlines()
            print(f"# worker {tag}'s last lines:", *tail[-20:], sep="\n",
                  file=sys.stderr)
        raise
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs.values():
            f.close()
        shutil.rmtree(sync, ignore_errors=True)
    summary = {}
    for name in PATHS:
        mean = {t: {m: sum(r[name][m] for r in turns[t]) / len(turns[t])
                    for m in ("issued_ms", "device_ms")}
                for t in "AB"}
        summary[name] = dict(
            A=mean["A"], B=mean["B"],
            issued_B_over_A=mean["B"]["issued_ms"] / mean["A"]["issued_ms"])
        print(f"# {name}: as issued A {mean['A']['issued_ms']:.4f} B "
              f"{mean['B']['issued_ms']:.4f} ms/iteration (B / A "
              f"{summary[name]['issued_B_over_A']:.3f}); device A "
              f"{mean['A']['device_ms']:.4f} B {mean['B']['device_ms']:.4f}",
              flush=True)
    print(json.dumps({"wall": summary, "extras": extra}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
