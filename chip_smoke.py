"""Smoke run of the tpufem_torch port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

1. Platform: the card's name and power limit (nvidia-smi).
2. Build: nvcc compiles the port's CUDA kernels K1-K4 from
   tpufem_torch/csrc (sm_90a).
3. Each kernel against its plain PyTorch version on the card, in fp32 at
   the n=8 and n=96 shapes (every MG level pair for K3/K4; K2 also in
   fp64): fields within 1e-5 * max|plain|, dots within 1e-4 relative;
   kernel and plain times are medians of 20 launches (CUDA events).
4. The main path at n=96 (912,673 DOFs): fused build, const MG-PCG with
   10 fixed iterations (relres < 1e-5), the guarded solve_poisson_fast
   (<= 12 iterations), the error against the manufactured solution
   (<= 2.0e-4) and mixed-precision refinement (<= 1e-8 in <= 3 outer
   steps).  Every kernel's launch count over this run must be > 0; the
   per-iteration times are taken after the counts are read.

The second-to-last line is the kernels' JSON record, the last line
{"ok": true, "device": {...}}.  Any failed check raises and the script
exits nonzero; without a CUDA device, or without the package beside it,
it exits nonzero and prints no result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

N_MAIN = 96
N_SMALL = 8
DOMAIN = (-3.0, 3.0)
FIELD_TOL = {"float32": 1e-5, "float64": 1e-12}   # x max|plain|
DOT_TOL = 1e-4                                    # relative
REPS = 20


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        import tpufem_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: tpufem_torch not importable ({exc}); run from "
              "the repository root", file=sys.stderr)
        return 3

    # full fp32 for the coarse-level matmul (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. platform -------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    kind = torch.cuda.get_device_name(0)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind} count {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)

    records = {}
    _build_kernels(records)
    _check_kernels(dev, records)
    _main_path(dev, records)

    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


_KERNELS = {
    "K1": ("fused_system", "tpufem_torch/csrc/fused_system.cu",
           "tpufem/ops/fused_system_pallas.py:126"),
    "K2": ("stencil_matvec", "tpufem_torch/csrc/stencil.cu",
           "tpufem/ops/stencil_pallas.py:86"),
    "K3": ("residual_restrict", "tpufem_torch/csrc/mg_transfer.cu",
           "tpufem/ops/mg_transfer_pallas.py:113"),
    "K4": ("prolong_add_smooth", "tpufem_torch/csrc/mg_transfer.cu",
           "tpufem/ops/mg_transfer_pallas.py:217"),
}


def _record(records, key):
    if key not in records:
        name, source, replaces = _KERNELS[key]
        records[key] = {"name": f"{key} {name}", "route": "cuda",
                        "source": source, "replaces": replaces,
                        "launches": 0, "max_abs_err": 0.0, "ms": None,
                        "plain_ms": None}
    return records[key]


def _build_kernels(records):
    from tpufem_torch.fem.quadrature import tetrahedron_rule
    from tpufem_torch.ops import fused_system_cuda, mg_transfer_cuda
    from tpufem_torch.ops import stencil_cuda
    from tpufem_torch.ops._build import BUILD_DIR
    from tpufem_torch.solve.poisson import model_problem_3d_planes

    plan = _plan(N_MAIN)
    builds = {
        "stencil.cu": stencil_cuda._lib,
        "mg_transfer.cu": mg_transfer_cuda._lib,
        "fused_system.cu": lambda: fused_system_cuda._lib(
            plan, tetrahedron_rule(2), model_problem_3d_planes().c_expr),
    }
    for name, build in builds.items():
        t0 = time.perf_counter()
        build()
        print(f"# build {name}: {time.perf_counter() - t0:.2f} s")
    for log in sorted(BUILD_DIR.glob("*.log")):
        for line in log.read_text().splitlines():
            if ("Compiling entry function" in line or "registers" in line
                    or "spill" in line):
                print(f"# ptxas {log.stem}: {line.strip()}")


def _plan(n):
    from tpufem_torch.assemble.structured import structured_plan
    from tpufem_torch.solve.multigrid import _light_grid

    return structured_plan(_light_grid(DOMAIN, n)[0], embed=True)


def _err(out, ref, dtype_name):
    """(max abs error, bound) of a field against its plain version."""
    err = (out.double() - ref.double()).abs().max().item()
    return err, FIELD_TOL[dtype_name] * max(ref.abs().max().item(), 1e-30)


def _compare(records, key, label, kernel, plain, *, timed=False):
    """Run kernel and plain on the same inputs, check, optionally time."""
    import torch

    from tpufem_torch.utils.timing import cuda_ms

    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    rec = _record(records, key)
    msg = []
    for o, r in zip(outs, refs):
        if o.dim() == 0:                               # a dot
            rel = abs(o.item() - r.item()) / max(abs(r.item()), 1e-30)
            check(rel <= DOT_TOL, f"{key} {label}: dot rel err {rel:.3e}")
            msg.append(f"dot rel {rel:.2e}")
            continue
        dt = str(o.dtype).replace("torch.", "")
        err, bound = _err(o, r, dt)
        check(math.isfinite(err) and err <= bound,
              f"{key} {label}: max abs err {err:.3e} > {bound:.3e}")
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        msg.append(f"max abs err {err:.3e} (bound {bound:.3e})")
    line = f"# check {key} {label}: " + ", ".join(msg)
    if timed:
        # device time (stream queued ahead), then one call at a time with
        # the host's launch overhead included
        ms, plain_ms = cuda_ms(kernel, reps=REPS), cuda_ms(plain, reps=REPS)
        host_ms = cuda_ms(kernel, reps=REPS, queue_ahead=False)
        host_plain_ms = cuda_ms(plain, reps=REPS, queue_ahead=False)
        line += (f"; device kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
                 f"with launch overhead kernel {host_ms:.4f} ms, plain "
                 f"{host_plain_ms:.4f} ms")
        if rec["ms"] is None:       # the first timed shape is the main one
            rec["ms"], rec["plain_ms"] = ms, plain_ms
    print(line)


def _arrays(system):
    A, b = system
    return A.data, b


def _check_kernels(dev, records):
    import numpy as np
    import torch

    from tpufem_torch.fem.quadrature import tetrahedron_rule
    from tpufem_torch.ops.fused_system_cuda import (
        build_poisson_system, build_poisson_system_plain,
        node_coords_embedded_from_grid)
    from tpufem_torch.ops.mg_transfer_cuda import (
        const_prolong_add_smooth_embedded, const_prolong_add_smooth_plain,
        const_residual_restrict_embedded, const_residual_restrict_plain)
    from tpufem_torch.ops.stencil_cuda import (stencil_apply,
                                               stencil_apply_plain)
    from tpufem_torch.solve import multigrid as mg
    from tpufem_torch.solve.poisson import model_problem_3d_planes

    f, rule = model_problem_3d_planes(), tetrahedron_rule(2)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand_like_code(code):
        v = torch.randn(code.shape, generator=gen, device=dev,
                        dtype=code.dtype)
        return torch.where(code != 0, v, 0.0)

    for n in (N_MAIN, N_SMALL):
        timed = n == N_MAIN
        info, coords, bc = mg._light_grid(DOMAIN, n)
        plan = _plan(n)
        C = torch.as_tensor(node_coords_embedded_from_grid(
            coords, plan, np.float32), device=dev)
        _compare(records, "K1", f"n={n} fp32",
                 lambda: _arrays(build_poisson_system(plan, C, f, rule)),
                 lambda: _arrays(build_poisson_system_plain(plan, C, f,
                                                            rule)),
                 timed=timed)
        A, b = build_poisson_system(plan, C, f, rule)
        code = torch.as_tensor(mg._embed_grid_numpy(
            np.ones(info.node_grid), plan.store_grid), device=dev,
            dtype=torch.float32)
        x = rand_like_code(code)
        _compare(records, "K2", f"n={n} fp32 matvec",
                 lambda: stencil_apply(A.data, x, plan.offsets),
                 lambda: stencil_apply_plain(A.data, x, plan.offsets),
                 timed=timed)
        _compare(records, "K2", f"n={n} fp32 matvec+dot",
                 lambda: stencil_apply(A.data, x, plan.offsets,
                                       with_dot=True),
                 lambda: stencil_apply_plain(A.data, x, plan.offsets,
                                             with_dot=True), timed=timed)
        raw64 = mg._apply_bc_numpy(
            mg._uniform_stencil_data(plan, mg._uniform_cell_stiffness(
                DOMAIN, n)), plan.offsets,
            mg._embed_grid_numpy(bc, plan.store_grid, fill=False))
        d64 = torch.as_tensor(raw64, device=dev)
        x64 = x.double()
        _compare(records, "K2", f"n={n} fp64 matvec",
                 lambda: stencil_apply(d64, x64, plan.offsets),
                 lambda: stencil_apply_plain(d64, x64, plan.offsets),
                 timed=timed)
        del d64, raw64

        levels = mg.build_poisson_multigrid(
            DOMAIN, n, coarse_max=8 if n == N_MAIN else 4, device=dev)
        for lf, lc in zip(levels[:-1], levels[1:]):
            nf, nc = lf.plan.info.cell_grid[0], lc.plan.info.cell_grid[0]
            r, e, ec = (rand_like_code(lf.code), rand_like_code(lf.code),
                        rand_like_code(lc.code))
            a3 = (lf.weights, lf.code, lc.code, r, e, lf.plan, lc.plan)
            _compare(records, "K3", f"{nf}->{nc} fp32",
                     lambda: const_residual_restrict_embedded(*a3),
                     lambda: const_residual_restrict_plain(*a3), timed=timed)
            a4 = (lf.weights, lf.code, ec, r, e, lf.plan, lc.plan)
            for wd in (False, True):
                _compare(records, "K4",
                         f"{nf}->{nc} fp32{' +dot' if wd else ''}",
                         lambda: const_prolong_add_smooth_embedded(
                             *a4, with_dot=wd),
                         lambda: const_prolong_add_smooth_plain(
                             *a4, with_dot=wd), timed=timed)


def _main_path(dev, records):
    import numpy as np
    import torch

    from tpufem_torch.fem.quadrature import tetrahedron_rule
    from tpufem_torch.ops import fused_system_cuda, mg_transfer_cuda
    from tpufem_torch.ops import stencil_cuda
    from tpufem_torch.ops.fused_system_cuda import (
        build_poisson_system, node_coords_embedded_from_grid)
    from tpufem_torch.ops.stencil_cuda import (stencil_matvec_dot_embedded,
                                               stencil_matvec_embedded)
    from tpufem_torch.solve import multigrid as mg
    from tpufem_torch.solve.cg import cg_fixed
    from tpufem_torch.solve.poisson import (model_problem_3d,
                                            model_problem_3d_planes)
    from tpufem_torch.solve.refine import refined_stencil_solve
    from tpufem_torch.solve.structured_fast import solve_poisson_fast
    from tpufem_torch.utils.timing import PhaseTimer, cuda_ms

    counters = {
        "K1": fused_system_cuda.build_poisson_system,
        "K2": stencil_cuda.stencil_apply,
        "K3": mg_transfer_cuda.const_residual_restrict_embedded,
        "K4": mg_transfer_cuda.const_prolong_add_smooth_embedded,
    }
    timer = PhaseTimer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0

    n = N_MAIN
    f = model_problem_3d_planes()
    with timer("host_setup"):
        info, coords, bc = mg._light_grid(DOMAIN, n)
        plan = _plan(n)
        C = torch.as_tensor(node_coords_embedded_from_grid(
            coords, plan, np.float32), device=dev)
        torch.cuda.synchronize()
    with timer("assemble"):
        A, b = build_poisson_system(plan, C, f, tetrahedron_rule(2))
        torch.cuda.synchronize()
    with timer("hierarchy"):
        levels = mg.build_poisson_multigrid(DOMAIN, n, dtype=torch.float32,
                                            device=dev)
        M = mg.mg_preconditioner(levels)
        M_dot = mg.mg_preconditioner(levels, with_dot=True)
        torch.cuda.synchronize()
    check(len(levels) == 5 and levels[-1].coarse_inverse is not None
          and levels[-1].coarse_inverse.shape == (343, 343),
          "hierarchy: expected 5 levels with a 343-node dense inverse")

    def mv(v):
        return stencil_matvec_embedded(A.data, v, plan)

    def mvd(v):
        return stencil_matvec_dot_embedded(A.data, v, plan)

    def pcg10():
        return cg_fixed(mv, b, 10, M=M, matvec_dot=mvd, M_dot=M_dot)

    with timer("pcg_10_iters"):
        x, r = pcg10()
        torch.cuda.synchronize()
    relres = (torch.linalg.vector_norm(r)
              / torch.linalg.vector_norm(b)).item()
    print(f"# main pcg: 10 iterations relres {relres:.3e}")
    check(relres < 1e-5, f"10-iteration relres {relres:.3e} >= 1e-5")

    _, exact = model_problem_3d()
    ue = torch.as_tensor(exact(coords.reshape(3, -1).T), device=dev)

    def rel_err(u):
        return (torch.linalg.vector_norm(u.double() - ue)
                / torch.linalg.vector_norm(ue)).item()

    err = rel_err(plan.extract_field(x))
    print(f"# main rel L2 error vs exact: {err:.4e}")
    check(err <= 2.0e-4, f"rel L2 error {err:.3e} > 2.0e-4")

    with timer("solve_poisson_fast"):
        sol = solve_poisson_fast(DOMAIN, n, f, tol=1e-5, device=dev)
    print(f"# main guarded solve: {sol.cg.iterations} iterations, relres "
          f"{sol.cg.residual_norm.item():.3e}, phases {sol.phases_s}, "
          f"rel L2 error {rel_err(sol.u):.4e}")
    check(sol.cg.converged and sol.cg.iterations <= 12,
          f"guarded cg: {sol.cg.iterations} iterations, converged "
          f"{sol.cg.converged}")

    with timer("refine_to_1e-8"):
        raw64 = mg._apply_bc_numpy(
            mg._uniform_stencil_data(plan, mg._uniform_cell_stiffness(
                DOMAIN, n)), plan.offsets,
            mg._embed_grid_numpy(bc, plan.store_grid, fill=False))
        data64 = torch.as_tensor(raw64, device=dev)
        del raw64
        res = refined_stencil_solve(
            A.data, data64, plan.offsets, b.double(), M, tol=1e-8,
            inner_iters=12, max_outer=6, matvec32=mv, matvec_dot32=mvd,
            M_dot=M_dot)
        torch.cuda.synchronize()
    print(f"# main refinement: relres {res.residual_norm:.3e} in "
          f"{res.outer_iterations} outer steps")
    check(res.residual_norm <= 1e-8 and res.outer_iterations <= 3,
          f"refinement: {res.residual_norm:.3e} after "
          f"{res.outer_iterations} outer steps")

    # the counts of the main path's run, read before anything else launches
    launches = {key: fn.launches for key, fn in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for key, count in launches.items():
        _record(records, key)["launches"] = count
        check(count > 0, f"{key} was never launched on the main path")
    print("# main phases (s, wall clock ending in a synchronize): "
          + json.dumps({k: round(v, 4) for k, v in timer.report().items()}))
    print("# main launches: " + json.dumps(launches))
    print(f"# main peak device memory: {peak_gb:.3f} GB "
          "(torch.cuda.max_memory_allocated)")

    # CUDA events around the 10-iteration run: as issued (host launch
    # overhead included) and with the stream queued ahead (device time)
    iter_ms = cuda_ms(pcg10, reps=5, queue_ahead=False) / 10
    iter_dev_ms = cuda_ms(pcg10, reps=5) / 10
    print(f"# main pcg: {iter_ms:.4f} ms/iteration as issued, "
          f"{iter_dev_ms:.4f} ms/iteration device time, device idle share "
          f"{1.0 - iter_dev_ms / iter_ms:.3f} (CUDA events)")


if __name__ == "__main__":
    sys.exit(main())
