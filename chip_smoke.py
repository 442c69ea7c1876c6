"""Smoke run of the tpufem_torch port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

1. Platform: the card's name and power limit (nvidia-smi).
2. Build: nvcc compiles the port's CUDA sources from tpufem_torch/csrc
   (sm_90a), one process per source, all started together.
3. Each kernel against its plain PyTorch version on the card, at every
   shape the paths give it: the n=96 and n=8 hierarchies (96..6, 8..4)
   and the 2-level n=64 ones.  K1 and K2 in fp32 (K2 also in fp64); B4
   (general-coefficient residual, sweep, sweep+dot) on every level of the
   general hierarchy over the built operator, with fp32 data and, on its
   bf16 cast, bf16 data under fp32 vectors; B5 (const-weight matvec,
   residual, sweep, sweep+dot) on every const level; K3/K4 on every level
   pair.  Fields within 1e-5 * max|plain| (1e-12 in fp64), dots within
   1e-4 relative; at n=96 kernel and plain times are medians of 20
   launches (CUDA events).
4. The paths, each driven with every launch count set to 0 just before it
   and read just after (the per-iteration times are taken after that):
   - main, n=96 (912,673 DOFs): fused build, const MG-PCG (nu1 = nu2 = 1)
     with 10 fixed iterations (relres < 1e-5), the guarded
     solve_poisson_fast (<= 12 iterations), the error against the
     manufactured solution (<= 2.0e-4) and mixed-precision refinement
     (<= 1e-8 in <= 3 outer steps); K1-K4 must launch;
   - general, n=96: the general hierarchy on the built operator (top=):
     10 fixed iterations reach relres < 1e-5; the guarded cg to 1e-5 on
     the fp32 hierarchy and on its bf16 cast (<= the fp32 count + 2); B4
     must launch;
   - dirichlet, n=96: solve_poisson_fast(precond="general", g=L) with
     L = x + 2y + 3z (harmonic: the solution is u + L) converges, error
     against u + L <= 2.0e-4;
   - nu2, n=96: the const hierarchy with the default nu1 = nu2 = 2
     converges to 1e-5 in <= 12 iterations; B5 must launch;
   - jacobi, n=64 with 2 levels: the coarsest level (33^3 nodes) has no
     dense inverse, so 20 Jacobi sweeps stand in for it, on const and on
     general levels; PCG converges to 1e-5; B4 and B5 must launch.

The second-to-last line is the kernels' JSON record (launches summed over
the paths), the last line {"ok": true, "device": {...}}.  Any failed check
raises and the script exits nonzero; without a CUDA device, or without the
package beside it, it exits nonzero and prints no result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

N_MAIN = 96
N_SMALL = 8
N_JACOBI = 64      # with 2 levels the coarsest has 33^3 > 20,000 nodes
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
    _build_kernels()
    _check_kernels(dev, records)
    _paths(dev, records)

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
    "B4": ("stencil_residual_smooth", "tpufem_torch/csrc/stencil.cu",
           "tpufem/ops/stencil_pallas.py:92"),
    "B5": ("const_stencil", "tpufem_torch/csrc/const_stencil.cu",
           "tpufem/ops/stencil_pallas.py:530"),
}


def _counters():
    """Each kernel's wrapper, which carries its launch count."""
    from tpufem_torch.ops import fused_system_cuda, mg_transfer_cuda
    from tpufem_torch.ops import stencil_cuda

    return {"K1": fused_system_cuda.build_poisson_system,
            "K2": stencil_cuda.stencil_apply,
            "K3": mg_transfer_cuda.const_residual_restrict_embedded,
            "K4": mg_transfer_cuda.const_prolong_add_smooth_embedded,
            "B4": stencil_cuda.stencil_fused_apply,
            "B5": stencil_cuda.const_stencil_apply}


def _record(records, key):
    if key not in records:
        name, source, replaces = _KERNELS[key]
        records[key] = {"name": f"{key} {name}", "route": "cuda",
                        "source": source, "replaces": replaces,
                        "launches": 0, "max_abs_err": 0.0, "ms": None,
                        "plain_ms": None}
    return records[key]


def _build_kernels():
    from tpufem_torch.fem.quadrature import tetrahedron_rule
    from tpufem_torch.ops import fused_system_cuda, mg_transfer_cuda
    from tpufem_torch.ops import stencil_cuda
    from tpufem_torch.ops._build import BUILD_DIR
    from tpufem_torch.solve.poisson import model_problem_3d_planes

    plan = _plan(N_MAIN)
    builds = {
        "stencil.cu": stencil_cuda._stencil_lib,
        "const_stencil.cu": stencil_cuda._const_lib,
        "mg_transfer.cu": mg_transfer_cuda._lib,
        "fused_system.cu": lambda: fused_system_cuda._lib(
            plan, tetrahedron_rule(2), model_problem_3d_planes().c_expr),
    }

    def timed(build):
        t0 = time.perf_counter()
        build()
        return time.perf_counter() - t0

    # one nvcc process per source, all at once (each waits in its thread)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        secs = dict(zip(builds, pool.map(timed, builds.values())))
    print(f"# build (parallel) {time.perf_counter() - t0:.2f} s: "
          + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items()))
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
    from tpufem_torch.ops.stencil_cuda import (const_stencil_apply,
                                               const_stencil_apply_plain,
                                               stencil_apply,
                                               stencil_apply_plain,
                                               stencil_fused_apply,
                                               stencil_fused_apply_plain)
    from tpufem_torch.solve import multigrid as mg
    from tpufem_torch.solve.poisson import model_problem_3d_planes

    f, rule = model_problem_3d_planes(), tetrahedron_rule(2)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand_like_code(code, dtype=None):
        """Random vector on the rows where ``code`` is nonzero (the nodes),
        0 on the padding."""
        v = torch.randn(code.shape, generator=gen, device=dev,
                        dtype=dtype or code.dtype)
        return torch.where(code != 0, v, 0.0)

    # every shape the paths give B4, B5, K3 and K4: the 5-level n=96
    # hierarchies, the n=8 ones, and the 2-level n=64 ones of "jacobi"
    for n, depth in ((N_MAIN, dict(coarse_max=8)),
                     (N_SMALL, dict(coarse_max=4)),
                     (N_JACOBI, dict(levels=2))):
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

        # B4 on every level of the general hierarchy over the built
        # operator (top=), fp32 data, and bf16 data (its cast_hierarchy
        # copy) under fp32 vectors
        bc_mask = torch.as_tensor(mg._embed_grid_numpy(
            bc, plan.store_grid, fill=False), device=dev)
        general = mg.build_poisson_multigrid(DOMAIN, n, top=(A.data, bc_mask),
                                             device=dev, **depth)
        for dname, lvs in (("fp32", general),
                           ("bf16", mg.cast_hierarchy(general,
                                                      torch.bfloat16))):
            for lv in lvs:
                nl = lv.plan.info.cell_grid[0]
                node = lv.data[lv.plan.offsets.index(0)]
                xs = rand_like_code(node, torch.float32)
                rs = rand_like_code(node, torch.float32)
                ii = lv.inv_diag
                for label, ep, kw in (("smooth", "smooth", dict(inv_diag=ii)),
                                      ("smooth+dot", "smooth",
                                       dict(inv_diag=ii, with_dot=True)),
                                      ("residual", "residual", {})):
                    if dname == "bf16" and ep == "residual":
                        continue
                    args = (ep, lv.data, xs, lv.plan.offsets)
                    _compare(records, "B4",
                             f"n={n} level {nl} {dname} data {label}",
                             lambda: stencil_fused_apply(*args, b=rs, **kw),
                             lambda: stencil_fused_apply_plain(*args, b=rs,
                                                               **kw),
                             timed=timed)
        del general

        levels = mg.build_poisson_multigrid(DOMAIN, n, operator="const",
                                            device=dev, **depth)
        # B5 on every level; the code plane in bf16 must not change it
        for lv in levels:
            nl = lv.plan.info.cell_grid[0]
            xs, rs = rand_like_code(lv.code), rand_like_code(lv.code)
            for label, ep, kw in (("smooth", "smooth", dict(b=rs)),
                                  ("smooth+dot", "smooth",
                                   dict(b=rs, with_dot=True)),
                                  ("matvec", "matvec", {}),
                                  ("residual", "residual", dict(b=rs))):
                args = (ep, lv.weights, lv.code, xs, lv.plan.offsets)
                _compare(records, "B5", f"n={n} level {nl} fp32 {label}",
                         lambda: const_stencil_apply(*args, **kw),
                         lambda: const_stencil_apply_plain(*args, **kw),
                         timed=timed)
            code16 = lv.code.to(torch.bfloat16)
            same = torch.equal(
                const_stencil_apply("smooth", lv.weights, code16, xs,
                                    lv.plan.offsets, b=rs),
                const_stencil_apply("smooth", lv.weights, lv.code, xs,
                                    lv.plan.offsets, b=rs))
            check(same, f"B5 n={n} level {nl}: a bf16 code plane changed "
                        "the sweep")
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


def _run_path(name, counters, records, drive, must_launch):
    """Drive one path with every launch count at 0 just before it; read
    the counts just after, check that the path's kernels launched, and
    then run what ``drive`` returned (timing that must not count)."""
    import torch

    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    after = drive()
    torch.cuda.synchronize()
    launches = {key: fn.launches for key, fn in counters.items()}
    print(f"# {name} launches: " + json.dumps(launches))
    for key in must_launch:
        check(launches[key] > 0, f"{key} was never launched on the "
                                 f"{name} path")
    for key, count in launches.items():
        _record(records, key)["launches"] += count
    if after is not None:
        after()


def _per_iteration(name, pcg10):
    """Per MG-PCG iteration of a 10-iteration run: the time as issued (CUDA
    events around the run; host launch overhead included), the device busy
    time (the run's kernel durations summed, torch.profiler) and the kernel
    launches.  Events with the stream queued ahead would overstate the
    device time of a run with more launches than the launch queue holds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpufem_torch.utils.timing import cuda_ms

    iter_ms = cuda_ms(pcg10, reps=5, queue_ahead=False) / 10
    queued_ms = cuda_ms(pcg10, reps=5) / 10
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pcg10()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type.name == "CUDA"),
                     key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in kernels)
    busy_ms = busy_us / 1e3 / 10
    launches = sum(e.count for e in kernels) / 10
    print(f"# {name} pcg: {iter_ms:.4f} ms/iteration as issued, "
          f"{busy_ms:.4f} ms/iteration device busy, device idle share "
          f"{1.0 - busy_ms / iter_ms:.3f}, {launches:.1f} kernel launches "
          f"per iteration (CUDA events; torch.profiler); events with the "
          f"stream queued ahead {queued_ms:.4f} ms/iteration")
    # device time by kernel (the same profiled run), largest first
    for e in kernels:
        print(f"# {name} pcg kernel: {e.self_device_time_total / busy_us:6.1%}"
              f" {e.self_device_time_total / 1e3 / 10:.4f} ms/iteration "
              f"{e.count / 10:6.1f} launches/iteration  {e.key[:90]}")


def _paths(dev, records):
    import numpy as np
    import torch

    from tpufem_torch.fem.quadrature import tetrahedron_rule
    from tpufem_torch.ops.fused_system_cuda import (
        build_poisson_system, node_coords_embedded_from_grid)
    from tpufem_torch.ops.stencil_cuda import (stencil_matvec_dot_embedded,
                                               stencil_matvec_embedded)
    from tpufem_torch.solve import multigrid as mg
    from tpufem_torch.solve.cg import cg, cg_fixed
    from tpufem_torch.solve.poisson import (model_problem_3d,
                                            model_problem_3d_planes)
    from tpufem_torch.solve.refine import refined_stencil_solve
    from tpufem_torch.solve.structured_fast import solve_poisson_fast
    from tpufem_torch.utils.timing import PhaseTimer

    counters = _counters()
    n = N_MAIN
    f = model_problem_3d_planes()
    _, exact = model_problem_3d()
    torch.cuda.reset_peak_memory_stats()

    def system(n):
        """(plan, bc grid, coords, fused-build A, b) at n cells a side."""
        info, coords, bc = mg._light_grid(DOMAIN, n)
        plan = _plan(n)
        C = torch.as_tensor(node_coords_embedded_from_grid(
            coords, plan, np.float32), device=dev)
        A, b = build_poisson_system(plan, C, f, tetrahedron_rule(2))
        return plan, bc, coords, A, b

    def solvers(plan, A):
        return (lambda v: stencil_matvec_embedded(A.data, v, plan),
                lambda v: stencil_matvec_dot_embedded(A.data, v, plan))

    def relres(r, b):
        return (torch.linalg.vector_norm(r)
                / torch.linalg.vector_norm(b)).item()

    def rel_err(u, ue):
        return (torch.linalg.vector_norm(u.double() - ue)
                / torch.linalg.vector_norm(ue)).item()

    main = {}

    def drive_main():
        timer = PhaseTimer()
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
            levels = mg.build_poisson_multigrid(
                DOMAIN, n, dtype=torch.float32, operator="const", device=dev)
            M = mg.mg_preconditioner(levels, nu1=1, nu2=1)
            M_dot = mg.mg_preconditioner(levels, nu1=1, nu2=1,
                                         with_dot=True)
            torch.cuda.synchronize()
        check(len(levels) == 5 and levels[-1].coarse_inverse is not None
              and levels[-1].coarse_inverse.shape == (343, 343),
              "hierarchy: expected 5 levels with a 343-node dense inverse")
        mv, mvd = solvers(plan, A)

        def pcg10():
            return cg_fixed(mv, b, 10, M=M, matvec_dot=mvd, M_dot=M_dot)

        with timer("pcg_10_iters"):
            x, r = pcg10()
            torch.cuda.synchronize()
        rr = relres(r, b)
        print(f"# main pcg: 10 iterations relres {rr:.3e}")
        check(rr < 1e-5, f"10-iteration relres {rr:.3e} >= 1e-5")

        ue = torch.as_tensor(exact(coords.reshape(3, -1).T), device=dev)
        err = rel_err(plan.extract_field(x), ue)
        print(f"# main rel L2 error vs exact: {err:.4e}")
        check(err <= 2.0e-4, f"rel L2 error {err:.3e} > 2.0e-4")

        with timer("solve_poisson_fast"):
            sol = solve_poisson_fast(DOMAIN, n, f, tol=1e-5, device=dev)
        print(f"# main guarded solve: {sol.cg.iterations} iterations, "
              f"relres {sol.cg.residual_norm.item():.3e}, phases "
              f"{sol.phases_s}, rel L2 error {rel_err(sol.u, ue):.4e}")
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
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        print("# main phases (s, wall clock ending in a synchronize): "
              + json.dumps({k: round(v, 4)
                            for k, v in timer.report().items()}))
        print(f"# main peak device memory: {peak_gb:.3f} GB "
              "(torch.cuda.max_memory_allocated)")
        main.update(plan=plan, bc=bc, coords=coords, A=A, b=b, ue=ue)
        return lambda: _per_iteration("main", pcg10)

    _run_path("main", counters, records, drive_main,
              ("K1", "K2", "K3", "K4"))
    plan, A, b = main["plan"], main["A"], main["b"]
    mv, mvd = solvers(plan, A)

    def drive_general():
        bc_mask = torch.as_tensor(mg._embed_grid_numpy(
            main["bc"], plan.store_grid, fill=False), device=dev)
        levels = mg.build_poisson_multigrid(
            DOMAIN, n, dtype=torch.float32, top=(A.data, bc_mask),
            device=dev)
        check(len(levels) == 5 and isinstance(levels[0], mg.MGLevel)
              and levels[0].data.data_ptr() == A.data.data_ptr(),
              "general hierarchy: 5 levels sharing the built operator")
        M = mg.mg_preconditioner(levels, nu1=1, nu2=1)
        M_dot = mg.mg_preconditioner(levels, nu1=1, nu2=1, with_dot=True)

        def pcg10():
            return cg_fixed(mv, b, 10, M=M, matvec_dot=mvd, M_dot=M_dot)

        _, r = pcg10()
        rr = relres(r, b)
        print(f"# general pcg: 10 iterations relres {rr:.3e}")
        check(rr < 1e-5, f"general: 10-iteration relres {rr:.3e} >= 1e-5")
        its = {}
        for name, lv in (("fp32", levels),
                         ("bf16", mg.cast_hierarchy(levels,
                                                    torch.bfloat16))):
            res = cg(mv, b, tol=1e-5, maxiter=60, check_every=1,
                     M=mg.mg_preconditioner(lv, nu1=1, nu2=1),
                     matvec_dot=mvd,
                     M_dot=mg.mg_preconditioner(lv, nu1=1, nu2=1,
                                                with_dot=True))
            its[name] = res.iterations
            print(f"# general guarded cg, {name} hierarchy: "
                  f"{res.iterations} iterations, relres "
                  f"{res.residual_norm.item():.3e}")
            check(res.converged, f"general {name}: not converged")
        check(its["bf16"] <= its["fp32"] + 2,
              f"general: bf16 {its['bf16']} > fp32 {its['fp32']} + 2")
        check(A.data.dtype == torch.float32 and levels[0].data is A.data,
              "cast_hierarchy touched the shared operator")
        return lambda: _per_iteration("general", pcg10)

    _run_path("general", counters, records, drive_general, ("B4",))

    def drive_dirichlet():
        def lin(x, y, z):
            return x + 2.0 * y + 3.0 * z

        t0 = time.perf_counter()
        sol = solve_poisson_fast(DOMAIN, n, f, precond="general", g=lin,
                                 tol=1e-5, device=dev)
        wall = time.perf_counter() - t0
        xyz = main["coords"].reshape(3, -1)
        err = rel_err(sol.u, main["ue"] + torch.as_tensor(lin(*xyz),
                                                          device=dev))
        print(f"# dirichlet solve: {sol.cg.iterations} iterations, relres "
              f"{sol.cg.residual_norm.item():.3e}, rel L2 error vs u + L "
              f"{err:.4e}, phases {sol.phases_s}, wall {wall:.4f} s")
        check(sol.cg.converged, "dirichlet: not converged")
        check(err <= 2.0e-4, f"dirichlet: rel L2 error {err:.3e} > 2.0e-4")

    _run_path("dirichlet", counters, records, drive_dirichlet,
              ("K1", "K2", "B4"))

    def drive_nu2():
        levels = mg.build_poisson_multigrid(
            DOMAIN, n, dtype=torch.float32, operator="const", device=dev)
        res = cg(mv, b, tol=1e-5, maxiter=60, check_every=1,
                 M=mg.mg_preconditioner(levels), matvec_dot=mvd,
                 M_dot=mg.mg_preconditioner(levels, with_dot=True))
        print(f"# nu2 guarded cg (nu1 = nu2 = 2): {res.iterations} "
              f"iterations, relres {res.residual_norm.item():.3e}")
        check(res.converged and res.iterations <= 12,
              f"nu2: {res.iterations} iterations, converged "
              f"{res.converged}")

    _run_path("nu2", counters, records, drive_nu2, ("B5", "K3", "K4"))

    def drive_jacobi():
        plan64, bc64, _, A64, b64 = system(N_JACOBI)
        mv64, mvd64 = solvers(plan64, A64)
        bc_mask = torch.as_tensor(mg._embed_grid_numpy(
            bc64, plan64.store_grid, fill=False), device=dev)
        for op, top in (("const", None), ("general", (A64.data, bc_mask))):
            levels = mg.build_poisson_multigrid(
                DOMAIN, N_JACOBI, dtype=torch.float32, levels=2,
                operator=op, top=top, device=dev)
            check(len(levels) == 2 and levels[-1].coarse_inverse is None,
                  f"jacobi {op}: expected 2 levels and no dense inverse")
            res = cg(mv64, b64, tol=1e-5, maxiter=200, check_every=1,
                     M=mg.mg_preconditioner(levels, nu1=1, nu2=1),
                     matvec_dot=mvd64,
                     M_dot=mg.mg_preconditioner(levels, nu1=1, nu2=1,
                                                with_dot=True))
            print(f"# jacobi {op} levels (coarsest 33^3, 20 sweeps): "
                  f"{res.iterations} iterations, relres "
                  f"{res.residual_norm.item():.3e}")
            check(res.converged, f"jacobi {op}: not converged")

    _run_path("jacobi", counters, records, drive_jacobi, ("B4", "B5"))


if __name__ == "__main__":
    sys.exit(main())
