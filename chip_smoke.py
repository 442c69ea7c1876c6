"""Smoke run of the tpufem_torch port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

1. Platform: the card's name and power limit (nvidia-smi).
2. Build: nvcc compiles the port's CUDA sources from tpufem_torch/csrc
   (sm_90a), one process per source and generated header, all started
   together.
3. Each kernel against its plain PyTorch version on the card, at every
   shape the paths give it.  Fields within 1e-5 * max|plain| (1e-12 in
   fp64), dots within 1e-4 relative; at each kernel's main shape the
   kernel, its plain version and (where one exists) one PyTorch library
   call computing the same function are timed (medians of 20 launches,
   CUDA events), beside the bound: the larger of the bytes the call must
   move over the HBM rate and its operations over the card's peak rate.
   - 3D, the n=96 and n=8 hierarchies (96..6, 8..4) and the 2-level n=64
     ones: K1 and K2 in fp32 (K2 also in fp64); B4 (residual, sweep,
     sweep+dot) on every level of the general hierarchy over the built
     operator, fp32 data and bf16 data under fp32 vectors; B5 (matvec,
     residual, sweep, sweep+dot) on every const level; K3/K4 on every
     level pair.
   - 2D, n=1024 and n=8: B7 in fp32 and fp64; K2 on B7's fp32 and fp64
     operators; B5 with 7 offsets on every const level (1024..8) in fp32
     and fp64; B4 on every level of the general hierarchy over B7's
     operator, fp32 and bf16 data.
   - Scale, n=384: K1; B3 (matvec, matvec+dot, residual, sweep,
     sweep+dot) and B5b (matvec, residual, sweep, sweep+dot) on the finest
     level of the general and const hierarchies (fp32 and bf16 data / code
     under fp32 vectors), each also against the flat kernel (K2/B4, B5)
     on the same inputs; B4 and B5 on level 192; K3/K4 on 384->192->96.
   - Routed: B3 and B5b at n=64 with the routing threshold set to 0,
     through the routed wrappers, in fp32, bf16-under-fp32 and fp64, also
     against the flat kernels.
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
     general levels; PCG converges to 1e-5; B4 and B5 must launch;
   - 2d, n=1024 (1,050,625 DOFs), fp32: solve_poisson_fast(dim=2), const
     and general, each in <= 8 guarded iterations with rel L2 error
     <= 2.2e-3; the general hierarchy cast to bf16 takes <= the fp32
     count + 2; B7, K2, B4 and B5 must launch;
   - 2d_dirichlet, n=1024, fp64: f = 0 and g = 1 + 2x - 3y, tol 1e-11:
     the solution reproduces g to < 1e-8; B7, K2 and B5 must launch;
   - scale, n=384 (57,066,625 DOFs), fp32: solve_poisson_fast with the
     const hierarchy (<= 12 guarded iterations) and with
     precond="general" (<= 16), each with rel L2 error <= 2.0e-4, its
     phases and peak device memory; then one fused build with the const
     hierarchy at nu1 = nu2 = 2 (<= 12); K1, B3, B5b, K3, K4 and B4 must
     launch.

The second-to-last line is the kernels' JSON record (launches summed over
the paths), the last line {"ok": true, "device": {...}}.  Any failed check
raises and the script exits nonzero; without a CUDA device, or without the
package beside it, it exits nonzero and prints no result.
"""
from __future__ import annotations

import json
import math
import resource
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

N_MAIN = 96
N_SMALL = 8
N_JACOBI = 64      # with 2 levels the coarsest has 33^3 > 20,000 nodes
N_2D = 1024
N_SCALE = 384
N_ROUTED = 64      # blocked kernels with the routing threshold at 0
DOMAIN = (-3.0, 3.0)
FIELD_TOL = {"float32": 1e-5, "float64": 1e-12}   # x max|plain|
DOT_TOL = 1e-4                                    # relative
REPS = 20

# NVIDIA H100 SXM data sheet: HBM3 rate and the peak rates outside the
# tensor cores of the types these kernels compute in (bf16 data widens to
# fp32 before any operation)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}


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
    t0 = time.perf_counter()
    _build_kernels()
    _check_kernels(dev, records)
    _check_2d(dev, records)
    _check_scale(dev, records)
    _check_routed(dev, records)
    print(f"# check phase {time.perf_counter() - t0:.1f} s")
    _paths(dev, records)
    print(f"# all phases {time.perf_counter() - t0:.1f} s")

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
    "B7": ("fused_system_2d", "tpufem_torch/csrc/fused_system_2d.cu",
           "tpufem/ops/fused_system_pallas.py:277"),
    "B3": ("stencil_blocked", "tpufem_torch/csrc/stencil_blocked.cu",
           "tpufem/ops/stencil_pallas.py:333"),
    "B5b": ("const_stencil_blocked", "tpufem_torch/csrc/stencil_blocked.cu",
            "tpufem/ops/stencil_pallas.py:651"),
}


def _counters():
    """Each kernel's launch count: (the wrapper that carries it, its
    attribute)."""
    from tpufem_torch.ops import fused_system_cuda, mg_transfer_cuda
    from tpufem_torch.ops import stencil_cuda

    build = fused_system_cuda.build_poisson_system
    return {"K1": (build, "launches"),
            "K2": (stencil_cuda.stencil_apply, "launches"),
            "K3": (mg_transfer_cuda.const_residual_restrict_embedded,
                   "launches"),
            "K4": (mg_transfer_cuda.const_prolong_add_smooth_embedded,
                   "launches"),
            "B4": (stencil_cuda.stencil_fused_apply, "launches"),
            "B5": (stencil_cuda.const_stencil_apply, "launches"),
            "B7": (build, "launches_2d"),
            "B3": (stencil_cuda.stencil_blocked_apply, "launches"),
            "B5b": (stencil_cuda.const_stencil_blocked_apply, "launches")}


def _record(records, key):
    if key not in records:
        name, source, replaces = _KERNELS[key]
        records[key] = {"name": f"{key} {name}", "route": "cuda",
                        "source": source, "replaces": replaces,
                        "launches": 0, "max_abs_err": 0.0, "ms": None,
                        "plain_ms": None, "bound_ms": None,
                        "bound_by": None, "library_ms": None}
    return records[key]


def _rhs_2d_zero():
    from tpufem_torch.solve.poisson import RhsFunction

    return RhsFunction(lambda x, y: 0.0 * x, "T(0)")


def _build_kernels():
    from tpufem_torch.fem.quadrature import tetrahedron_rule, triangle_rule
    from tpufem_torch.ops import fused_system_cuda, mg_transfer_cuda
    from tpufem_torch.ops import stencil_cuda
    from tpufem_torch.ops._build import BUILD_DIR
    from tpufem_torch.solve.poisson import (model_problem_2d_planes,
                                            model_problem_3d_planes)

    plan, plan2 = _plan(N_MAIN), _plan(N_2D, 2)
    builds = {
        "stencil.cu": stencil_cuda._stencil_lib,
        "const_stencil.cu": stencil_cuda._const_lib,
        "stencil_blocked.cu": stencil_cuda._blocked_lib,
        "mg_transfer.cu": mg_transfer_cuda._lib,
        "fused_system.cu": lambda: fused_system_cuda._lib(
            plan, tetrahedron_rule(2), model_problem_3d_planes().c_expr),
        "fused_system_2d.cu": lambda: fused_system_cuda._lib(
            plan2, triangle_rule(2), model_problem_2d_planes().c_expr),
        "fused_system_2d.cu (f = 0)": lambda: fused_system_cuda._lib(
            plan2, triangle_rule(2), _rhs_2d_zero().c_expr),
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


def _plan(n, dim=3):
    from tpufem_torch.assemble.structured import structured_plan
    from tpufem_torch.solve.multigrid import _light_grid

    return structured_plan(_light_grid(DOMAIN, n, dim, with_coords=False)[0],
                           embed=True)


def _err(out, ref, dtype_name):
    """(max abs error, bound) of a field against its plain version."""
    err = (out.double() - ref.double()).abs().max().item()
    return err, FIELD_TOL[dtype_name] * max(ref.abs().max().item(), 1e-30)


def _bound(inputs, outputs, flops, dtype_name):
    """(ms, "bytes" | "operations"): the least time of a call that reads
    each input once, writes each output once and does ``flops``
    operations of ``dtype_name``."""
    nbytes = sum(t.numel() * t.element_size() for t in inputs + outputs)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype_name] * 1e3
    return ((bytes_ms, "bytes") if bytes_ms >= ops_ms
            else (ops_ms, "operations"))


def _compare(records, key, label, kernel, plain, *, timed=False, work=None,
             flat=None, library=None):
    """Run kernel and plain on the same inputs, check, optionally time.

    ``work``: (input tensors, operations, arithmetic type) for the bound;
    ``flat``: the flat kernel on the same inputs (the blocked kernels are
    held to it too); ``library``: one PyTorch call that computes the same
    function (timed beside the kernel, used nowhere in the port).  The
    first timed shape of a kernel is its main one, recorded in the JSON.
    """
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
    if flat is not None:
        fl = flat()
        fl = fl if isinstance(fl, tuple) else (fl,)
        torch.cuda.synchronize()
        for o, f in zip(outs, fl):
            if o.dim() == 0:
                rel = abs(o.item() - f.item()) / max(abs(f.item()), 1e-30)
                check(rel <= DOT_TOL, f"{key} {label}: dot vs flat {rel:.3e}")
                msg.append(f"dot vs flat rel {rel:.2e}")
                continue
            dt = str(o.dtype).replace("torch.", "")
            err, bound = _err(o, f, dt)
            check(err <= bound, f"{key} {label}: vs flat kernel {err:.3e} "
                                f"> {bound:.3e}")
            msg.append(f"vs flat kernel {err:.3e}"
                       + (" (identical)" if torch.equal(o, f) else ""))
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
        bound_ms = bound_by = flat_ms = lib_ms = None
        if work is not None:
            inputs, flops, arith = work
            bound_ms, bound_by = _bound(list(inputs), [
                o for o in outs if o.dim() > 0], flops, arith)
            line += (f"; bound {bound_ms:.4f} ms ({bound_by}), "
                     f"{bound_ms / ms:.0%} of it")
        if flat is not None:
            flat_ms = cuda_ms(flat, reps=REPS)
            line += f"; flat kernel {flat_ms:.4f} ms"
        if library is not None:
            lib_ms = _library_ms(library, outs[0], f"{key} {label}")
            line += ("; library call " + ("failed" if lib_ms is None
                                          else f"{lib_ms:.4f} ms"))
        if rec["ms"] is None:
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=lib_ms)
    print(line)


def _library_ms(library, out, what):
    """Time one PyTorch library call computing the same function (checked
    against the kernel's output first); None, with the reason printed, if
    the library cannot run it here."""
    import torch

    from tpufem_torch.utils.timing import cuda_ms

    try:
        fn = library()
        y = fn()
        torch.cuda.synchronize()
        err, bound = _err(y, out, str(out.dtype).replace("torch.", ""))
        print(f"# library call for {what}: max abs err vs the kernel "
              f"{err:.3e} (bound {bound:.3e})")
        return cuda_ms(fn, reps=REPS)
    except (RuntimeError, NotImplementedError) as exc:
        print(f"# library call for {what} failed: {type(exc).__name__}: "
              f"{str(exc).splitlines()[0][:200]}")
        return None
    finally:
        torch.cuda.empty_cache()


def _library_spmv(data, offsets, x):
    """() -> (() -> A x) through one torch sparse CSR product: A holds the
    stencil's rows with all K entries (columns outside [0, NS) clamped,
    with value 0), int32 indices, built once on the card."""
    import torch

    def make():
        n, k = data.shape[1], len(offsets)
        rows = torch.arange(n, device=data.device)
        cols = torch.empty((n, k), dtype=torch.int32, device=data.device)
        vals = torch.empty((n, k), dtype=data.dtype, device=data.device)
        # ascending offsets give ascending columns in every row
        for j, kk in enumerate(sorted(range(k), key=lambda i: offsets[i])):
            c = rows + offsets[kk]
            vals[:, j] = torch.where((c >= 0) & (c < n), data[kk], 0.0)
            cols[:, j] = c.clamp_(0, n - 1).to(torch.int32)
        del rows, c
        crow = torch.arange(0, n * k + 1, k, dtype=torch.int32,
                            device=data.device)
        A = torch.sparse_csr_tensor(crow, cols.view(-1), vals.view(-1),
                                    size=(n, n))
        return lambda: A @ x

    return make


def _stencil_flops(epilogue, k, with_dot=False):
    """Operations per row: K multiply-adds, and the epilogue's."""
    return 2 * k + {"matvec": 0, "residual": 1, "smooth": 4}[epilogue] + (
        2 if with_dot else 0)


# operations per element of the fused builds (geometry, the element
# stiffness once, the RHS quadrature), counted from the kernels' formulas:
# tetrahedron 60 + 60 + 4 points x 41 + 4; triangle 14 + 24 + 3 x 21 + 3
_ELEMENT_FLOPS = {3: 288, 2: 104}


def _arrays(system):
    A, b = system
    return A.data, b


def _rand_like_code(gen, code, dtype=None):
    """Random vector on the rows where ``code`` is nonzero (the nodes), 0
    on the padding."""
    import torch

    v = torch.randn(code.shape, generator=gen, device=code.device,
                    dtype=dtype or code.dtype)
    return torch.where(code != 0, v, 0.0)


def _check_general_levels(records, levels, n, timed, *, dims=""):
    """B4 (and, with bf16 data, its bf16 entries) on every general level."""
    import torch

    from tpufem_torch.ops.stencil_cuda import (stencil_fused_apply,
                                               stencil_fused_apply_plain)
    from tpufem_torch.solve import multigrid as mg

    gen = torch.Generator(device=levels[0].data.device).manual_seed(1)
    for dname, lvs in (("fp32", levels),
                       ("bf16", mg.cast_hierarchy(levels, torch.bfloat16))):
        for lv in lvs:
            nl = lv.plan.info.cell_grid[0]
            node = lv.data[lv.plan.offsets.index(0)]
            xs = _rand_like_code(gen, node, torch.float32)
            rs = _rand_like_code(gen, node, torch.float32)
            ii = lv.inv_diag
            k = lv.data.shape[0]
            rows = xs.numel()
            for label, ep, kw in (("smooth", "smooth", dict(inv_diag=ii)),
                                  ("smooth+dot", "smooth",
                                   dict(inv_diag=ii, with_dot=True)),
                                  ("residual", "residual", {})):
                if dname == "bf16" and ep == "residual":
                    continue
                args = (ep, lv.data, xs, lv.plan.offsets)
                ins = [lv.data, xs, rs] + ([ii] if "inv_diag" in kw else [])
                _compare(records, "B4",
                         f"{dims}n={n} level {nl} {dname} data {label}",
                         lambda: stencil_fused_apply(*args, b=rs, **kw),
                         lambda: stencil_fused_apply_plain(*args, b=rs,
                                                           **kw),
                         timed=timed and nl == n,
                         work=(ins, rows * _stencil_flops(
                             ep, k, kw.get("with_dot", False)), "float32"))


def _check_const_levels(records, levels, n, timed, *, dims=""):
    """B5 (all four epilogues) on every const level; a bf16 code plane
    must leave the sweep bit-identical."""
    import torch

    from tpufem_torch.ops.stencil_cuda import (const_stencil_apply,
                                               const_stencil_apply_plain)

    gen = torch.Generator(device=levels[0].code.device).manual_seed(2)
    for lv in levels:
        nl = lv.plan.info.cell_grid[0]
        xs, rs = (_rand_like_code(gen, lv.code),
                  _rand_like_code(gen, lv.code))
        k, rows = len(lv.weights), xs.numel()
        dt = str(xs.dtype).replace("torch.", "")
        for label, ep, kw in (("smooth", "smooth", dict(b=rs)),
                              ("smooth+dot", "smooth",
                               dict(b=rs, with_dot=True)),
                              ("matvec", "matvec", {}),
                              ("residual", "residual", dict(b=rs))):
            args = (ep, lv.weights, lv.code, xs, lv.plan.offsets)
            ins = [lv.code, xs] + ([rs] if "b" in kw else [])
            _compare(records, "B5", f"{dims}n={n} level {nl} {dt} {label} "
                                    f"(K={k})",
                     lambda: const_stencil_apply(*args, **kw),
                     lambda: const_stencil_apply_plain(*args, **kw),
                     timed=timed and nl == n,
                     work=(ins, rows * _stencil_flops(
                         ep, k, kw.get("with_dot", False)), dt))
        if xs.dtype != torch.float32:
            continue            # bf16 code runs under fp32 vectors only
        code16 = lv.code.to(torch.bfloat16)
        same = torch.equal(
            const_stencil_apply("smooth", lv.weights, code16, xs,
                                lv.plan.offsets, b=rs),
            const_stencil_apply("smooth", lv.weights, lv.code, xs,
                                lv.plan.offsets, b=rs))
        check(same, f"B5 {dims}n={n} level {nl}: a bf16 code plane changed "
                    "the sweep")


def _check_kernels(dev, records):
    """The 3D kernels of the first two slices: K1-K4, B4, B5."""
    import numpy as np
    import torch

    from tpufem_torch.fem.quadrature import tetrahedron_rule
    from tpufem_torch.ops.fused_system_cuda import (
        build_poisson_system, build_poisson_system_plain,
        node_coords_embedded_from_grid)
    from tpufem_torch.ops.stencil_cuda import (stencil_apply,
                                               stencil_apply_plain)
    from tpufem_torch.solve import multigrid as mg
    from tpufem_torch.solve.poisson import model_problem_3d_planes

    f, rule = model_problem_3d_planes(), tetrahedron_rule(2)
    gen = torch.Generator(device=dev).manual_seed(0)

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
                 timed=timed, work=([C], 6 * n ** 3 * _ELEMENT_FLOPS[3],
                                    "float32"))
        A, b = build_poisson_system(plan, C, f, rule)
        code = torch.as_tensor(mg._embed_grid_numpy(
            np.ones(info.node_grid), plan.store_grid), device=dev,
            dtype=torch.float32)
        x = _rand_like_code(gen, code)
        k, rows = plan.width, x.numel()
        _compare(records, "K2", f"n={n} fp32 matvec",
                 lambda: stencil_apply(A.data, x, plan.offsets),
                 lambda: stencil_apply_plain(A.data, x, plan.offsets),
                 timed=timed, work=([A.data, x],
                                    rows * _stencil_flops("matvec", k),
                                    "float32"),
                 library=_library_spmv(A.data, plan.offsets, x))
        _compare(records, "K2", f"n={n} fp32 matvec+dot",
                 lambda: stencil_apply(A.data, x, plan.offsets,
                                       with_dot=True),
                 lambda: stencil_apply_plain(A.data, x, plan.offsets,
                                             with_dot=True), timed=timed,
                 work=([A.data, x], rows * _stencil_flops("matvec", k, True),
                       "float32"))
        raw64 = mg._apply_bc_numpy(
            mg._uniform_stencil_data(plan, mg._uniform_cell_stiffness(
                DOMAIN, n)), plan.offsets,
            mg._embed_grid_numpy(bc, plan.store_grid, fill=False))
        d64 = torch.as_tensor(raw64, device=dev)
        x64 = x.double()
        _compare(records, "K2", f"n={n} fp64 matvec",
                 lambda: stencil_apply(d64, x64, plan.offsets),
                 lambda: stencil_apply_plain(d64, x64, plan.offsets),
                 timed=timed, work=([d64, x64],
                                    rows * _stencil_flops("matvec", k),
                                    "float64"))
        del d64, raw64

        # B4 on every level of the general hierarchy over the built
        # operator (top=), fp32 data, and bf16 data (its cast_hierarchy
        # copy) under fp32 vectors
        bc_mask = torch.as_tensor(mg._embed_grid_numpy(
            bc, plan.store_grid, fill=False), device=dev)
        general = mg.build_poisson_multigrid(DOMAIN, n, top=(A.data, bc_mask),
                                             device=dev, **depth)
        _check_general_levels(records, general, n, timed)
        del general

        levels = mg.build_poisson_multigrid(DOMAIN, n, operator="const",
                                            device=dev, **depth)
        _check_const_levels(records, levels, n, timed)
        _check_transfers(records, gen, levels, timed)


def _check_transfers(records, gen, levels, timed):
    """K3 and K4 (without and with the dot) on every const level pair."""
    from tpufem_torch.ops.mg_transfer_cuda import (
        const_prolong_add_smooth_embedded, const_prolong_add_smooth_plain,
        const_residual_restrict_embedded, const_residual_restrict_plain)

    for lf, lc in zip(levels[:-1], levels[1:]):
        nf, nc = lf.plan.info.cell_grid[0], lc.plan.info.cell_grid[0]
        r, e, ec = (_rand_like_code(gen, lf.code),
                    _rand_like_code(gen, lf.code),
                    _rand_like_code(gen, lc.code))
        rows_f = r.numel()
        a3 = (lf.weights, lf.code, lc.code, r, e, lf.plan, lc.plan)
        # residual (2K + 1) and the 15-point restriction stencil
        _compare(records, "K3", f"{nf}->{nc} fp32",
                 lambda: const_residual_restrict_embedded(*a3),
                 lambda: const_residual_restrict_plain(*a3), timed=timed,
                 work=([lf.code, lc.code, r, e],
                       rows_f * (_stencil_flops("residual", 15) + 15),
                       "float32"))
        a4 = (lf.weights, lf.code, ec, r, e, lf.plan, lc.plan)
        for wd in (False, True):
            # prolongation stencil, the add and the sweep
            _compare(records, "K4",
                     f"{nf}->{nc} fp32{' +dot' if wd else ''}",
                     lambda: const_prolong_add_smooth_embedded(
                         *a4, with_dot=wd),
                     lambda: const_prolong_add_smooth_plain(
                         *a4, with_dot=wd), timed=timed,
                     work=([lf.code, ec, r, e], rows_f * (
                         16 + _stencil_flops("smooth", 15, wd)),
                         "float32"))


def _check_2d(dev, records):
    """B7 at n=1024 and n=8 (fp32, fp64); B5 with 7 offsets on every 2D
    const level; K2 and B4 on every level of the 2D general hierarchy."""
    import numpy as np
    import torch

    from tpufem_torch.fem.quadrature import triangle_rule
    from tpufem_torch.ops.fused_system_cuda import (
        build_poisson_system, build_poisson_system_plain,
        node_coords_embedded_from_grid)
    from tpufem_torch.ops.stencil_cuda import (stencil_apply,
                                               stencil_apply_plain)
    from tpufem_torch.solve import multigrid as mg
    from tpufem_torch.solve.poisson import model_problem_2d_planes

    f, rule = model_problem_2d_planes(), triangle_rule(2)
    gen = torch.Generator(device=dev).manual_seed(3)
    for n in (N_2D, N_SMALL):
        info, coords, bc = mg._light_grid(DOMAIN, n, 2)
        plan = _plan(n, 2)
        for np_dt in (np.float32, np.float64):
            C = torch.as_tensor(node_coords_embedded_from_grid(
                coords, plan, np_dt), device=dev)
            dt = str(C.dtype).replace("torch.", "")
            for apply_bc in (True, False):
                _compare(records, "B7",
                         f"2D n={n} {dt}{'' if apply_bc else ' raw'}",
                         lambda: _arrays(build_poisson_system(
                             plan, C, f, rule, apply_bc=apply_bc)),
                         lambda: _arrays(build_poisson_system_plain(
                             plan, C, f, rule, apply_bc=apply_bc)),
                         timed=n == N_2D and apply_bc,
                         work=([C], 2 * n ** 2 * _ELEMENT_FLOPS[2], dt))
        # K2 on the fp32 operator (2d path) and on the fp64 one
        # (2d_dirichlet path)
        ops = {}
        for np_dt in (np.float32, np.float64):
            C = torch.as_tensor(node_coords_embedded_from_grid(
                coords, plan, np_dt), device=dev)
            A, _ = build_poisson_system(plan, C, f, rule)
            ops[np_dt] = A
            dt = str(C.dtype).replace("torch.", "")
            if np_dt == np.float32:
                x = _rand_like_code(gen, A.data[plan.offsets.index(0)])
            xv = x.to(C.dtype)
            for wd in (False, True):
                _compare(records, "K2", f"2D n={n} {dt} matvec"
                                        f"{'+dot' if wd else ''} (K=7)",
                         lambda: stencil_apply(A.data, xv, plan.offsets,
                                               with_dot=wd),
                         lambda: stencil_apply_plain(A.data, xv,
                                                     plan.offsets,
                                                     with_dot=wd),
                         timed=n == N_2D and np_dt == np.float32,
                         work=([A.data, xv], x.numel()
                               * _stencil_flops("matvec", 7, wd), dt))
        timed = n == N_2D
        A = ops[np.float32]
        bc_mask = torch.as_tensor(mg._embed_grid_numpy(
            bc, plan.store_grid, fill=False), device=dev)
        general = mg.build_poisson_multigrid(DOMAIN, n, 2,
                                             top=(A.data, bc_mask),
                                             device=dev)
        _check_general_levels(records, general, n, timed, dims="2D ")
        del general
        levels = mg.build_poisson_multigrid(DOMAIN, n, 2, operator="const",
                                            device=dev)
        if n == N_2D:
            check(len(levels) == 8 and levels[-1].coarse_inverse is not None
                  and levels[-1].coarse_inverse.shape == (81, 81),
                  "2D hierarchy: expected 8 levels with an 81-node dense "
                  "inverse")
        _check_const_levels(records, levels, n, timed, dims="2D ")
        levels = mg.build_poisson_multigrid(DOMAIN, n, 2, operator="const",
                                            dtype=torch.float64, device=dev)
        _check_const_levels(records, levels, n, False, dims="2D ")


def _blocked_cases(records, label, gen_level, con_level, x, b, timed,
                   data_dtypes):
    """B3's five and B5b's four epilogues on one 3D level pair, each through
    the routed wrappers' blocked call, against the plain version and the
    flat kernel on the same inputs."""
    import torch

    from tpufem_torch.ops import stencil_cuda as sc

    sg = gen_level.plan.store_grid
    offs = gen_level.plan.offsets
    k, rows = len(offs), x.numel()
    arith = str(x.dtype).replace("torch.", "")
    for ddt in data_dtypes:
        dname = str(ddt).replace("torch.", "")
        data = gen_level.data.to(ddt)
        inv_diag = gen_level.inv_diag.to(ddt)
        for ep, wd in (("matvec", False), ("matvec", True),
                       ("residual", False), ("smooth", False),
                       ("smooth", True)):
            kw = dict(with_dot=wd)
            ins = [data, x]
            if ep != "matvec":
                kw["b"] = b
                ins.append(b)
            if ep == "smooth":
                kw["inv_diag"] = inv_diag
                ins.append(inv_diag)
            if ep == "matvec":
                plain = lambda: sc.stencil_apply_plain(data, x, offs,
                                                       with_dot=wd)
                flat = lambda: sc.stencil_apply(data, x, offs, with_dot=wd)
            else:
                plain = lambda: sc.stencil_fused_apply_plain(ep, data, x,
                                                             offs, **kw)
                flat = lambda: sc.stencil_fused_apply(ep, data, x, offs,
                                                      **kw)
            lib = None
            if timed and ep == "matvec" and not wd and ddt == x.dtype:
                lib = _library_spmv(data, offs, x)
            _compare(records, "B3", f"{label} {dname} data {ep}"
                                    f"{'+dot' if wd else ''}",
                     lambda: sc.stencil_blocked_apply(ep, data, x, offs, sg,
                                                      **kw),
                     plain, flat=flat, timed=timed,
                     work=(ins, rows * _stencil_flops(ep, k, wd), arith),
                     library=lib)
        del data, inv_diag
        torch.cuda.empty_cache()
    con = con_level
    for ddt in data_dtypes:
        dname = str(ddt).replace("torch.", "")
        code = con.code.to(ddt)
        for ep, wd in (("smooth", False), ("smooth", True),
                       ("matvec", False), ("residual", False)):
            kw = dict(b=None if ep == "matvec" else b, with_dot=wd)
            args = (ep, con.weights, code, x, con.plan.offsets)
            ins = [code, x] + ([b] if ep != "matvec" else [])
            _compare(records, "B5b", f"{label} {dname} code {ep}"
                                     f"{'+dot' if wd else ''}",
                     lambda: sc.const_stencil_blocked_apply(
                         *args, con.plan.store_grid, **kw),
                     lambda: sc.const_stencil_apply_plain(*args, **kw),
                     flat=lambda: sc.const_stencil_apply(*args, **kw),
                     timed=timed,
                     work=(ins, rows * _stencil_flops(ep, 15, wd), arith))


def _check_scale(dev, records):
    """Every kernel at the n=384 shapes of the scale path: K1 against its
    plain version; B3 and B5b (all epilogues) on the finest level of the
    general and const hierarchies, fp32 and bf16 data, also against the
    flat kernels; B4 and B5 on level 192; K3 and K4 on 384->192->96."""
    import numpy as np
    import torch

    from tpufem_torch.fem.quadrature import tetrahedron_rule
    from tpufem_torch.ops import stencil_cuda as sc
    from tpufem_torch.ops.fused_system_cuda import (
        build_poisson_system, build_poisson_system_plain,
        node_coords_embedded_from_grid)
    from tpufem_torch.solve import multigrid as mg
    from tpufem_torch.solve.poisson import model_problem_3d_planes

    gen = torch.Generator(device=dev).manual_seed(4)
    f, rule = model_problem_3d_planes(), tetrahedron_rule(2)
    t0 = time.perf_counter()
    _, coords, bc = mg._light_grid(DOMAIN, N_SCALE)
    plan = _plan(N_SCALE)
    C = torch.as_tensor(node_coords_embedded_from_grid(
        coords, plan, np.float32), device=dev)
    del coords
    # K*NS = 1.18e9 rows of stencil data: every index product is 64-bit
    _compare(records, "K1", f"n={N_SCALE} fp32",
             lambda: _arrays(build_poisson_system(plan, C, f, rule)),
             lambda: _arrays(build_poisson_system_plain(plan, C, f, rule)))
    torch.cuda.empty_cache()
    A, _ = build_poisson_system(plan, C, f, rule)
    del C
    bc_mask = torch.as_tensor(mg._embed_grid_numpy(
        bc, plan.store_grid, fill=False), device=dev)
    general = mg.build_poisson_multigrid(DOMAIN, N_SCALE, top=(A.data,
                                                               bc_mask),
                                         device=dev)
    con = mg.build_poisson_multigrid(DOMAIN, N_SCALE, operator="const",
                                     device=dev)
    check(len(general) == len(con) == 7, "n=384: expected 7 levels")
    check(all(sc._needs_2d(tuple(plan.store_grid), w, e, 4)
              for w, e in ((15, 0), (15, 1), (15, 2), (3, 0), (3, 1))),
          "n=384: the reference's rule must route every call to B3 / B5b")
    check(not any(sc._needs_2d(tuple(lv.plan.store_grid), w, e, 4)
                  for lv in con[1:]
                  for w, e in ((15, 0), (15, 1), (15, 2), (3, 0), (3, 1))),
          "n=384: level 192 and below must take the flat kernels")
    x, b = _rand_like_code(gen, con[0].code), _rand_like_code(gen,
                                                              con[0].code)
    print(f"# scale checks: setup {time.perf_counter() - t0:.2f} s, store "
          f"grid {tuple(plan.store_grid)}")
    _blocked_cases(records, f"n={N_SCALE}", general[0], con[0], x, b, True,
                   (torch.float32, torch.bfloat16))
    del x, b
    torch.cuda.empty_cache()
    _check_general_levels(records, general[1:2], N_SCALE, False)
    _check_const_levels(records, con[1:2], N_SCALE, False)
    _check_transfers(records, gen, con[:3], False)
    del A, general, con, bc_mask
    torch.cuda.empty_cache()


def _check_routed(dev, records):
    """B3 and B5b at n=64 with the routing threshold at 0, through the
    routed wrappers, in fp32, bf16-under-fp32 and fp64."""
    import torch

    from tpufem_torch.ops import stencil_cuda as sc
    from tpufem_torch.solve import multigrid as mg

    gen = torch.Generator(device=dev).manual_seed(5)
    limit = sc._VMEM_1D_LIMIT
    sc._VMEM_1D_LIMIT = 0
    try:
        for vdt, ddts in ((torch.float32, (torch.float32, torch.bfloat16)),
                          (torch.float64, (torch.float64,))):
            gl = mg.build_poisson_multigrid(DOMAIN, N_ROUTED, dtype=vdt,
                                            levels=1, device=dev)[0]
            cl = mg.build_poisson_multigrid(DOMAIN, N_ROUTED, dtype=vdt,
                                            levels=1, operator="const",
                                            device=dev)[0]
            x, b = _rand_like_code(gen, cl.code), _rand_like_code(gen,
                                                                  cl.code)
            _blocked_cases(records, f"n={N_ROUTED} threshold 0", gl, cl, x,
                           b, False, ddts)
            before = (sc.stencil_blocked_apply.launches,
                      sc.const_stencil_blocked_apply.launches)
            sc.stencil_smooth_dot_embedded(gl.data, b, x, gl.inv_diag,
                                           gl.plan)
            sc.const_smooth_dot_embedded(cl.weights, cl.code, b, x, cl.plan)
            check((sc.stencil_blocked_apply.launches - before[0],
                   sc.const_stencil_blocked_apply.launches - before[1])
                  == (1, 1), "threshold 0: the routed wrappers did not "
                             "launch B3 / B5b")
    finally:
        sc._VMEM_1D_LIMIT = limit


def _run_path(name, counters, records, drive, must_launch):
    """Drive one path with every launch count at 0 just before it; read
    the counts just after, check that the path's kernels launched, and
    then run what ``drive`` returned (timing that must not count)."""
    import torch

    torch.cuda.synchronize()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    t0 = time.perf_counter()
    after = drive()
    torch.cuda.synchronize()
    launches = {key: getattr(fn, attr)
                for key, (fn, attr) in counters.items()}
    print(f"# {name} launches ({time.perf_counter() - t0:.1f} s): "
          + json.dumps(launches))
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


def _rel_err(u, ue):
    import torch

    return (torch.linalg.vector_norm(u.double() - ue)
            / torch.linalg.vector_norm(ue)).item()


def _relres(r, b):
    import torch

    return (torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b)).item()


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

    relres, rel_err = _relres, _rel_err
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
        its = _fp32_bf16_counts("general", levels, mv, mvd, b)
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

    _run_path("2d", counters, records, lambda: _drive_2d(dev),
              ("B7", "K2", "B4", "B5"))
    _run_path("2d_dirichlet", counters, records,
              lambda: _drive_2d_dirichlet(dev), ("B7", "K2", "B5"))
    _run_path("scale", counters, records, lambda: _drive_scale(dev),
              ("K1", "B3", "B5b", "K3", "K4", "B4"))


def _fp32_bf16_counts(name, levels, mv, mvd, b):
    """Guarded cg (check_every=1) to 1e-5 on a general hierarchy and on its
    bf16 cast: {"fp32": iterations, "bf16": iterations}."""
    import torch

    from tpufem_torch.solve import multigrid as mg
    from tpufem_torch.solve.cg import cg

    its = {}
    for dname, lv in (("fp32", levels),
                      ("bf16", mg.cast_hierarchy(levels, torch.bfloat16))):
        res = cg(mv, b, tol=1e-5, maxiter=60, check_every=1,
                 M=mg.mg_preconditioner(lv, nu1=1, nu2=1), matvec_dot=mvd,
                 M_dot=mg.mg_preconditioner(lv, nu1=1, nu2=1,
                                            with_dot=True))
        its[dname] = res.iterations
        print(f"# {name} guarded cg, {dname} hierarchy: {res.iterations} "
              f"iterations, relres {res.residual_norm.item():.3e}")
        check(res.converged, f"{name} {dname}: not converged")
    return its


def _drive_2d(dev):
    """solve_poisson_fast(dim=2) at n=1024, const and general; the general
    hierarchy over B7's operator in fp32 and bf16."""
    import numpy as np
    import torch

    from tpufem_torch.fem.quadrature import triangle_rule
    from tpufem_torch.ops.fused_system_cuda import (
        build_poisson_system, node_coords_embedded_from_grid)
    from tpufem_torch.ops.stencil_cuda import (stencil_matvec_dot_embedded,
                                               stencil_matvec_embedded)
    from tpufem_torch.solve import multigrid as mg
    from tpufem_torch.solve.cg import cg_fixed
    from tpufem_torch.solve.poisson import (model_problem_2d,
                                            model_problem_2d_planes)
    from tpufem_torch.solve.structured_fast import solve_poisson_fast

    n, f = N_2D, model_problem_2d_planes()
    _, coords, bc = mg._light_grid(DOMAIN, n, 2)
    ue = torch.as_tensor(model_problem_2d()[1](coords.reshape(2, -1).T),
                         device=dev)
    for precond in ("const", "general"):
        t0 = time.perf_counter()
        sol = solve_poisson_fast(DOMAIN, n, f, dim=2, tol=1e-5,
                                 precond=precond, device=dev)
        wall = time.perf_counter() - t0
        err = _rel_err(sol.u, ue)
        print(f"# 2d {precond} guarded solve: {sol.cg.iterations} "
              f"iterations, relres {sol.cg.residual_norm.item():.3e}, rel "
              f"L2 error {err:.4e}, DOFs {sol.num_dofs}, phases "
              f"{sol.phases_s}, wall {wall:.4f} s")
        check(sol.num_dofs == (n + 1) ** 2, "2d: DOF count")
        check(sol.cg.converged and sol.cg.iterations <= 8,
              f"2d {precond}: {sol.cg.iterations} iterations")
        check(err <= 2.2e-3, f"2d {precond}: rel L2 error {err:.3e}")

    plan = _plan(n, 2)
    C = torch.as_tensor(node_coords_embedded_from_grid(
        coords, plan, np.float32), device=dev)
    A, b = build_poisson_system(plan, C, f, triangle_rule(2))
    mv = lambda v: stencil_matvec_embedded(A.data, v, plan)
    mvd = lambda v: stencil_matvec_dot_embedded(A.data, v, plan)
    bc_mask = torch.as_tensor(mg._embed_grid_numpy(
        bc, plan.store_grid, fill=False), device=dev)
    general = mg.build_poisson_multigrid(DOMAIN, n, 2, top=(A.data, bc_mask),
                                         device=dev)
    its = _fp32_bf16_counts("2d general", general, mv, mvd, b)
    check(its["bf16"] <= its["fp32"] + 2,
          f"2d: bf16 {its['bf16']} > fp32 {its['fp32']} + 2")
    levels = mg.build_poisson_multigrid(DOMAIN, n, 2, operator="const",
                                        device=dev)
    M = mg.mg_preconditioner(levels, nu1=1, nu2=1)
    M_dot = mg.mg_preconditioner(levels, nu1=1, nu2=1, with_dot=True)

    def pcg10():
        return cg_fixed(mv, b, 10, M=M, matvec_dot=mvd, M_dot=M_dot)

    _, r = pcg10()
    print(f"# 2d pcg: 10 iterations relres {_relres(r, b):.3e}")
    return lambda: _per_iteration("2d", pcg10)


def _drive_2d_dirichlet(dev):
    """f = 0, g = 1 + 2x - 3y on the 2D box at n=1024 in fp64: P1
    reproduces the harmonic g."""
    import torch

    from tpufem_torch.solve import multigrid as mg
    from tpufem_torch.solve.structured_fast import solve_poisson_fast

    def g(x, y):
        return 1.0 + 2.0 * x - 3.0 * y

    t0 = time.perf_counter()
    sol = solve_poisson_fast(DOMAIN, N_2D, _rhs_2d_zero(), dim=2, g=g,
                             tol=1e-11, maxiter=200, dtype=torch.float64,
                             device=dev)
    wall = time.perf_counter() - t0
    _, coords, _ = mg._light_grid(DOMAIN, N_2D, 2)
    err = (sol.u - torch.as_tensor(g(*coords).reshape(-1),
                                   device=dev)).abs().max().item()
    print(f"# 2d_dirichlet solve (fp64): {sol.cg.iterations} iterations, "
          f"relres {sol.cg.residual_norm.item():.3e}, max error vs g "
          f"{err:.3e}, phases {sol.phases_s}, wall {wall:.4f} s")
    check(sol.cg.converged and err < 1e-8,
          f"2d_dirichlet: max error {err:.3e}, converged {sol.cg.converged}")


def _drive_scale(dev):
    """n=384 through the entry point: solve_poisson_fast with the const
    hierarchy and with precond="general", each with its phases, wall and
    peak device memory; then, composed by hand on one fused build, the
    const hierarchy with nu1 = nu2 = 2 (the entry runs nu = 1) and the
    10-iteration run that the per-iteration times read."""
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
    from tpufem_torch.solve.structured_fast import solve_poisson_fast

    n, f = N_SCALE, model_problem_3d_planes()
    t0 = time.perf_counter()
    _, coords, _ = mg._light_grid(DOMAIN, n)
    ue = torch.as_tensor(model_problem_3d()[1](coords.reshape(3, -1).T),
                         device=dev)
    del coords
    print(f"# scale exact solution on the host: "
          f"{time.perf_counter() - t0:.4f} s")
    for precond, limit in (("const", 12), ("general", 16)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sol = solve_poisson_fast(DOMAIN, n, f, tol=1e-5, precond=precond,
                                 device=dev)
        wall = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        err = _rel_err(sol.u, ue)
        print(f"# scale {precond} solve_poisson_fast: {sol.cg.iterations} "
              f"iterations, relres {sol.cg.residual_norm.item():.3e}, rel "
              f"L2 error {err:.4e} (TPU reference at n=384: 12 iterations, "
              f"1.1e-5), DOFs {sol.num_dofs}, phases {sol.phases_s}, wall "
              f"{wall:.4f} s, peak device memory {peak_gb:.3f} GB "
              f"(torch.cuda.max_memory_allocated)")
        check(sol.num_dofs == (n + 1) ** 3, "scale: DOF count")
        check(sol.cg.converged and sol.cg.iterations <= limit,
              f"scale {precond}: {sol.cg.iterations} iterations > {limit}")
        check(err <= 2.0e-4, f"scale {precond}: rel L2 error {err:.3e} > "
                             "2.0e-4")
        del sol
    del ue
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    _, coords, _ = mg._light_grid(DOMAIN, n)
    plan = _plan(n)
    C = torch.as_tensor(node_coords_embedded_from_grid(
        coords, plan, np.float32), device=dev)
    del coords
    A, b = build_poisson_system(plan, C, f, tetrahedron_rule(2))
    del C
    levels = mg.build_poisson_multigrid(DOMAIN, n, dtype=torch.float32,
                                        operator="const", device=dev)
    torch.cuda.synchronize()
    print(f"# scale build and const hierarchy by hand: "
          f"{time.perf_counter() - t0:.4f} s")
    mv = lambda v: stencil_matvec_embedded(A.data, v, plan)
    mvd = lambda v: stencil_matvec_dot_embedded(A.data, v, plan)
    res = cg(mv, b, tol=1e-5, maxiter=60, check_every=1,
             M=mg.mg_preconditioner(levels), matvec_dot=mvd,
             M_dot=mg.mg_preconditioner(levels, with_dot=True))
    print(f"# scale const nu1 = nu2 = 2: {res.iterations} iterations, "
          f"relres {res.residual_norm.item():.3e}")
    check(res.converged and res.iterations <= 12,
          f"scale nu2: {res.iterations} iterations > 12")
    del res
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(f"# scale host peak RSS of the process {rss_gb:.2f} GB (getrusage)")
    M = mg.mg_preconditioner(levels, nu1=1, nu2=1)
    M_dot = mg.mg_preconditioner(levels, nu1=1, nu2=1, with_dot=True)

    def pcg10():
        return cg_fixed(mv, b, 10, M=M, matvec_dot=mvd, M_dot=M_dot)

    return lambda: _per_iteration("scale", pcg10)


if __name__ == "__main__":
    sys.exit(main())
