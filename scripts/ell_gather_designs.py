"""Time B9g (the ELL SpMV on absolute columns, row-major data / cols [N,
K]) of this checkout in each of its designs on one NVIDIA GPU:

    python scripts/ell_gather_designs.py

at chip_smoke.py's random banded matrix (1,002,001 rows, K = 8, fp32),
the quad_hex path's hex fine operator (100^3 Q1, 1,030,301 rows, K = 32,
fp64; built by chip_smoke.py's own setup) and the p2_tet_robin path's
fine operator at n = 50 (1,030,301 rows, K = 80, fp64; assembled and
RCM-ordered as chip_smoke.py does, without its hierarchy).  Designs,
forced through ``ell_gather_tiling``: a thread a row on the rows as they
are (0, 0), staged in chunks of c slots (0, c), and 4 or 8 lanes a row
(-4, 0), (-8, 0); ``ell_gather_tiling``'s pick printed beside.  Each
output is held bit for bit to ``ell_gather_matvec_plain``; each time is
the median of 20 launches with CUDA events (the stream queued ahead),
beside the bound on the bytes the nonzeros need, the bound on every
slot's value and the nonzeros' columns (the form has no row lengths, so
it reads every value) and a torch.sparse CSR product of the nonzeros.  Prints the card's name and power limit, one
line per shape, and last one JSON object of them.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

HBM = 3.35e12
DESIGNS = ((0, 0), (0, 16), (0, 32), (-4, 0), (-8, 0))


def _p2_tet_fine(cs, dev):
    """The p2_tet_robin path's fine operator at n = 50, RCM-ordered (its
    AMG setup left out): (data, cols) on the card."""
    import torch

    from tpufem_torch.fem.space import FunctionSpace
    from tpufem_torch.forms.language import Coefficient, dot, grad
    from tpufem_torch.forms.weakform import WeakForm
    from tpufem_torch.mesh.adjacency import ell_pattern, reverse_cuthill_mckee
    from tpufem_torch.mesh.box import box_mesh
    from tpufem_torch.solve.poisson import model_problem_3d
    from tpufem_torch.sparse.ell import reorder_ell

    n = cs.N_P2_TET
    V = FunctionSpace(box_mesh(-3, 3, -3, 3, -3, 3, n, n, n), degree=2)
    pat = ell_pattern(V.dof_conn, V.num_dofs, pad_to=16,
                      with_sort_plan=False)
    wf = WeakForm(V, device=dev).build(
        lambda u, v: dot(grad(u), grad(v)),
        lambda v: Coefficient(model_problem_3d()[0]) * v)
    wf.build_boundary(lhs=lambda u, v: u * v,
                      rhs=lambda v: Coefficient(cs._robin_data) * v)
    A, _ = wf.assemble(format="ell", pattern=pat)
    perm = reverse_cuthill_mckee(A.cols.cpu().numpy())
    data, cols = reorder_ell(A.data, A.cols, perm)
    return (torch.as_tensor(data, device=dev),
            torch.as_tensor(cols, device=dev))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ell_gather_designs: no CUDA device", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from tpufem_torch.mesh.box import box_hex_mesh
    from tpufem_torch.sparse import ell_cuda as ec
    from tpufem_torch.utils.timing import cuda_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(6)
    n, k, band = cs.ELL_ROWS, cs.ELL_SLOTS, cs.ELL_BANDWIDTH
    rcols = (torch.arange(n, device=dev)[:, None] + torch.randint(
        -band, band + 1, (n, k), generator=g, device=dev)).clamp_(
        0, n - 1).to(torch.int32)
    shapes = {"random 1M K=8 fp32": (torch.randn((n, k), generator=g,
                                                 device=dev), rcols)}
    A_hex = cs._solve_capturing_amg(box_hex_mesh(
        -3, 3, -3, 3, -3, 3, cs.N_HEX, cs.N_HEX, cs.N_HEX), dev)[1]
    shapes["hex fine A K=32 fp64"] = (A_hex.data, A_hex.cols)
    shapes["p2_tet fine A K=80 fp64"] = _p2_tet_fine(cs, dev)
    real = ec.ell_gather_tiling
    out = {}
    for label, (data, cols) in shapes.items():
        rows, K = data.shape
        item = data.element_size()
        x = torch.randn(rows, generator=g, device=dev, dtype=data.dtype)
        ref = ec.ell_gather_matvec_plain(data, cols, x)
        nnz = int((data != 0).sum())
        row = {"picked": list(real(item, K, rows)),
               "needed_bound_ms": (nnz * (item + 4) + 2 * rows * item)
               / HBM * 1e3,
               "padded_bound_ms": (rows * K * item + nnz * 4
                                   + 2 * rows * item) / HBM * 1e3,
               "csr_ms": cuda_ms(cs._library_ell(data, cols, x,
                                                 nonzeros=True)(), reps=20)}
        for d in DESIGNS:
            if d[1] > K:
                continue
            ec.ell_gather_tiling = lambda *a, d=d: d
            try:
                fn = lambda: ec.ell_gather_matvec_cuda(data, cols, x)
                y = fn()
                torch.cuda.synchronize()
                row[f"{d[0]},{d[1]}"] = dict(
                    ms=cuda_ms(fn, reps=20), equal=bool(torch.equal(y, ref)))
            except RuntimeError as exc:
                row[f"{d[0]},{d[1]}"] = dict(error=str(exc)[:200])
            finally:
                ec.ell_gather_tiling = real
        out[label] = row
        print(f"# {label}: " + json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps(out))
    ok = all(v.get("equal", False) for r in out.values()
             for key, v in r.items() if isinstance(v, dict))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
