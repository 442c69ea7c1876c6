"""Generic (indexed-sparse) assembly at 20M triangles, as
examples/generic_assembly_20m.py: the deduplicating scatter path on the
10000 x 1000 rectangle (10,011,001 nodes), the element batch streamed
through device-side chunks so that peak device memory stays bounded.

Two reductions of the chunks' local matrices into the ELL values:
  * "scatter": the flat slot indices through ``assemble.dense.accumulate``
    (sorted ``index_put_``, deterministic: never float atomics);
  * "sort": each chunk's entries sorted by slot on the host at plan time,
    then a device gather and a sorted segment sum.
An emit-only phase times what the reference's CUDA kernel at this scale
does (the element kernels and the raw values out, no reduction).

Golden checks: both reductions assemble the same operator (within 1e-4
of max |a|), and its rows sum to zero (the pure-Neumann stiffness
annihilates constants): max |row sum| / max |a| < 1e-5.  Fractions of
the memory rate are of the NVIDIA H100 SXM's 3.35 TB/s.  No hand-written
kernel runs here.

    python -m tpufem_torch.examples.generic_assembly_20m [--nx 10000 --ny 1000]
    python -m tpufem_torch.examples.generic_assembly_20m --nx 40 --ny 20 --device cpu
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from tpufem_torch.assemble.dense import accumulate
from tpufem_torch.assemble.local import p1_stiffness
from tpufem_torch.examples._common import add_device_arg, device_of, sync
from tpufem_torch.fem.elements import P1Triangle
from tpufem_torch.mesh.adjacency import ell_pattern
from tpufem_torch.mesh.rectangle import rectangle_mesh
from tpufem_torch.ops.reduction import segment_reduce

HBM_GBS = 3350.0        # NVIDIA H100 SXM HBM3 (data sheet)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=10000)
    ap.add_argument("--ny", type=int, default=1000)
    ap.add_argument("--chunks", type=int, default=8,
                    help="element-batch streaming chunks")
    ap.add_argument("--method", choices=["scatter", "sort", "both"],
                    default="both",
                    help="scatter = flat sorted accumulation; sort = "
                    "plan-time chunk-local slot sort + device gather + "
                    "sorted segment sum")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_of(args)

    t0 = time.perf_counter()
    mesh = rectangle_mesh(-3.0, 3.0, -3.0, 3.0, args.ny, args.nx)
    t_mesh = time.perf_counter() - t0
    ne, nn = mesh.num_elements, mesh.num_nodes
    print(f"# mesh: {ne} elements, {nn} nodes ({t_mesh:.1f}s)",
          file=sys.stderr)

    t0 = time.perf_counter()
    pat = ell_pattern(mesh.conn, nn, pad_to=8, with_sort_plan=False)
    t_pat = time.perf_counter() - t0
    K = pat.cols.shape[1]
    print(f"# pattern: width {K}, nnz {pat.nnz} ({t_pat:.1f}s)",
          file=sys.stderr)

    element = P1Triangle()
    ecoords = mesh.element_coords()                    # [NE, 3, 2] host
    slots = pat.slots.reshape(ne, 9)

    nc = args.chunks
    csz = -(-ne // nc)
    pad = nc * csz - ne
    if pad:
        # pad with repeats of the last element, their slots redirected to
        # a dummy tail slot
        ecoords = np.concatenate([ecoords, np.repeat(
            ecoords[-1:], pad, axis=0)])
        slots = np.concatenate(
            [slots, np.full((pad, 9), nn * K, np.int32)])
    flat_size = nn * K + 1                              # +1 dummy slot

    def add_chunk(flat, ec, sl):
        Ke = p1_stiffness(ec, element)                  # [C, 3, 3]
        return flat + accumulate(flat_size, sl.reshape(-1).long(),
                                 Ke.reshape(-1))

    # slot-sorted variant: the chunk's 9C entries sorted by target slot on
    # the host at plan time; the device gathers and sums sorted segments
    def add_chunk_sorted(flat, ec, perm, seg):
        Ke = p1_stiffness(ec, element).reshape(-1)
        return flat + segment_reduce(Ke[perm.long()], seg, flat_size,
                                     indices_are_sorted=True)

    t0 = time.perf_counter()
    plans = []
    if args.method in ("sort", "both"):
        for c in range(nc):
            sl = slots[c * csz:(c + 1) * csz].reshape(-1)
            p = np.argsort(sl, kind="stable")
            plans.append((p.astype(np.int32), sl[p]))
    t_plan = time.perf_counter() - t0

    def chunk_coords(c):
        return torch.as_tensor(ecoords[c * csz:(c + 1) * csz],
                               dtype=torch.float32, device=dev)

    def assemble_once(method):
        flat = torch.zeros(flat_size, dtype=torch.float32, device=dev)
        for c in range(nc):
            ec = chunk_coords(c)
            if method == "sort":
                pm, sg = plans[c]
                flat = add_chunk_sorted(
                    flat, ec, torch.as_tensor(pm, device=dev),
                    torch.as_tensor(sg, device=dev).long())
            else:
                sl = torch.as_tensor(slots[c * csz:(c + 1) * csz],
                                     device=dev)
                flat = add_chunk(flat, ec, sl)
        sync(dev)
        return flat

    prim = "sort" if args.method == "sort" else "scatter"
    t0 = time.perf_counter()
    flat = assemble_once(prim)                          # first pass
    t_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    flat = assemble_once(prim)                          # steady state
    t_asm = time.perf_counter() - t0

    t_sort = None
    dmax = None
    if args.method == "both":
        flat_s = assemble_once("sort")
        # golden: both reductions assemble the same operator
        dmax = float((flat_s - flat).abs().max())
        assert dmax <= 1e-4 * float(flat.abs().max()), dmax
        del flat_s
        t0 = time.perf_counter()
        assemble_once("sort")
        t_sort = time.perf_counter() - t0

    # the reference's own phase at this scale: element kernels and the
    # raw values out, no duplicate reduction
    ecs = [chunk_coords(c) for c in range(nc)]
    sync(dev)

    def emit_once():
        outs = [p1_stiffness(ec, element) for ec in ecs]
        sync(dev)
        return outs

    emit_once()
    samples = []
    for _ in range(3):
        t0 = time.perf_counter()
        emit_once()
        samples.append(time.perf_counter() - t0)
    t_emit = min(samples)
    emit_bytes = ne * (6 + 9) * 4                       # coords in, Ke out
    # a reading under the memory-rate floor is a timing artifact
    emit_floor = emit_bytes / (HBM_GBS * 1e9)
    emit_valid = t_emit >= emit_floor
    del ecs

    data = flat[:-1].reshape(nn, K)
    # golden: the stiffness rows sum to 0
    row_sum = data.sum(dim=1).abs().max()
    scale = data.abs().max()
    rel = float(row_sum) / float(scale)

    # memory traffic estimate: coords in + slots in + values scattered
    bytes_moved = ne * (6 * 4 + 9 * 4 + 9 * 4)
    out = {
        "metric": "generic_scatter_assembly_20m",
        "elements": ne,
        "rows": nn,
        "ell_width": K,
        "chunks": nc,
        "assemble_s": round(t_asm, 3),
        "elements_per_sec": round(ne / t_asm, 0),
        "effective_gbs": round(bytes_moved / t_asm / 1e9, 1),
        "hbm_sol_fraction": round(bytes_moved / t_asm / 1e9 / HBM_GBS, 3),
        "sort_assemble_s": round(t_sort, 3) if t_sort is not None else None,
        "sort_elements_per_sec": (round(ne / t_sort, 0)
                                  if t_sort is not None else None),
        "emit_only_s": round(t_emit, 3),
        "emit_samples_s": [round(s, 3) for s in samples],
        "emit_valid": emit_valid,
        "emit_elements_per_sec": round(ne / t_emit, 0),
        "emit_hbm_sol_fraction": round(
            emit_bytes / t_emit / 1e9 / HBM_GBS, 3),
        "max_rel_row_sum": rel,
        "walls_s": {"mesh": round(t_mesh, 1), "pattern": round(t_pat, 1),
                    "sort_plan": round(t_plan, 1),
                    "first_pass": round(t_wall, 1)},
        "peak_device_bytes_est": int(flat_size * 4 + csz * (6 + 9 + 9) * 4),
    }
    print(json.dumps(out))
    assert rel < 1e-5, f"row-sum golden check failed: {rel}"
    return {**out, "max_abs_diff_sort_scatter": dmax, "data": data}


if __name__ == "__main__":
    main()
