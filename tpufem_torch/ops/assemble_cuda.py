"""Fused P1 stiffness assembly on structured Kuhn-tetrahedron grids: kernel
B13 (csrc/assemble.cu), the counterpart of tpufem/ops/assemble_pallas.py.

``element_coords_bt_embedded`` lays the element coordinates out on the
plan's store grid, ``assemble_stencil_cuda`` turns them into the embedded
stencil planes of the P1 Poisson stiffness (no RHS, no boundary
elimination) and counts its launches in ``assemble_stencil_cuda.launches``;
``assemble_stencil_plain`` is its plain PyTorch version (element planes on
the cell grid, slice-added into the stencil planes), which the wrapper runs
for a CPU tensor.  B13 equals it bit for bit on the card.

B13 computes each tetrahedron once per tile of ``assemble_tiling``'s
(``tx`` store columns by ``ty`` rows, marching over ``tz`` planes) and
adds each row's terms in the plain version's (t, a, b) order: the
generated header (``tables_header``) lists which of a row's za = 1 terms
(cells one plane below) are summed in the step that reads them and which
are carried to the next step as values.

The Pallas kernel's ``block_lead`` (its z-block height in VMEM) has no
counterpart: one CUDA launch covers the whole store grid.  The argument is
kept in its position so that a call written for the reference binds
``dtype`` the same way.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tpufem_torch.assemble.planar import element_coords_bt, p1_stiffness_bt
from tpufem_torch.assemble.structured import (StructuredPlan,
                                              assemble_stencil_structured_bt)
from tpufem_torch.ops._build import check_launch, load_library, stream_handle
from tpufem_torch.sparse.stencil import StencilMatrix

__all__ = ["element_coords_bt_embedded", "assemble_stencil_cuda",
           "assemble_stencil_plain", "assemble_tiling", "assemble_smem",
           "check_assemble_tile", "ASSEMBLE_TILES"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SUFFIX = {torch.float32: "_f32", torch.float64: "_f64"}
# X, data, S0, S1, S2, m0, m1, m2, tx, ty, tz, stream
_SIGNATURES = {"tpufem_assemble_stencil" + sfx: (_P, _P) + (_I,) * 9 + (_P,)
               for sfx in _SUFFIX.values()}
_SIGNATURES["tpufem_assemble_smem"] = (_I,) * 3

# -- B13 tiles (csrc/assemble.cu) ----------------------------------------------
# A block of tx x ty threads owns tx store columns by ty rows, one column a
# thread, and marches over tz planes.
ASSEMBLE_TILES = ((64, 4), (32, 4))    # (tx, ty) the launcher has kernels for
# per item size, the tile sweep's pick (scripts/fused_build_ab.py --tiles;
# 32 x 8 and 128 x 2 measured slower in both types, PERF.md): 64 x 4 fp32
# (2 blocks an SM), 32 x 4 fp64 (2 blocks an SM, not 1)
_TILE = {4: (64, 4), 8: (32, 4)}
_SMS = 132                      # H100 SXM
_SMEM_PER_SM = 233472           # bytes, 1 KB of it reserved per block
_SMEM_PER_BLOCK = 232448        # bytes a block may use
_MAX_PLANES = 64
_ENTRIES = 10                   # the upper triangle of a 4 x 4 stiffness
_TYPES = 6                      # Kuhn tetrahedra a cell


def assemble_smem(itemsize: int, tx: int, ty: int) -> int:
    """Dynamic shared memory (bytes) of a B13 block of ``tx`` columns by
    ``ty`` rows (csrc/assemble.cu's Tile::kSmem): the 10 stiffness entries
    of each of the 6 types of each of the (ty + 1) x (tx + 1) cells."""
    return _TYPES * _ENTRIES * (ty + 1) * (tx + 1) * itemsize


def _blocks_per_sm(itemsize: int, tx: int, ty: int) -> int:
    """Blocks of a tile an SM runs at once: the kernel's launch bounds
    (512 fp32 or 256 fp64 threads' registers), or fewer by shared
    memory."""
    bounds = max(1, (512 if itemsize == 4 else 256) // (tx * ty))
    return min(bounds,
               _SMEM_PER_SM // (assemble_smem(itemsize, tx, ty) + 1024))


@functools.lru_cache(maxsize=None)
def assemble_tiling(itemsize: int, store_grid: tuple):
    """(tx, ty, tz, shared memory bytes, grid) of one B13 launch on a store
    grid (S0, S1, S2).

    A block owns ``tx`` columns by ``ty`` rows (per item size, from the
    tile sweep) and marches over ``tz`` planes, its first step a warm-up
    cell plane, which reloads all 72 coordinate planes of a cell plane.  A
    launch takes about (waves of blocks) x (tz + 1) steps, the slots of a
    wave being the blocks the card holds at once (132 SMs x blocks per
    SM): tz is the march within 1 .. 64 that minimises it, the longest of
    equals.  (The tile sweep: a march of 21 planes in one wave beat 6
    planes in four, the sqrt(2 W) of K1's fused_tiling.)  The grid is
    (columns, rows, planes) of tiles."""
    s0, s1, s2 = (int(v) for v in store_grid)
    tx, ty = _TILE[itemsize]
    if s2 % tx or min(s0, s1, s2) < 1:
        raise ValueError(f"store grid {tuple(store_grid)}: rows of "
                         f"{tx}-column tiles")
    cols = (s2 // tx) * -(-s1 // ty)
    slots = _SMS * _blocks_per_sm(itemsize, tx, ty)
    tz = min(range(1, min(_MAX_PLANES, s0) + 1),
             key=lambda t: (-(-cols * -(-s0 // t) // slots) * (t + 1), -t))
    return (tx, ty, tz, assemble_smem(itemsize, tx, ty),
            (s2 // tx, -(-s1 // ty), -(-s0 // tz)))


def check_assemble_tile(itemsize: int, tx: int, ty: int, tz: int) -> None:
    """Raise ValueError unless (tx columns, ty rows, tz planes) is a tile
    the launcher has a kernel for and its block fits the card's shared
    memory (the C launcher refuses the same tiles)."""
    if (tx, ty) not in ASSEMBLE_TILES or tz < 1:
        raise ValueError(f"B13: tile ({tx} columns, {ty} rows, {tz} "
                         f"planes): the kernels are {ASSEMBLE_TILES} "
                         "(columns, rows) with tz >= 1")
    if assemble_smem(itemsize, tx, ty) > _SMEM_PER_BLOCK:
        raise ValueError(f"B13: tile ({tx}, {ty}) needs "
                         f"{assemble_smem(itemsize, tx, ty)} B of shared "
                         f"memory a block, more than {_SMEM_PER_BLOCK}")


def element_coords_bt_embedded(mesh, plan: StructuredPlan, block_lead=None,
                               dtype=np.float32) -> np.ndarray:
    """[T, npe, dim, *store_grid] element coordinates (host numpy): cell
    (cz, cy, cx) at (cz, cy + 1, cx + 1); padding cells hold a unit simplex
    (node n at e_n), so their geometry is finite.  ``block_lead`` is the
    TPU kernel's z block: if given it must divide the store grid's leading
    axis, as the reference demands; it changes nothing here."""
    sg = plan.store_grid
    if block_lead is not None and sg[0] % block_lead:
        raise ValueError("store leading dim not divisible by block_lead")
    cg = plan.info.cell_grid
    X = element_coords_bt(mesh, dtype)            # [T, npe, dim, *cell_grid]
    T, npe, dim = X.shape[:3]
    out = np.zeros((T, npe, dim) + tuple(sg), dtype)
    for n in range(npe):
        for d in range(dim):
            out[:, n, d] = 1.0 if n == d else 0.0
    cells = (slice(0, cg[0]),) + tuple(slice(1, 1 + c) for c in cg[1:])
    out[(slice(None),) * 3 + cells] = X
    return out


def _check(plan: StructuredPlan, X_emb: torch.Tensor) -> None:
    if not plan.embedded:
        raise ValueError("plan must be built with structured_plan(embed=True)")
    info = plan.info
    if len(info.node_grid) != 3 or info.type_node_offsets.shape[1] != 4:
        raise NotImplementedError("fused assembly kernel is 3D-only (P1 "
                                  "tetrahedra)")
    want = (info.num_types, 4, 3) + tuple(plan.store_grid)
    if tuple(X_emb.shape) != want:
        raise ValueError(f"B13: X_emb {tuple(X_emb.shape)}, the plan's is "
                         f"{want} (element_coords_bt_embedded)")


def march_terms(plan: StructuredPlan):
    """(early, late, carried): B13's node phase in the plain version's
    (t, a, b) order.

    A row's term (t, a, b) comes from the cell (za, ya, xa) before it
    (``entry_shift`` less 1) and adds into slot k.  ``early``: the za = 1
    terms, which reach the row one step before its za = 0 ones, in
    (t, a, b) order, each ``(t, a, b, ya, xa, k, i)``: i = -1 adds it to
    slot k's prefix sum (it precedes every za = 0 term of slot k), else
    it is kept as carried value i.  ``late``: the terms added after the
    prefix sums, in (t, a, b) order, each ``(t, a, b, ya, xa, k, i)``: a
    za = 0 term (i = -1) or carried value i.  ``carried``: how many
    values a thread keeps from a step to the next."""
    info = plan.info
    shift = plan.entry_shift[:, :, 0] - 1          # [T, a, (z, y, x)]
    if shift.min() < 0 or shift.max() > 1:
        raise NotImplementedError("B13: cells one step before the row")
    started = set()                                # slots with a za = 0 term
    early, late = [], []
    for t in range(info.num_types):
        for a in range(4):
            za, ya, xa = (int(v) for v in shift[t, a])
            for b in range(4):
                k = int(plan.entry_k[t, a, b])
                if za == 0:
                    started.add(k)
                    late.append((t, a, b, ya, xa, k, -1))
                elif k not in started:
                    early.append((t, a, b, ya, xa, k, -1))
                else:
                    i = sum(e[6] >= 0 for e in early)
                    early.append((t, a, b, ya, xa, k, i))
                    late.append((t, a, b, ya, xa, k, i))
    return early, late, sum(e[6] >= 0 for e in early)


def tables_header(plan: StructuredPlan) -> str:
    """Generated header of B13: the node phase's terms (``march_terms``)
    as macro lists, in csrc/assemble.cu's argument order: early S(t, a,
    b, ya, xa, k) and C(t, a, b, ya, xa, i), late S(t, a, b, ya, xa, k)
    and C(t, a, b, ya, xa, k, i)."""
    early, late, carried = march_terms(plan)

    def call(args):
        return "(" + ", ".join(str(int(v)) for v in args) + ")"

    lines = ["// generated by tpufem_torch.ops.assemble_cuda", "#pragma once",
             f"#define TPUFEM_ASM_K {plan.width}",
             f"#define TPUFEM_ASM_TYPES {plan.info.num_types}",
             f"#define TPUFEM_ASM_CARRIED {carried}"]
    lines.append("#define TPUFEM_ASM_FOR_EARLY(S, C) " + " ".join(
        ("S" + call(e[:6])) if e[6] < 0 else ("C" + call(e[:5] + e[6:]))
        for e in early))
    lines.append("#define TPUFEM_ASM_FOR_LATE(S, C) " + " ".join(
        ("S" + call(e[:6])) if e[6] < 0 else ("C" + call(e)) for e in late))
    return "\n".join(lines) + "\n"


def _lib(plan: StructuredPlan):
    return load_library("assemble.cu", _SIGNATURES,
                        {"tpufem_assemble_tables.h": tables_header(plan)})


def assemble_stencil_cuda(plan: StructuredPlan, X_emb: torch.Tensor
                          ) -> StencilMatrix:
    """Embedded coordinates X_emb [T, 4, 3, *store_grid] (float32/64) ->
    StencilMatrix [K, num_store_rows] of the P1 Poisson stiffness: B13 on
    a CUDA tensor, the plain version on a CPU one."""
    _check(plan, X_emb)
    if X_emb.device.type == "cpu":
        return assemble_stencil_plain(plan, X_emb)
    if X_emb.dtype not in _SUFFIX or not X_emb.is_contiguous():
        raise ValueError(f"B13: X_emb {X_emb.dtype}, expected contiguous "
                         "float32/64")
    lib = _lib(plan)
    sg = tuple(plan.store_grid)
    tx, ty, tz, _, _ = assemble_tiling(X_emb.element_size(), sg)
    check_assemble_tile(X_emb.element_size(), tx, ty, tz)
    with torch.cuda.device(X_emb.device):
        data = torch.empty((plan.width,) + sg, dtype=X_emb.dtype,
                           device=X_emb.device)
        status = getattr(lib, "tpufem_assemble_stencil"
                         + _SUFFIX[X_emb.dtype])(
            X_emb.data_ptr(), data.data_ptr(), *sg, *plan.info.cell_grid,
            tx, ty, tz, stream_handle())
    check_launch(status, "assemble_stencil")
    assemble_stencil_cuda.launches += 1
    return StencilMatrix(data.reshape(plan.width, -1), plan.offsets)


assemble_stencil_cuda.launches = 0


def assemble_stencil_plain(plan: StructuredPlan, X_emb: torch.Tensor
                           ) -> StencilMatrix:
    """Plain PyTorch version of B13: the element stiffness planes of the
    valid cells (assemble.planar), slice-added into the stencil planes in
    the order t, a, b."""
    _check(plan, X_emb)
    cg = plan.info.cell_grid
    X = X_emb[:, :, :, :cg[0], 1:1 + cg[1], 1:1 + cg[2]]
    return assemble_stencil_structured_bt(plan,
                                          p1_stiffness_bt(X, "tetrahedron"))
