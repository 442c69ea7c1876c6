"""Fused P1 stiffness assembly on structured Kuhn-tetrahedron grids: kernel
B13 (csrc/assemble.cu), the counterpart of tpufem/ops/assemble_pallas.py.

``element_coords_bt_embedded`` lays the element coordinates out on the
plan's store grid, ``assemble_stencil_cuda`` turns them into the embedded
stencil planes of the P1 Poisson stiffness (no RHS, no boundary
elimination) and counts its launches in ``assemble_stencil_cuda.launches``;
``assemble_stencil_plain`` is its plain PyTorch version (element planes on
the cell grid, slice-added into the stencil planes), which the wrapper runs
for a CPU tensor.  B13 equals it bit for bit on the card.

The Pallas kernel's ``block_lead`` (its z-block height in VMEM) has no
counterpart: one CUDA launch covers the whole store grid.  The argument is
kept in its position so that a call written for the reference binds
``dtype`` the same way.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpufem_torch.assemble.planar import element_coords_bt, p1_stiffness_bt
from tpufem_torch.assemble.structured import (StructuredPlan,
                                              assemble_stencil_structured_bt)
from tpufem_torch.ops._build import check_launch, load_library, stream_handle
from tpufem_torch.sparse.stencil import StencilMatrix

__all__ = ["element_coords_bt_embedded", "assemble_stencil_cuda",
           "assemble_stencil_plain"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SUFFIX = {torch.float32: "_f32", torch.float64: "_f64"}
# X, data, S0, S1, S2, m0, m1, m2, stream
_SIGNATURES = {"tpufem_assemble_stencil" + sfx: (_P, _P) + (_I,) * 6 + (_P,)
               for sfx in _SUFFIX.values()}


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


def tables_header(plan: StructuredPlan) -> str:
    """Generated header of B13: each (type, local row)'s store shift and
    the stencil slots of its four entries."""
    lines = ["// generated by tpufem_torch.ops.assemble_cuda", "#pragma once",
             f"#define TPUFEM_ASM_K {plan.width}"]
    terms = []
    for t in range(plan.info.num_types):
        for a in range(4):
            args = [t, a, *plan.entry_shift[t, a, 0], *plan.entry_k[t, a]]
            terms.append("X(" + ", ".join(str(int(v)) for v in args) + ")")
    lines.append("#define TPUFEM_ASM_FOR_TA(X) " + " ".join(terms))
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
    with torch.cuda.device(X_emb.device):
        data = torch.empty((plan.width,) + sg, dtype=X_emb.dtype,
                           device=X_emb.device)
        status = getattr(lib, "tpufem_assemble_stencil"
                         + _SUFFIX[X_emb.dtype])(
            X_emb.data_ptr(), data.data_ptr(), *sg, *plan.info.cell_grid,
            stream_handle())
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
