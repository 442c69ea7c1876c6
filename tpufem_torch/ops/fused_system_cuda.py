"""One-pass 3D Poisson system build: kernel K1 (csrc/fused_system.cu).

Replaces tpufem/ops/fused_system_pallas.py::_kernel (entry
``build_poisson_system_pallas``).  From the embedded node coordinates it
emits the stiffness stencil planes, the RHS load vector and the
zero-Dirichlet elimination on the box boundary in one pass.

The Pallas kernel traced the Python RHS callable into its body.  A CUDA
kernel cannot call Python, so the RHS function must carry a C expression of
``x, y, z`` (``solve.poisson.RhsFunction.c_expr``): it is written with the
plan tables into a generated header and K1 is built once per distinct
header (the reference's runtime-codegen idea).  A callable without a C
expression raises on a CUDA tensor; it never drops to the plain version.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpufem_torch.assemble.planar import p1_gradients
from tpufem_torch.assemble.structured import StructuredPlan
from tpufem_torch.fem.elements import P1Tetrahedron
from tpufem_torch.fem.quadrature import QuadratureRule
from tpufem_torch.ops._build import check_launch, load_library, stream_handle
from tpufem_torch.sparse.stencil import StencilMatrix

__all__ = ["node_coords_embedded_from_grid", "build_poisson_system",
           "build_poisson_system_plain"]

_RHS_MODES = {"quadrature": 0, "interp": 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "tpufem_fused_system_f32": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                _P),
    "tpufem_fused_system_f64": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                _P),
}
_ENTRY = {torch.float32: "tpufem_fused_system_f32",
          torch.float64: "tpufem_fused_system_f64"}


def node_coords_embedded_from_grid(coords_grid: np.ndarray,
                                   plan: StructuredPlan,
                                   dtype=np.float32) -> np.ndarray:
    """[dim, *store_grid] embedded node coordinates from a [dim, *node_grid]
    coordinate grid (coordinate 0 = x varies along the last axis).

    Padding positions get index-proportional synthetic coordinates, as in
    the JAX package (the kernels never read them for a valid cell).
    """
    ng = plan.info.node_grid
    sg = plan.store_grid
    dim = coords_grid.shape[0]
    g = len(sg)
    out = np.empty((dim,) + tuple(sg), dtype)
    for d in range(dim):
        ax = g - 1 - d
        out[d] = (np.arange(sg[ax], dtype=dtype) - 1.0).reshape(
            (1,) * ax + (sg[ax],) + (1,) * (g - 1 - ax))
    valid = (slice(None),) + tuple(slice(1, 1 + ng[d]) for d in range(g))
    out[valid] = coords_grid
    return out


def _check_plan(plan: StructuredPlan):
    if not plan.embedded:
        raise ValueError("plan must be built with structured_plan(embed=True)")
    if (len(plan.info.node_grid) != 3
            or plan.info.type_node_offsets.shape[1] != 4):
        raise NotImplementedError("the fused build is 3D P1 tetrahedra")


def _lit(v: float) -> str:
    return repr(float(v))


def tables_header(plan: StructuredPlan, rule: QuadratureRule,
                  c_expr: str) -> str:
    """Generated header of K1: plan tables, quadrature and f as C code."""
    info = plan.info
    phi = P1Tetrahedron().shape_values(rule.points)
    offs = info.type_node_offsets
    lines = ["// generated by tpufem_torch.ops.fused_system_cuda",
             "#pragma once",
             f"#define TPUFEM_K {plan.width}"]
    lines.append("#define TPUFEM_FOR_OFFSETS(X) " + " ".join(
        f"X({k}, {dz}, {dy}, {dx})"
        for k, (dz, dy, dx) in enumerate(plan.offsets_grid)))
    lines.append("#define TPUFEM_FOR_QP(X) " + " ".join(
        "X(" + ", ".join(_lit(v) for v in phi[q]) + f", {_lit(w)})"
        for q, w in enumerate(rule.weights)))
    terms = []
    for t in range(info.num_types):
        for a in range(4):
            args = [t, a, *offs[t, a], *offs[t].reshape(-1),
                    *plan.entry_k[t, a]]
            terms.append("X(" + ", ".join(str(int(v)) for v in args) + ")")
    lines.append("#define TPUFEM_FOR_TA(X) " + " ".join(terms))
    lines.append("template <typename T>\n__device__ __forceinline__ "
                 f"T rhs_f(T x, T y, T z) {{ return ({c_expr}); }}")
    return "\n".join(lines) + "\n"


def _lib(plan, rule, c_expr):
    return load_library("fused_system.cu", _SIGNATURES,
                        {"tpufem_fused_tables.h":
                         tables_header(plan, rule, c_expr)})


def build_poisson_system(plan: StructuredPlan, C_emb: torch.Tensor,
                         f_planes, rule: QuadratureRule, *,
                         apply_bc: bool = True,
                         rhs_mode: str = "quadrature"):
    """(StencilMatrix, b) of 3D P1 Poisson on the embedded layout.

    C_emb: [3, *store_grid] node coordinates (from
    ``node_coords_embedded_from_grid``); f_planes(x, y, z) -> plane, with a
    ``c_expr`` attribute for the CUDA kernel.  ``rhs_mode`` "quadrature"
    integrates f with ``rule``; "interp" integrates the P1 interpolant of f
    exactly.  ``apply_bc=False`` returns the raw system.
    """
    _check_plan(plan)
    if rhs_mode not in _RHS_MODES:
        raise ValueError(f"rhs_mode {rhs_mode!r}: quadrature | interp")
    if C_emb.device.type == "cpu":
        return build_poisson_system_plain(plan, C_emb, f_planes, rule,
                                          apply_bc=apply_bc,
                                          rhs_mode=rhs_mode)
    c_expr = getattr(f_planes, "c_expr", None)
    if c_expr is None:
        raise ValueError("the CUDA system build needs an RHS function with "
                         "a C expression (solve.poisson.RhsFunction)")
    sg = tuple(plan.store_grid)
    if (C_emb.dtype not in _ENTRY or tuple(C_emb.shape) != (3,) + sg
            or not C_emb.is_contiguous()):
        raise ValueError(f"fused build: C_emb {tuple(C_emb.shape)} "
                         f"{C_emb.dtype}, expected contiguous float32/64 "
                         f"{(3,) + sg}")
    lib = _lib(plan, rule, c_expr)
    m = plan.info.cell_grid
    with torch.cuda.device(C_emb.device):
        data = torch.empty((plan.width,) + sg, dtype=C_emb.dtype,
                           device=C_emb.device)
        rhs = torch.empty(sg, dtype=C_emb.dtype, device=C_emb.device)
        status = getattr(lib, _ENTRY[C_emb.dtype])(
            C_emb.data_ptr(), data.data_ptr(), rhs.data_ptr(), *sg, *m,
            _RHS_MODES[rhs_mode], int(apply_bc), stream_handle())
    check_launch(status, "fused_system")
    build_poisson_system.launches += 1
    return (StencilMatrix(data.reshape(plan.width, -1), plan.offsets),
            rhs.reshape(-1))


build_poisson_system.launches = 0


def build_poisson_system_plain(plan: StructuredPlan, C_emb: torch.Tensor,
                               f_planes, rule: QuadratureRule, *,
                               apply_bc: bool = True,
                               rhs_mode: str = "quadrature"):
    """Plain PyTorch version of K1: per-type element planes on the cell
    grid, slice-added into the stencil planes, then the elimination."""
    _check_plan(plan)
    info = plan.info
    sg = tuple(plan.store_grid)
    m = info.cell_grid
    dt, dev = C_emb.dtype, C_emb.device
    data = torch.zeros((plan.width,) + sg, dtype=dt, device=dev)
    rhs = torch.zeros(sg, dtype=dt, device=dev)
    phi = P1Tetrahedron().shape_values(rule.points)
    offs = info.type_node_offsets

    def sl(o):
        return tuple(slice(1 + int(o[d]), 1 + int(o[d]) + m[d])
                     for d in range(3))

    for t in range(info.num_types):
        Xt = [[C_emb[d][sl(offs[t, n])] for d in range(3)] for n in range(4)]
        G, det = p1_gradients(Xt)
        adet = det.abs()
        vol = adet * (1.0 / 6.0)
        if rhs_mode == "interp":
            fv = [f_planes(*Xt[b]) for b in range(4)]
            facc = [sum(((2.0 if a == b else 1.0) / 120.0) * fv[b]
                        for b in range(4)) for a in range(4)]
        else:
            facc = [0.0] * 4
            for q, w in enumerate(rule.weights):
                xq = [sum(float(phi[q, n]) * Xt[n][d] for n in range(4))
                      for d in range(3)]
                fq = f_planes(*xq)
                for a in range(4):
                    facc[a] = facc[a] + fq * (float(w) * float(phi[q, a]))
        for a in range(4):
            rows = sl(offs[t, a])
            for b in range(4):
                k = int(plan.entry_k[t, a, b])
                data[k][rows] += (G[a][0] * G[b][0] + G[a][1] * G[b][1]
                                  + G[a][2] * G[b][2]) * vol
            rhs[rows] += facc[a] * adet

    if apply_bc:
        node = [torch.arange(s, device=dev) - 1 for s in sg]
        nz, ny, nx = (node[0].view(-1, 1, 1), node[1].view(1, -1, 1),
                      node[2].view(1, 1, -1))

        def bc_of(z, y, x):
            inside = ((z >= 0) & (z <= m[0]) & (y >= 0) & (y <= m[1])
                      & (x >= 0) & (x <= m[2]))
            on_bd = ((z == 0) | (z == m[0]) | (y == 0) | (y == m[1])
                     | (x == 0) | (x == m[2]))
            return inside & on_bd

        bc_row = bc_of(nz, ny, nx)
        for k, (dz, dy, dx) in enumerate(plan.offsets_grid):
            drop = bc_row | bc_of(nz + dz, ny + dy, nx + dx)
            data[k] = torch.where(drop, 0.0, data[k])
            if (dz, dy, dx) == (0, 0, 0):
                data[k] = torch.where(bc_row, 1.0, data[k])
        rhs = torch.where(bc_row, 0.0, rhs)
    return (StencilMatrix(data.reshape(plan.width, -1), plan.offsets),
            rhs.reshape(-1))
