"""One-pass Poisson system builds: kernel K1 (3D P1 tetrahedra,
csrc/fused_system.cu), kernel B7 (2D P1 triangles,
csrc/fused_system_2d.cu) and kernel B8 (K1 on one z-stripe of a sharded
store grid, csrc/fused_system.cu).

K1 replaces tpufem/ops/fused_system_pallas.py::_kernel and B7 replaces
::_kernel_2d, the two paths of ``build_poisson_system_pallas``.  From the
embedded node coordinates each emits the stiffness stencil planes, the RHS
load vector and the zero-Dirichlet elimination on the box boundary in one
pass.  ``build_poisson_system`` takes either plan, as the reference's entry
does, and counts K1's launches in ``build_poisson_system.launches`` and
B7's in ``build_poisson_system.launches_2d``.  B8 replaces
tpufem/dist/assembly.py::kern: ``build_poisson_stripe`` builds the rows of
one z-stripe from the stripe's coordinates extended by one plane on each
side and its global first plane ``zbase``, and counts its launches in
``build_poisson_stripe.launches`` (``dist.assembly`` calls it per shard).

The Pallas kernels traced the Python RHS callable into their bodies.  A
CUDA kernel cannot call Python, so the RHS function must carry a C
expression of ``x, y[, z]`` (``solve.poisson.RhsFunction.c_expr``): it is
written with the plan tables into a generated header and each kernel is
built once per distinct header (the reference's runtime-codegen idea).  A
callable without a C expression raises on a CUDA tensor; it never drops to
the plain version.

K1 and B8 (one template, csrc/fused_system.cu) compute each tetrahedron
once per tile of ``fused_tiling``'s and march over planes; B7 computes
each triangle once per tile of ``fused_2d_tiling``'s and marches down a
band of rows.  All three are built with ``-fmad=false`` and add their
terms in the plain version's order, so they equal
``build_poisson_system_plain`` / ``build_poisson_stripe_plain`` bit for
bit.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from tpufem_torch.assemble.planar import p1_gradients
from tpufem_torch.assemble.structured import StructuredPlan
from tpufem_torch.fem.elements import P1Tetrahedron, P1Triangle
from tpufem_torch.fem.quadrature import QuadratureRule
from tpufem_torch.ops._build import check_launch, load_library, stream_handle
from tpufem_torch.sparse.stencil import StencilMatrix

__all__ = ["node_coords_embedded", "node_coords_embedded_from_grid",
           "fused_tiling", "fused_smem", "check_fused_tile", "FUSED_TILES",
           "fused_2d_tiling", "fused_2d_smem", "check_fused_2d_tile",
           "FUSED_2D_TILES",
           "build_poisson_system",
           "build_poisson_system_plain", "build_poisson_stripe",
           "build_poisson_stripe_plain"]

_RHS_MODES = {"quadrature": 0, "interp": 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
# per dimension: source, C entry stem (+ _f32 / _f64), the element, the
# reference cell's measure and the interp mass-matrix denominator
_SOURCE = {3: "fused_system.cu", 2: "fused_system_2d.cu"}
_ENTRY = {3: "tpufem_fused_system", 2: "tpufem_fused_system_2d"}
_SUFFIX = {torch.float32: "_f32", torch.float64: "_f64"}
_ELEMENT = {3: P1Tetrahedron, 2: P1Triangle}
_REF_VOLUME = {3: 1.0 / 6.0, 2: 0.5}
_MASS_DENOM = {3: 120.0, 2: 24.0}
# C, data, rhs, S0..S{d-1}, m0..m{d-1}, rhs_mode, apply_bc, the tile (tx,
# nr, tz in 3D; tx, rows in 2D), stream
_SIGNATURES = {
    d: {_ENTRY[d] + sfx: (_P, _P, _P) + (_I,) * (2 * d + 2 + d)
        + (_P,) for sfx in _SUFFIX.values()} for d in (2, 3)}
# B8: C_ext, data, rhs, L, S1, S2, m0, m1, m2, rhs_mode, apply_bc, zbase,
# tx, nr, tz, stream
_STRIPE_ENTRY = "tpufem_fused_system_stripe"
_SIGNATURES[3].update({_STRIPE_ENTRY + sfx: (_P, _P, _P) + (_I,) * 12 + (_P,)
                       for sfx in _SUFFIX.values()})
_SIGNATURES[3]["tpufem_fused_smem"] = (_I, _I, _I)
_SIGNATURES[2]["tpufem_fused_2d_smem"] = (_I, _I)
# K1, B8 and B7 round every product and sum on its own, as torch does
_FLAGS = {3: ("-fmad=false",), 2: ("-fmad=false",)}

# -- K1 / B8 tiles (csrc/fused_system.cu) -------------------------------------
# A block of 256 threads owns tx store columns by 256 / tx rows, one
# column a thread, takes the 6 types of a cell plane in nr rounds and
# marches over tz planes.
FUSED_TILES = ((16, 3), (32, 1))   # (tx, nr) the launcher has kernels for
_THREADS = 256
# per item size, the tile sweep's pick (scripts/fused_build_ablation.py
# --tiles): fp32 32 columns with the 6 types at once (2 blocks an SM),
# fp64 16 columns in 3 rounds of 2 types (2 blocks an SM, not 1)
_TILE = {4: (32, 1), 8: (16, 3)}
_SMS = 132                      # H100 SXM
_SMEM_PER_SM = 233472           # bytes, 1 KB of it reserved per block
_SMEM_PER_BLOCK = 232448        # bytes a block may use
_MAX_PLANES = 32
_VALS = 14                      # per cell and type: 10 entries, 4 loads
_TYPES = 6                      # Kuhn tetrahedra a cell


def node_coords_embedded(mesh, plan: StructuredPlan,
                         dtype=np.float32) -> np.ndarray:
    """[dim, *store_grid] embedded node coordinates of a structured mesh
    (its nodes in grid order, x fastest)."""
    coords_grid = np.moveaxis(
        mesh.coords.reshape(tuple(plan.info.node_grid) + (mesh.dim,)), -1, 0)
    return node_coords_embedded_from_grid(coords_grid, plan, dtype)


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


def fused_smem(itemsize: int, tx: int, nr: int = 1) -> int:
    """Dynamic shared memory (bytes) of a K1 / B8 block of ``tx`` columns
    taking the types in ``nr`` rounds (csrc/fused_system.cu's
    Tile::kSmem): a ring of 3 planes of the 3 coordinates, each 256 / tx +
    2 rows by tx columns and a 16-byte chunk either side, and 14 values
    for each of a round's types of each of the (256 / tx + 1) x (tx + 1)
    cells."""
    ty = _THREADS // tx
    ps = (ty + 2) * (tx + 32 // itemsize)
    return (9 * ps + _TYPES // nr * _VALS * (ty + 1) * (tx + 1)) * itemsize


def _blocks_per_sm(itemsize: int, tx: int, nr: int) -> int:
    """Blocks of a tile an SM runs at once: the kernel's launch bounds (2
    in fp32 and 1 in fp64 with one round, one more with several), or
    fewer by shared memory."""
    bounds = (2 if itemsize == 4 else 1) + (nr > 1)
    return min(bounds, _SMEM_PER_SM // (fused_smem(itemsize, tx, nr) + 1024))


@functools.lru_cache(maxsize=None)
def fused_tiling(itemsize: int, store_grid: tuple):
    """(tx, ty, nr, tz, shared memory bytes, grid) of one K1 / B8 launch
    on a store grid (S0, S1, S2) (B8: S0 is the stripe's depth).

    A block owns ``tx`` columns by ``ty = 256 / tx`` rows, takes a cell
    plane's types in ``nr`` rounds (both per item size, from the tile
    sweep) and marches over ``tz`` planes, its first step a warm-up cell
    plane.  With W plane steps for each of the slots the
    card holds at once (132 SMs x blocks per SM), a march of tz planes
    costs about W (1 + 1 / tz) steps of work and half a block, (tz + 1) /
    2 steps, of tail: tz = sqrt(2 W), within 1 .. 32.  The grid is
    (columns, rows, planes) of tiles."""
    s0, s1, s2 = (int(v) for v in store_grid)
    tx, nr = _TILE[itemsize]
    if s2 % tx or min(s0, s1, s2) < 1:
        raise ValueError(f"store grid {tuple(store_grid)}: rows of "
                         f"{tx}-column tiles")
    ty = _THREADS // tx
    cols = (s2 // tx) * -(-s1 // ty)
    steps = cols * s0 / (_SMS * _blocks_per_sm(itemsize, tx, nr))
    tz = max(1, min(_MAX_PLANES, s0, round(math.sqrt(2.0 * steps))))
    return (tx, ty, nr, tz, fused_smem(itemsize, tx, nr),
            (s2 // tx, -(-s1 // ty), -(-s0 // tz)))


def check_fused_tile(itemsize: int, tx: int, nr: int, tz: int) -> None:
    """Raise ValueError unless (tx columns, nr rounds of types, tz planes)
    is a tile the launcher has a kernel for and its block fits the card's
    shared memory (the C launcher refuses the same tiles)."""
    if (tx, nr) not in FUSED_TILES or tz < 1:
        raise ValueError(f"fused build: tile ({tx} columns, {nr} rounds, "
                         f"{tz} planes): the kernels are {FUSED_TILES} "
                         "(columns, rounds) with tz >= 1")
    if fused_smem(itemsize, tx, nr) > _SMEM_PER_BLOCK:
        raise ValueError(f"fused build: tile ({tx}, {nr}) needs "
                         f"{fused_smem(itemsize, tx, nr)} B of shared memory "
                         f"a block, more than {_SMEM_PER_BLOCK}")


# -- B7 tiles (csrc/fused_system_2d.cu) ---------------------------------------
# A block of tx threads computes tx cells of a row, one a thread, completes
# the tx - 1 columns between them (tiles overlap by a cell) and marches
# down a band of rows, a ring of 3 cell rows of 2 types x 9 values in
# shared memory.
FUSED_2D_TILES = (64,)          # tx the launcher has kernels for
# per item size, the tile sweep's pick (scripts/fused_build_ab.py --tiles;
# 128 cells measured no faster, PERF.md): (tx, rows of a band)
_TILE_2D = {4: (64, 5), 8: (64, 3)}
_VALS_2D = 9                    # per cell and type: 6 entries, 3 loads
_TYPES_2D = 2                   # triangles a cell


def fused_2d_smem(itemsize: int, tx: int) -> int:
    """Dynamic shared memory (bytes) of a B7 block of ``tx`` threads
    (csrc/fused_system_2d.cu's Tile::kSmem): a ring of 3 cell rows, 9
    values for each of the 2 types of each of the tx cells."""
    return 3 * _TYPES_2D * _VALS_2D * tx * itemsize


@functools.lru_cache(maxsize=None)
def fused_2d_tiling(itemsize: int, store_grid: tuple):
    """(tx, rows, shared memory bytes, grid) of one B7 launch on a store
    grid (S0, S1).

    A block of ``tx`` threads completes ``tx - 1`` columns and marches
    down a band of ``rows`` store rows, its first step a warm-up cell row
    (both per item size, from the tile sweep: short bands in several
    waves beat the one wave of B5's const_tiling, PERF.md).  The grid is
    (column tiles, 1, bands)."""
    s0, s1 = (int(v) for v in store_grid)
    if min(s0, s1) < 1:
        raise ValueError(f"store grid {tuple(store_grid)}: empty")
    tx, rows = _TILE_2D[itemsize]
    rows = min(rows, s0)
    return (tx, rows, fused_2d_smem(itemsize, tx),
            (-(-(s1 - 1) // (tx - 1)), 1, -(-s0 // rows)))


def check_fused_2d_tile(itemsize: int, tx: int, rows: int) -> None:
    """Raise ValueError unless (tx threads, bands of rows) is a B7 tile the
    launcher has a kernel for and its block fits the card's shared memory
    (the C launcher refuses the same tiles)."""
    if tx not in FUSED_2D_TILES or rows < 1:
        raise ValueError(f"B7: tile ({tx} columns, {rows} rows): the "
                         f"kernels are {FUSED_2D_TILES} columns with "
                         "rows >= 1")
    if fused_2d_smem(itemsize, tx) > _SMEM_PER_BLOCK:
        raise ValueError(f"B7: tile of {tx} columns needs "
                         f"{fused_2d_smem(itemsize, tx)} B of shared "
                         f"memory a block, more than {_SMEM_PER_BLOCK}")


def _check_plan(plan: StructuredPlan) -> int:
    """The plan's dimension: 3 (P1 tetrahedra) or 2 (P1 triangles)."""
    if not plan.embedded:
        raise ValueError("plan must be built with structured_plan(embed=True)")
    dim = len(plan.info.node_grid)
    if dim not in _SOURCE or plan.info.type_node_offsets.shape[1] != dim + 1:
        raise NotImplementedError("the fused build is 2D P1 triangles or 3D "
                                  "P1 tetrahedra")
    return dim


def _lit(v: float) -> str:
    return repr(float(v))


def tables_header(plan: StructuredPlan, rule: QuadratureRule,
                  c_expr: str) -> str:
    """Generated header of K1 / B7: plan tables, quadrature and f as C
    code (the macros each source lists at its top)."""
    info = plan.info
    dim = len(info.node_grid)
    phi = _ELEMENT[dim]().shape_values(rule.points)
    offs = info.type_node_offsets
    npe = offs.shape[1]
    lines = ["// generated by tpufem_torch.ops.fused_system_cuda",
             "#pragma once",
             f"#define TPUFEM_K {plan.width}"]
    lines.append("#define TPUFEM_FOR_OFFSETS(X) " + " ".join(
        f"X({k}, " + ", ".join(str(int(v)) for v in off) + ")"
        for k, off in enumerate(plan.offsets_grid)))
    lines.append("#define TPUFEM_FOR_QP(X) " + " ".join(
        "X(" + ", ".join(_lit(v) for v in phi[q]) + f", {_lit(w)})"
        for q, w in enumerate(rule.weights)))
    lines.append("#define TPUFEM_FOR_TYPES(X) " + " ".join(
        "X(" + ", ".join(str(int(v)) for v in (t, *offs[t].reshape(-1)))
        + ")" for t in range(info.num_types)))
    terms = []
    for t in range(info.num_types):
        for a in range(npe):
            args = [t, a, *offs[t, a], *offs[t].reshape(-1),
                    *plan.entry_k[t, a]]
            terms.append("X(" + ", ".join(str(int(v)) for v in args) + ")")
    lines.append("#define TPUFEM_FOR_TA(X) " + " ".join(terms))
    params = ", ".join(f"T {c}" for c in "xyz"[:dim])
    lines.append("template <typename T>\n__device__ __forceinline__ "
                 f"T rhs_f({params}) {{ return ({c_expr}); }}")
    return "\n".join(lines) + "\n"


def _lib(plan, rule, c_expr):
    dim = _check_plan(plan)
    return load_library(_SOURCE[dim], _SIGNATURES[dim],
                        {"tpufem_fused_tables.h":
                         tables_header(plan, rule, c_expr)},
                        flags=_FLAGS[dim])


def _launch_lib(plan, C_emb, f_planes, rule, rhs_mode):
    """The built library of the plan's kernel, after the launch checks."""
    if rhs_mode not in _RHS_MODES:
        raise ValueError(f"rhs_mode {rhs_mode!r}: quadrature | interp")
    c_expr = getattr(f_planes, "c_expr", None)
    if c_expr is None:
        raise ValueError("the CUDA system build needs an RHS function with "
                         "a C expression (solve.poisson.RhsFunction)")
    if C_emb.dtype not in _SUFFIX or not C_emb.is_contiguous():
        raise ValueError(f"fused build: C_emb {C_emb.dtype}, expected "
                         "contiguous float32/64")
    return _lib(plan, rule, c_expr)


def _launch(plan, C_emb, f_planes, rule, apply_bc, rhs_mode):
    """Launch K1 or B7 (by the plan's dimension) on C_emb's card."""
    dim = _check_plan(plan)
    sg = tuple(plan.store_grid)
    lib = _launch_lib(plan, C_emb, f_planes, rule, rhs_mode)
    m = plan.info.cell_grid
    if dim == 3:    # the tile's columns, rounds of types and planes
        tx, _, nr, tz, _, _ = fused_tiling(C_emb.element_size(), sg)
        check_fused_tile(C_emb.element_size(), tx, nr, tz)
        tile = (tx, nr, tz)
    else:           # the tile's columns and band of rows
        tx, rows, _, _ = fused_2d_tiling(C_emb.element_size(), sg)
        check_fused_2d_tile(C_emb.element_size(), tx, rows)
        tile = (tx, rows)
    with torch.cuda.device(C_emb.device):
        data = torch.empty((plan.width,) + sg, dtype=C_emb.dtype,
                           device=C_emb.device)
        rhs = torch.empty(sg, dtype=C_emb.dtype, device=C_emb.device)
        status = getattr(lib, _ENTRY[dim] + _SUFFIX[C_emb.dtype])(
            C_emb.data_ptr(), data.data_ptr(), rhs.data_ptr(), *sg, *m,
            _RHS_MODES[rhs_mode], int(apply_bc), *tile, stream_handle())
    check_launch(status, "fused_system" + ("_2d" if dim == 2 else ""))
    if dim == 2:
        build_poisson_system.launches_2d += 1
    else:
        build_poisson_system.launches += 1
    return (StencilMatrix(data.reshape(plan.width, -1), plan.offsets),
            rhs.reshape(-1))


def build_poisson_system(plan: StructuredPlan, C_emb: torch.Tensor,
                         f_planes, rule: QuadratureRule, *,
                         apply_bc: bool = True,
                         rhs_mode: str = "quadrature"):
    """(StencilMatrix, b) of P1 Poisson on the embedded layout: K1 for a 3D
    plan (tetrahedron ``rule``), B7 for a 2D one (triangle ``rule``, 7
    stencil planes).

    C_emb: [dim, *store_grid] node coordinates (from
    ``node_coords_embedded_from_grid``); f_planes(x, y[, z]) -> plane, with
    a ``c_expr`` attribute for the CUDA kernel.  ``rhs_mode`` "quadrature"
    integrates f with ``rule``; "interp" integrates the P1 interpolant of f
    exactly.  ``apply_bc=False`` returns the raw system.
    """
    dim = _check_plan(plan)
    if tuple(C_emb.shape) != (dim,) + tuple(plan.store_grid):
        raise ValueError(f"fused build: C_emb {tuple(C_emb.shape)}, the "
                         f"plan's is {(dim,) + tuple(plan.store_grid)}")
    kw = dict(apply_bc=apply_bc, rhs_mode=rhs_mode)
    if C_emb.device.type == "cpu":
        return build_poisson_system_plain(plan, C_emb, f_planes, rule, **kw)
    return _launch(plan, C_emb, f_planes, rule, **kw)


build_poisson_system.launches = 0       # K1
build_poisson_system.launches_2d = 0    # B7


def build_poisson_system_plain(plan: StructuredPlan, C_emb: torch.Tensor,
                               f_planes, rule: QuadratureRule, *,
                               apply_bc: bool = True,
                               rhs_mode: str = "quadrature"):
    """Plain PyTorch version of K1 and B7: per-type element planes on the
    cell grid, slice-added into the stencil planes, then the elimination."""
    _check_plan(plan)
    data, rhs = _plain_rows(plan, C_emb, 0, 0, plan.store_grid[0], f_planes,
                            rule, apply_bc, rhs_mode)
    return StencilMatrix(data, plan.offsets), rhs


def _plain_rows(plan, C, c_first, z0, depth, f_planes, rule, apply_bc,
                rhs_mode):
    """(data [K, depth * rest], rhs) of store planes [z0, z0 + depth) of
    the leading axis, from coordinates C whose plane 0 is global store
    plane ``c_first``.

    Order (what K1's march gives, csrc/fused_system.cu): in 3D a row sums
    the terms of the cells on the plane below it (za = 1) and those of the
    cells on its own plane (za = 0) apart, each group from 0 in (type, a,
    b) order, and adds the two sums (each type's element values are
    computed once per group); in 2D (B7's march down the rows) all terms
    in (type, a, b) order.  Each element's values are those of the
    whole-grid build, so any stripe equals the same rows of the whole
    build bit for bit."""
    dim = _check_plan(plan)
    if rhs_mode not in _RHS_MODES:
        raise ValueError(f"rhs_mode {rhs_mode!r}: quadrature | interp")
    info = plan.info
    sg = (depth,) + tuple(plan.store_grid[1:])
    m = info.cell_grid
    npe = dim + 1
    dt, dev = C.dtype, C.device
    phi = _ELEMENT[dim]().shape_values(rule.points)
    offs = info.type_node_offsets
    # the cells whose rows (store plane c + 1 + o, o in {0, 1}) can fall in
    # [z0, z0 + depth): their vertices lie in planes [z0 - 1, z0 + depth]
    lo, hi = max(0, z0 - 2), min(m[0], z0 + depth - 1)

    def sl(o):
        return ((slice(lo + 1 + int(o[0]) - c_first,
                       hi + 1 + int(o[0]) - c_first),)
                + tuple(slice(1 + int(o[d]), 1 + int(o[d]) + m[d])
                        for d in range(1, dim)))

    def element(t):
        """(G, vol, |det|, facc) of the type-t elements of cells
        [lo, hi): the loads are facc[a] * |det|."""
        Xt = [[C[d][sl(offs[t, n])] for d in range(dim)]
              for n in range(npe)]
        G, det = p1_gradients(Xt)
        adet = det.abs()
        vol = adet * _REF_VOLUME[dim]
        if rhs_mode == "interp":
            fv = [f_planes(*Xt[b]) for b in range(npe)]
            facc = [sum(((2.0 if a == b else 1.0) / _MASS_DENOM[dim]) * fv[b]
                        for b in range(npe)) for a in range(npe)]
        else:
            facc = [0.0] * npe
            for q, w in enumerate(rule.weights):
                xq = [sum(float(phi[q, n]) * Xt[n][d] for n in range(npe))
                      for d in range(dim)]
                fq = f_planes(*xq)
                for a in range(npe):
                    facc[a] = facc[a] + fq * (float(w) * float(phi[q, a]))
        return G, vol, adet, facc

    data = rhs = None
    for za in ((1, 0) if dim == 3 else (None,)):
        # one group's sums (3D: the cells below, then those of the row's
        # own plane), added to the groups' before
        part = torch.zeros((plan.width,) + sg, dtype=dt, device=dev)
        prhs = torch.zeros(sg, dtype=dt, device=dev)
        for t in range(info.num_types if hi > lo else 0):
            G, vol, adet, facc = element(t)
            for a in range(npe):
                if za is not None and int(offs[t, a, 0]) != za:
                    continue
                # cells c in [lo, hi) land on local plane c + 1 + o - z0:
                # keep those inside [0, depth)
                first = lo + 1 + int(offs[t, a, 0]) - z0
                c_lo, c_hi = max(0, -first), min(hi - lo, depth - first)
                if c_hi <= c_lo:
                    continue
                rows = ((slice(first + c_lo, first + c_hi),)
                        + tuple(slice(1 + int(offs[t, a, d]),
                                      1 + int(offs[t, a, d]) + m[d])
                                for d in range(1, dim)))
                for b in range(npe):
                    k = int(plan.entry_k[t, a, b])
                    part[k][rows] += (sum(G[a][d] * G[b][d]
                                          for d in range(dim))
                                      * vol)[c_lo:c_hi]
                prhs[rows] += (facc[a] * adet)[c_lo:c_hi]
        data = part if data is None else data + part
        rhs = prhs if rhs is None else rhs + prhs

    if apply_bc:
        # global node index of every store position, broadcast along its axis
        node = [(torch.arange(sg[d], device=dev) - 1 + (z0 if d == 0 else 0)
                 ).view([-1 if ax == d else 1 for ax in range(dim)])
                for d in range(dim)]

        def bc_of(idx):
            inside = torch.ones((), dtype=torch.bool, device=dev)
            on_bd = torch.zeros((), dtype=torch.bool, device=dev)
            for d in range(dim):
                inside = inside & (idx[d] >= 0) & (idx[d] <= m[d])
                on_bd = on_bd | (idx[d] == 0) | (idx[d] == m[d])
            return inside & on_bd

        bc_row = bc_of(node)
        for k, off in enumerate(plan.offsets_grid):
            drop = bc_row | bc_of([node[d] + off[d] for d in range(dim)])
            data[k] = torch.where(drop, 0.0, data[k])
            if not any(off):
                data[k] = torch.where(bc_row, 1.0, data[k])
        rhs = torch.where(bc_row, 0.0, rhs)
    return data.reshape(plan.width, -1), rhs.reshape(-1)


def _check_stripe(plan, C_ext, zbase):
    if _check_plan(plan) != 3:
        raise NotImplementedError("the sharded fused build is 3D")
    sg = tuple(plan.store_grid)
    if C_ext.dim() != 4 or C_ext.shape[0] != 3 \
            or tuple(C_ext.shape[2:]) != sg[1:] or C_ext.shape[1] < 3:
        raise ValueError(f"stripe build: C_ext {tuple(C_ext.shape)}, "
                         f"expected [3, L + 2, {sg[1]}, {sg[2]}]")
    depth = C_ext.shape[1] - 2
    if not 0 <= zbase <= sg[0] - depth:
        raise ValueError(f"stripe build: planes [{zbase}, {zbase + depth}) "
                         f"outside the store grid's {sg[0]}")
    return depth


def build_poisson_stripe(plan: StructuredPlan, C_ext: torch.Tensor,
                         zbase: int, f_planes, rule: QuadratureRule, *,
                         rhs_mode: str = "quadrature"):
    """B8: (data [K, L * S1 * S2], rhs [L * S1 * S2]) of the eliminated
    system's store planes [zbase, zbase + L), from C_ext [3, L + 2, S1,
    S2], the coordinates of store planes [zbase - 1, zbase + L] (zeros
    where those fall outside the grid).  On a CPU tensor the plain version
    runs; on a CUDA tensor the kernel launches."""
    depth = _check_stripe(plan, C_ext, int(zbase))
    if C_ext.device.type == "cpu":
        return build_poisson_stripe_plain(plan, C_ext, zbase, f_planes, rule,
                                          rhs_mode=rhs_mode)
    lib = _launch_lib(plan, C_ext, f_planes, rule, rhs_mode)
    sg = tuple(plan.store_grid)
    m = plan.info.cell_grid
    tx, _, nr, tz, _, _ = fused_tiling(C_ext.element_size(),
                                       (depth,) + sg[1:])
    check_fused_tile(C_ext.element_size(), tx, nr, tz)
    with torch.cuda.device(C_ext.device):
        data = torch.empty((plan.width, depth) + sg[1:], dtype=C_ext.dtype,
                           device=C_ext.device)
        rhs = torch.empty((depth,) + sg[1:], dtype=C_ext.dtype,
                          device=C_ext.device)
        status = getattr(lib, _STRIPE_ENTRY + _SUFFIX[C_ext.dtype])(
            C_ext.data_ptr(), data.data_ptr(), rhs.data_ptr(), depth,
            *sg[1:], *m, _RHS_MODES[rhs_mode], 1, int(zbase), tx, nr, tz,
            stream_handle())
    check_launch(status, "fused_system_stripe")
    build_poisson_stripe.launches += 1
    return data.reshape(plan.width, -1), rhs.reshape(-1)


build_poisson_stripe.launches = 0       # B8


def build_poisson_stripe_plain(plan: StructuredPlan, C_ext: torch.Tensor,
                               zbase: int, f_planes, rule: QuadratureRule,
                               *, rhs_mode: str = "quadrature"):
    """Plain PyTorch version of B8: K1's plain build on the extended stripe,
    at the stripe's global offset."""
    depth = _check_stripe(plan, C_ext, int(zbase))
    return _plain_rows(plan, C_ext, int(zbase) - 1, int(zbase), depth,
                       f_planes, rule, True, rhs_mode)
