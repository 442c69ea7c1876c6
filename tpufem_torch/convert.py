"""Carry the JAX package's state into the port, from numpy arrays.

The port never imports JAX, so the caller hands over plain numpy arrays
and Python values (``np.asarray`` of the JAX arrays).  With these, a test
feeds both packages the same operator and the same MG hierarchy:

  * ``system_from_numpy``: an assembled system ``(data [K, NS], b [NS],
    offsets)``;
  * ``const_level_from_numpy`` / ``const_hierarchy_from_numpy``: const MG
    levels (weights, code plane, coarse inverse, plan metadata);
  * ``level_from_numpy`` / ``hierarchy_from_numpy``: general MG levels
    (data planes, inverse diagonal, Dirichlet mask, coarse inverse, plan
    metadata).  A bf16 plane arrives as float32 numpy (numpy has no bf16)
    and is cast to ``dtype``;
  * ``ell_from_numpy``: an assembled ELL matrix (data, cols, row lengths,
    diagonal positions), optionally with the banded plan that
    ``band_plan_from_numpy`` carries over from a JAX ``ELLBandPlan``;
  * ``bcsr_from_numpy``: an assembled BCSR matrix (data, cols, diagonal
    positions), optionally with the banded block plan that
    ``bcsr_band_plan_from_numpy`` carries over from the JAX package's
    ``bcsr_band_plan`` (its plan and data_t);
  * ``stencil_pattern_from_numpy``: a ``StencilPattern`` (the index-based
    stencil assembly plan; slot tables may be None, as the structured
    pattern leaves them);
  * ``dist_levels_from_numpy``, ``ell_partition_from_numpy``,
    ``bcsr_partition_from_numpy``: the multi-device state — a
    ``DistMGLevel`` list, an ``ELLPartition``, a ``BCSRPartition`` (their
    arrays as numpy, as the JAX package keeps them on the host).
  * ``amg_hierarchy_from_numpy``, ``block_amg_hierarchy_from_numpy``,
    ``dist_amg_hierarchy_from_numpy``: a JAX-built AMG hierarchy (each
    level's operator and transfer matrices as (data, cols), inv_diag,
    lmax, emb, the interval scales, coarse_inv and the scalar config), so
    that one hierarchy's cycle can be applied in both packages.

The port rebuilds each structured plan from its StructuredInfo and checks
it against the given store grid and offsets; a banded ELL plan is checked
against the window rule of the banded kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from tpufem_torch.assemble.structured import structured_plan
from tpufem_torch.dist.ell import BCSRPartition, ELLPartition
from tpufem_torch.dist.multigrid import DistMGLevel
from tpufem_torch.mesh.core import StructuredInfo
from tpufem_torch.solve.multigrid import ConstMGLevel, MGLevel
from tpufem_torch.sparse.bcsr import BCSRMatrix
from tpufem_torch.sparse.ell import ELLMatrix
from tpufem_torch.sparse.ell_cuda import ELLBandPlan, band_rows
from tpufem_torch.sparse.stencil import StencilMatrix, StencilPattern

__all__ = ["system_from_numpy", "const_level_from_numpy",
           "const_hierarchy_from_numpy", "level_from_numpy",
           "hierarchy_from_numpy", "ell_from_numpy", "band_plan_from_numpy",
           "bcsr_from_numpy", "bcsr_band_plan_from_numpy",
           "stencil_pattern_from_numpy", "dist_levels_from_numpy",
           "ell_partition_from_numpy", "bcsr_partition_from_numpy",
           "amg_hierarchy_from_numpy", "block_amg_hierarchy_from_numpy",
           "dist_amg_hierarchy_from_numpy"]


def system_from_numpy(data, b, offsets, *, dtype=torch.float64,
                      device="cpu"):
    """(StencilMatrix, b) on ``device`` from numpy data [K, NS], b [NS]."""
    data = torch.as_tensor(np.array(data), dtype=dtype, device=device)
    b = torch.as_tensor(np.array(b), dtype=dtype, device=device)
    if data.dim() != 2 or data.shape[0] != len(offsets) \
            or b.shape != (data.shape[1],):
        raise ValueError(f"system: data {tuple(data.shape)}, b "
                         f"{tuple(b.shape)}, {len(offsets)} offsets")
    return StencilMatrix(data.contiguous(), offsets), b.contiguous()


def _plan_from_numpy(node_grid, cell_grid, type_node_offsets, store_grid,
                     offsets):
    info = StructuredInfo(node_grid=tuple(int(v) for v in node_grid),
                          cell_grid=tuple(int(v) for v in cell_grid),
                          type_node_offsets=np.asarray(type_node_offsets,
                                                       dtype=np.int64))
    plan = structured_plan(info, embed=True)
    if (tuple(plan.store_grid) != tuple(int(v) for v in store_grid)
            or plan.offsets != tuple(int(o) for o in offsets)):
        raise ValueError("level metadata disagrees with the port's plan: "
                         f"store {plan.store_grid} vs {tuple(store_grid)}")
    return plan


def _tensor(a, dtype, device, shape):
    t = torch.as_tensor(np.array(a), device=device).to(dtype)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"array {tuple(t.shape)} does not fit the plan's "
                         f"{tuple(shape)}")
    return t.contiguous()


def const_level_from_numpy(*, node_grid, cell_grid, type_node_offsets,
                           store_grid, offsets, weights, code,
                           coarse_inverse=None, dtype=torch.float64,
                           device="cpu") -> ConstMGLevel:
    """One ConstMGLevel from the JAX level's metadata and arrays."""
    plan = _plan_from_numpy(node_grid, cell_grid, type_node_offsets,
                            store_grid, offsets)
    if len(weights) != plan.width:
        raise ValueError("one weight per offset expected")
    return ConstMGLevel(
        plan=plan, weights=tuple(float(w) for w in weights),
        code=_tensor(np.asarray(code).reshape(-1), dtype, device,
                     (plan.num_store_rows,)),
        coarse_inverse=None if coarse_inverse is None else torch.as_tensor(
            np.array(coarse_inverse), dtype=dtype, device=device))


def const_hierarchy_from_numpy(levels, *, dtype=torch.float64,
                               device="cpu"):
    """A list of ConstMGLevel from a list of dicts with the keyword
    arguments of ``const_level_from_numpy``."""
    return [const_level_from_numpy(**lv, dtype=dtype, device=device)
            for lv in levels]


def level_from_numpy(*, node_grid, cell_grid, type_node_offsets, store_grid,
                     offsets, data, inv_diag, bc_mask, coarse_inverse=None,
                     dtype=torch.float64, device="cpu") -> MGLevel:
    """One general MGLevel from the JAX level's metadata and arrays: data
    and inv_diag cast to ``dtype``; the coarse inverse keeps the float
    type it arrives in (a cast hierarchy keeps it wider than its
    planes)."""
    plan = _plan_from_numpy(node_grid, cell_grid, type_node_offsets,
                            store_grid, offsets)
    ns = plan.num_store_rows
    return MGLevel(
        plan=plan,
        data=_tensor(np.asarray(data).reshape(plan.width, -1), dtype, device,
                     (plan.width, ns)),
        inv_diag=_tensor(np.asarray(inv_diag).reshape(-1), dtype, device,
                         (ns,)),
        bc_mask=_tensor(np.asarray(bc_mask).reshape(-1), torch.bool, device,
                        (ns,)),
        coarse_inverse=None if coarse_inverse is None else torch.as_tensor(
            np.array(coarse_inverse), device=device))


def hierarchy_from_numpy(levels, *, dtype=torch.float64, device="cpu"):
    """A list of MGLevel from a list of dicts with the keyword arguments of
    ``level_from_numpy``."""
    return [level_from_numpy(**lv, dtype=dtype, device=device)
            for lv in levels]


def band_plan_from_numpy(rel, data_t, *, n, np_rows, block_rows, d_lists,
                         width, dtab=None, segments=None,
                         dtype=torch.float64, device="cpu"):
    """(ELLBandPlan, data_t, rel) on ``device`` from a JAX ELLBandPlan's
    arrays (rel [K, NP] int16/int32, data_t [K, NP]) and statics; data_t is
    cast to ``dtype``.  Raises if a real row's window column leaves [0, n)."""
    rel, data_t = np.array(rel), np.array(data_t)      # own, writable
    K, NP, R, n = int(width), int(np_rows), int(block_rows), int(n)
    if (rel.shape != (K, NP) or data_t.shape != (K, NP) or R <= 0
            or NP % R or not n <= NP < n + R
            or rel.dtype not in (np.int16, np.int32)):
        raise ValueError(f"band plan: rel {rel.shape} {rel.dtype}, data_t "
                         f"{data_t.shape} for K={K}, NP={NP}, R={R}, n={n}")
    base = (np.arange(n) // R - 1) * R
    cols = base[None, :] + rel[:, :n].astype(np.int64)
    if n and (cols.min() < 0 or cols.max() >= n):
        raise ValueError("band plan: a window column leaves [0, n)")
    plan = ELLBandPlan(
        rel=rel, data_t=data_t, n=n, np_rows=NP, block_rows=R,
        d_lists=tuple(tuple(int(v) for v in d) for d in d_lists), width=K,
        dtab=None if dtab is None else np.asarray(dtab),
        **dict(zip(("row_len", "form"), band_rows(data_t, n))),
        segments=None if segments is None else tuple(
            (int(s), int(e), tuple(tuple(int(v) for v in d) for d in dl))
            for s, e, dl in segments))
    return (plan, torch.as_tensor(data_t, device=device).to(dtype),
            torch.as_tensor(rel, device=device))


def bcsr_band_plan_from_numpy(plan, data_t, *, dtype=torch.float64,
                              device="cpu"):
    """(ELLBandPlan, data_t [K, b, b, NP], rel [K, NP]) on ``device`` from
    the JAX package's ``bcsr_band_plan`` result: its plan (arrays as
    numpy, statics as Python values) and its data_t, cast to ``dtype``."""
    data_t = np.array(data_t)
    port_plan, _, rel = band_plan_from_numpy(
        np.asarray(plan.rel), np.asarray(plan.data_t), n=plan.n,
        np_rows=plan.np_rows, block_rows=plan.block_rows,
        d_lists=plan.d_lists, width=plan.width, dtab=plan.dtab,
        segments=plan.segments, dtype=dtype, device=device)
    K, NP = port_plan.width, port_plan.np_rows
    if data_t.ndim != 4 or data_t.shape[0] != K or data_t.shape[3] != NP \
            or data_t.shape[1] != data_t.shape[2]:
        raise ValueError(f"BCSR band plan: data_t {data_t.shape} for K={K}, "
                         f"NP={NP}")
    return (port_plan, torch.as_tensor(data_t, device=device).to(dtype),
            rel)


def bcsr_from_numpy(data, cols, diag_pos=None, *, band=None,
                    dtype=torch.float64, device="cpu") -> BCSRMatrix:
    """A BCSRMatrix on ``device`` from numpy data [ns, K, b, b] (cast to
    ``dtype``), cols [ns, K] int32 and optional diagonal positions [ns].
    ``band``: a (plan, data_t, rel) triple from
    ``bcsr_band_plan_from_numpy`` to run the products on."""
    data = torch.as_tensor(np.array(data), device=device).to(dtype)
    cols = torch.as_tensor(np.array(cols, dtype=np.int32), device=device)
    if data.dim() != 4 or tuple(cols.shape) != tuple(data.shape[:2]) \
            or data.shape[2] != data.shape[3]:
        raise ValueError(f"BCSR: data {tuple(data.shape)}, cols "
                         f"{tuple(cols.shape)}")
    A = BCSRMatrix(data.contiguous(), cols.contiguous(),
                   None if diag_pos is None else torch.as_tensor(
                       np.array(diag_pos, dtype=np.int32), device=device))
    if band is not None:
        plan = band[0]
        if plan.n != data.shape[0] or plan.width != data.shape[1]:
            raise ValueError("band plan does not fit the matrix")
        A._band = tuple(band)
    return A


def ell_from_numpy(data, cols, row_lengths=None, diag_pos=None, *,
                   band=None, dtype=torch.float64,
                   device="cpu") -> ELLMatrix:
    """An ELLMatrix on ``device`` from numpy data [N, K] (cast to
    ``dtype``), cols [N, K] int32 and optional row lengths / diagonal
    positions [N].  ``band``: a (plan, data_t, rel) triple from
    ``band_plan_from_numpy`` to run the products on (instead of the plan
    the matrix would build itself)."""
    data = torch.as_tensor(np.array(data), device=device).to(dtype)
    cols = torch.as_tensor(np.array(cols, dtype=np.int32), device=device)
    if data.dim() != 2 or cols.shape != data.shape:
        raise ValueError(f"ELL: data {tuple(data.shape)}, cols "
                         f"{tuple(cols.shape)}")

    def vec(a):
        return None if a is None else torch.as_tensor(
            np.array(a, dtype=np.int32), device=device)

    A = ELLMatrix(data.contiguous(), cols.contiguous(), vec(row_lengths),
                  vec(diag_pos))
    if band is not None:
        plan = band[0]
        if plan.n != data.shape[0] or plan.width != data.shape[1]:
            raise ValueError("band plan does not fit the matrix")
        A._band = tuple(band)
    return A


def stencil_pattern_from_numpy(*, offsets, slots, perm, sorted_slots,
                               diag_k, num_rows) -> StencilPattern:
    """The port's StencilPattern from a JAX one's fields (numpy arrays, or
    None for the slot tables of ``stencil_pattern_structured``)."""
    def arr(a):
        return None if a is None else np.array(a, dtype=np.int64)

    offsets = arr(offsets)
    if offsets is None or offsets[int(diag_k)] != 0:
        raise ValueError("stencil pattern: offsets[diag_k] must be 0")
    return StencilPattern(offsets=offsets, slots=arr(slots), perm=arr(perm),
                          sorted_slots=arr(sorted_slots), diag_k=int(diag_k),
                          num_rows=int(num_rows))


def dist_levels_from_numpy(levels) -> list:
    """The port's ``DistMGLevel`` list from the JAX package's (its
    ``build_dist_hierarchy``): the same global numpy arrays and metadata,
    for ``dist.multigrid.put_hierarchy``."""
    return [DistMGLevel(
        data=np.array(lv.data), inv_diag=np.array(lv.inv_diag),
        bc_mask=np.array(lv.bc_mask),
        offsets_grid=tuple(tuple(int(v) for v in o)
                           for o in lv.offsets_grid),
        node_grid=tuple(int(v) for v in lv.node_grid),
        local_planes=int(lv.local_planes), distributed=bool(lv.distributed),
        coarse_inverse=(None if lv.coarse_inverse is None
                        else np.array(lv.coarse_inverse)))
        for lv in levels]


def ell_partition_from_numpy(part) -> ELLPartition:
    """The port's ``ELLPartition`` from the JAX package's."""
    return ELLPartition(
        data=np.array(part.data), rel=np.array(part.rel, dtype=np.int32),
        inv_diag=np.array(part.inv_diag), halo=int(part.halo), n=int(part.n),
        local_rows=int(part.local_rows), num_shards=int(part.num_shards))


def bcsr_partition_from_numpy(part) -> BCSRPartition:
    """The port's ``BCSRPartition`` from the JAX package's."""
    return BCSRPartition(
        data=np.array(part.data), rel=np.array(part.rel, dtype=np.int32),
        inv_diag=np.array(part.inv_diag), halo=int(part.halo), n=int(part.n),
        local_rows=int(part.local_rows), num_shards=int(part.num_shards),
        block_size=int(part.block_size))


def _amg_fields(lv: dict, cls, matrix, dtype, device) -> dict:
    """The port's level fields from a dict of numpy arrays: a matrix field
    arrives as its (data, cols) pair and becomes ``matrix``; ``emb`` and
    the gather transfers' columns become index tensors, every other array
    a ``dtype`` tensor, scalars stay as they are."""
    out = {}
    for name, value in lv.items():
        if name not in cls._fields:
            raise ValueError(f"{cls.__name__} has no field {name!r}")
        if value is None:
            out[name] = None
        elif isinstance(value, tuple):
            out[name] = matrix(*value, dtype=dtype, device=device)
        elif name in ("emb", "p_cols", "r_cols"):
            out[name] = torch.as_tensor(np.array(value, dtype=np.int64),
                                        device=device)
        elif isinstance(value, np.ndarray):
            out[name] = torch.as_tensor(np.array(value),
                                        device=device).to(dtype)
        else:
            out[name] = value
    return out


def amg_hierarchy_from_numpy(levels, coarse_inv, *, smoother_degree,
                             smoother_ratio, operator_complexity, gamma=1,
                             dtype=torch.float64, device="cpu"):
    """The port's ``AMGHierarchy`` (solve.amg) from a JAX-built one's
    arrays.  ``levels``: one dict per level with the fields of
    ``AMGLevel``, each ELL matrix (A, Qp, Qr, Rop, Pop) as its numpy
    (data, cols) pair, each array as numpy (inv_diag, tv, emb, the gather
    transfers), lmax / s / omega as numbers.  The matrices resolve their
    plans as the port's own build leaves them: level operators lazily, the
    transfer matrices on the gather form on the CPU."""
    from tpufem_torch.solve.amg import AMGHierarchy, AMGLevel

    out = []
    for lv in levels:
        fields = _amg_fields(lv, AMGLevel, ell_from_numpy, dtype, device)
        for name in ("Qp", "Qr", "Rop", "Pop"):
            M = fields.get(name)
            if M is not None and M.data.device.type == "cpu":
                M._band = None
        out.append(AMGLevel(**fields))
    return AMGHierarchy(
        levels=tuple(out),
        coarse_inv=torch.as_tensor(np.array(coarse_inv),
                                   device=device).to(dtype),
        smoother_degree=int(smoother_degree),
        smoother_ratio=float(smoother_ratio),
        operator_complexity=float(operator_complexity), gamma=int(gamma))


def block_amg_hierarchy_from_numpy(levels, coarse_inv, *, smoother_degree,
                                   smoother_ratio, operator_complexity,
                                   gamma=1, dtype=torch.float64,
                                   device="cpu"):
    """The port's ``BlockAMGHierarchy`` (solve.amg_block) from a JAX-built
    one's arrays: ``levels`` as for ``amg_hierarchy_from_numpy``, with the
    fields of ``BlockAMGLevel`` (A, Qp, Qr as BCSR (data, cols) pairs;
    inv_diag [ns, b, b], emb, the gather transfers' blocks, lmax, m)."""
    from tpufem_torch.solve.amg_block import (BlockAMGHierarchy,
                                              BlockAMGLevel)

    out = [BlockAMGLevel(**_amg_fields(lv, BlockAMGLevel, bcsr_from_numpy,
                                       dtype, device)) for lv in levels]
    return BlockAMGHierarchy(
        levels=tuple(out),
        coarse_inv=torch.as_tensor(np.array(coarse_inv),
                                   device=device).to(dtype),
        smoother_degree=int(smoother_degree),
        smoother_ratio=float(smoother_ratio),
        operator_complexity=float(operator_complexity), gamma=int(gamma))


def dist_amg_hierarchy_from_numpy(h):
    """The port's ``DistAMGHierarchy`` (dist.amg) from the JAX package's:
    its host arrays (as numpy) and static metadata; no single-device
    ``base``."""
    from tpufem_torch.dist.amg import DistAMGHierarchy, _LevelStatic

    def arrays(t):
        return tuple(np.array(a) for a in t)

    return DistAMGHierarchy(
        level_arrays=tuple(arrays(t) for t in h.level_arrays),
        static=tuple(_LevelStatic(halo=int(st.halo), s=int(st.s),
                                  lmax=float(st.lmax), omega=float(st.omega),
                                  local_rows=int(st.local_rows))
                     for st in h.static),
        fine_arrays=arrays(h.fine_arrays), fine_halo=int(h.fine_halo),
        coarse_inv=np.array(h.coarse_inv),
        smoother_degree=int(h.smoother_degree),
        smoother_ratio=float(h.smoother_ratio), gamma=int(h.gamma),
        n=int(h.n), np_rows=int(h.np_rows), num_shards=int(h.num_shards))
