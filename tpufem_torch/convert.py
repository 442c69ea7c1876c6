"""Carry the JAX package's state into the port, from numpy arrays.

The port never imports JAX, so the caller hands over plain numpy arrays
and Python values (``np.asarray`` of the JAX arrays).  With these, a test
feeds both packages the same operator and the same MG hierarchy:

  * ``system_from_numpy``: an assembled system ``(data [K, NS], b [NS],
    offsets)``;
  * ``const_level_from_numpy`` / ``const_hierarchy_from_numpy``: const MG
    levels (weights, code plane, coarse inverse, plan metadata).  The port
    rebuilds each plan from its StructuredInfo and checks it against the
    given store grid and offsets.
"""
from __future__ import annotations

import numpy as np
import torch

from tpufem_torch.assemble.structured import structured_plan
from tpufem_torch.mesh.core import StructuredInfo
from tpufem_torch.solve.multigrid import ConstMGLevel
from tpufem_torch.sparse.stencil import StencilMatrix

__all__ = ["system_from_numpy", "const_level_from_numpy",
           "const_hierarchy_from_numpy"]


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


def const_level_from_numpy(*, node_grid, cell_grid, type_node_offsets,
                           store_grid, offsets, weights, code,
                           coarse_inverse=None, dtype=torch.float64,
                           device="cpu") -> ConstMGLevel:
    """One ConstMGLevel from the JAX level's metadata and arrays."""
    info = StructuredInfo(node_grid=tuple(int(v) for v in node_grid),
                          cell_grid=tuple(int(v) for v in cell_grid),
                          type_node_offsets=np.asarray(type_node_offsets,
                                                       dtype=np.int64))
    plan = structured_plan(info, embed=True)
    if (tuple(plan.store_grid) != tuple(int(v) for v in store_grid)
            or plan.offsets != tuple(int(o) for o in offsets)):
        raise ValueError("level metadata disagrees with the port's plan: "
                         f"store {plan.store_grid} vs {tuple(store_grid)}")
    code = torch.as_tensor(np.array(code).reshape(-1), dtype=dtype,
                           device=device)
    if code.shape != (plan.num_store_rows,) or len(weights) != plan.width:
        raise ValueError("code plane or weights do not fit the plan")
    inv = None
    if coarse_inverse is not None:
        inv = torch.as_tensor(np.array(coarse_inverse), dtype=dtype,
                              device=device)
    return ConstMGLevel(plan=plan, weights=tuple(float(w) for w in weights),
                        code=code.contiguous(), coarse_inverse=inv)


def const_hierarchy_from_numpy(levels, *, dtype=torch.float64,
                               device="cpu"):
    """A list of ConstMGLevel from a list of dicts with the keyword
    arguments of ``const_level_from_numpy``."""
    return [const_level_from_numpy(**lv, dtype=dtype, device=device)
            for lv in levels]
