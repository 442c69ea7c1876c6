"""Assembly into stencil (offset-diagonal) storage, as in
tpufem.assemble.stencil: the index-based path for any mesh whose
(col - row) offsets take few values (``sparse.stencil.stencil_pattern``).

The reduction is deterministic on every device
(``assemble.dense.accumulate``), as the ELL assembly's is.
"""
from __future__ import annotations

import torch

from tpufem_torch.assemble.dense import accumulate
from tpufem_torch.assemble.ell import _index
from tpufem_torch.sparse.stencil import StencilMatrix, StencilPattern

__all__ = ["assemble_stencil", "stencil_values"]


def stencil_values(pattern: StencilPattern, element_matrices: torch.Tensor,
                   method: str = "scatter") -> torch.Tensor:
    """Local matrices [NE, npe, npe] -> stencil data [K, NN].  ``"scatter"``
    and ``"sort"`` (the reference's sorted segment sum) give the same
    result: both are the one deterministic accumulation, and ``"sort"`` is
    kept so that the reference's call sites bind."""
    if method not in ("scatter", "sort"):
        raise ValueError(f"unknown assembly method {method!r}")
    k, n = pattern.width, pattern.num_rows
    vals = element_matrices.reshape(-1)
    return accumulate(k * n, _index(pattern.slots, vals), vals).reshape(k, n)

def assemble_stencil(pattern: StencilPattern, element_matrices: torch.Tensor,
                     method: str = "scatter") -> StencilMatrix:
    data = stencil_values(pattern, element_matrices, method=method)
    return StencilMatrix(data, pattern.offsets)
