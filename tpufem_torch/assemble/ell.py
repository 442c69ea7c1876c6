"""ELL global assembly with precomputed slots, as in tpufem.assemble.ell.

The slot of every local-matrix entry is precomputed on the host
(mesh.adjacency.ell_pattern); the device then does one of two reductions:

  * ``method="scatter"``: one flat accumulation with the slot indices;
  * ``method="sort"``: gather by the sort permutation, then the same
    accumulation over the ascending slot ids (the reference's sorted
    segment sum).

Both are deterministic on every device (``assemble.dense.accumulate``),
as the reference's are.
"""
from __future__ import annotations

import torch

from tpufem_torch.assemble.dense import accumulate
from tpufem_torch.mesh.adjacency import ELLPattern
from tpufem_torch.sparse.ell import ELLMatrix

__all__ = ["assemble_ell", "ell_values", "ell_values_scatter"]


def _index(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, device=like.device).reshape(-1).long()


def ell_values_scatter(slots, element_matrices: torch.Tensor, num_rows: int,
                       width: int) -> torch.Tensor:
    """The ``method="scatter"`` reduction with the flat slot indices given
    as an array: local matrices [NE, n, n] -> ELL values [num_rows, width]."""
    vals = element_matrices.reshape(-1)
    return accumulate(num_rows * width, _index(slots, vals),
                      vals).reshape(num_rows, width)


def ell_values(pattern: ELLPattern, element_matrices: torch.Tensor,
               method: str = "scatter") -> torch.Tensor:
    """Reduce local matrices into the ELL value array [NN, K]."""
    num_rows, width = pattern.cols.shape
    if method == "scatter":
        return ell_values_scatter(pattern.slots, element_matrices, num_rows,
                                  width)
    if method != "sort":
        raise ValueError(f"unknown assembly method {method!r}")
    if pattern.perm is None:
        raise ValueError('method="sort" needs a pattern built with '
                         "with_sort_plan=True")
    vals = element_matrices.reshape(-1)
    return accumulate(num_rows * width, _index(pattern.sorted_slots, vals),
                      vals[_index(pattern.perm, vals)]).reshape(num_rows,
                                                                width)


def assemble_ell(pattern: ELLPattern, element_matrices: torch.Tensor,
                 method: str = "scatter") -> ELLMatrix:
    """Local matrices [NE, n, n] -> ELLMatrix on the pattern (on the local
    matrices' device)."""
    data = ell_values(pattern, element_matrices, method=method)
    dev = data.device
    return ELLMatrix(data=data,
                     cols=torch.as_tensor(pattern.cols, device=dev),
                     row_lengths=torch.as_tensor(pattern.row_lengths,
                                                 device=dev),
                     diag_pos=torch.as_tensor(pattern.diag_pos, device=dev))
