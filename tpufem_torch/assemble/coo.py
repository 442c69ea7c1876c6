"""COO-triplet assembly, as in tpufem.assemble.coo: the sorted reduction
that replaces atomic adds.

  1. ``coo_triplets``       -- raw (row, col, val) triplets, one per local
                               entry, in element order;
  2. ``coo_sum_duplicates`` -- each triplet's key binary-searched into the
                               precomputed unique pattern, then summed into
                               it (no atomics);
  3. ``assemble_coo``       -- end to end: local matrices -> deduplicated
                               values aligned with the pattern's keys.

The sum is ``index_put_(accumulate=True)`` (``assemble.dense.accumulate``),
which sorts the indices on a CUDA tensor and adds each target's entries in
a fixed order: the same values from run to run, as the reference's sorted
segment sum gives.
"""
from __future__ import annotations

import torch

from tpufem_torch.assemble.dense import accumulate

__all__ = ["coo_triplets", "coo_sum_duplicates", "assemble_coo"]


def coo_triplets(dof_conn, element_matrices: torch.Tensor):
    """Raw (rows, cols, vals) with duplicates, one triplet per local entry:
    entry (e, i, j) lands at flat position e*n*n + i*n + j."""
    conn = torch.as_tensor(dof_conn, device=element_matrices.device)
    n = conn.shape[1]
    rows = torch.repeat_interleave(conn, n, dim=1).reshape(-1)
    cols = conn.repeat(1, n).reshape(-1)
    vals = element_matrices.reshape(-1)
    return rows, cols, vals


def coo_sum_duplicates(rows, cols, vals: torch.Tensor, unique_keys,
                       num_dofs: int) -> torch.Tensor:
    """Sum duplicate (row, col) entries into the unique sparsity pattern.

    unique_keys: [nnz] int64 sorted keys row*num_dofs+col (host
    precomputed).  Returns the deduplicated values [nnz] aligned with
    unique_keys, on ``vals``' device.
    """
    keys = rows.long() * num_dofs + cols.long()
    uk = torch.as_tensor(unique_keys, device=vals.device)
    seg = torch.searchsorted(uk, keys)
    del keys
    return accumulate(int(uk.shape[0]), seg, vals)


def assemble_coo(dof_conn, element_matrices: torch.Tensor, unique_keys,
                 num_dofs: int) -> torch.Tensor:
    """Local matrices -> deduplicated COO values aligned with
    unique_keys."""
    rows, cols, vals = coo_triplets(dof_conn, element_matrices)
    return coo_sum_duplicates(rows, cols, vals, unique_keys, num_dofs)
