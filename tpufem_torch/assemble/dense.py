"""Dense global assembly (small problems, golden references), as in
tpufem.assemble.dense: one accumulating scatter of the local blocks.

Every accumulation here and in assemble/ell.py is
``index_put_(accumulate=True)``, which on a CUDA tensor sorts the indices
and adds each target's entries in a fixed order: the sums are the same
from run to run, as the reference's XLA scatter is (``index_add_`` would
add with float atomics, whose order changes from run to run).
"""
from __future__ import annotations

import torch

__all__ = ["assemble_dense", "assemble_vector", "accumulate"]


def accumulate(size: int, index: torch.Tensor,
               values: torch.Tensor) -> torch.Tensor:
    """out[i] = sum of values[j] over index[j] == i, out of ``size`` zeros;
    deterministic on every device."""
    out = torch.zeros(size, dtype=values.dtype, device=values.device)
    return out.index_put_((index,), values, accumulate=True)


def _conn(dof_conn, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(dof_conn, device=like.device).long()


def assemble_dense(dof_conn, element_matrices: torch.Tensor,
                   num_dofs: int) -> torch.Tensor:
    """Sum local matrices [NE, n, n] into a dense [num_dofs, num_dofs]."""
    conn = _conn(dof_conn, element_matrices)
    n = conn.shape[1]
    rows = conn[:, :, None].expand(-1, n, n)
    cols = conn[:, None, :].expand(-1, n, n)
    A = torch.zeros((num_dofs, num_dofs), dtype=element_matrices.dtype,
                    device=element_matrices.device)
    return A.index_put_((rows, cols), element_matrices, accumulate=True)


def assemble_vector(dof_conn, element_vectors: torch.Tensor,
                    num_dofs: int) -> torch.Tensor:
    """Sum local load vectors [NE, n] into the global vector [num_dofs]."""
    conn = _conn(dof_conn, element_vectors)
    return accumulate(num_dofs, conn.reshape(-1), element_vectors.reshape(-1))
