"""Row partitioning for distributed operators, as in
tpufem.dist.partition: P contiguous row stripes; on the row-major
structured meshes a stripe boundary is a mesh row, so the stencil halo is
exactly the coupling between neighbouring stripes."""
from __future__ import annotations

import torch

__all__ = ["pad_rows", "padded_size"]


def padded_size(n: int, num_shards: int) -> int:
    return ((n + num_shards - 1) // num_shards) * num_shards


def pad_rows(data, b, offsets, num_shards: int, diag_k: int):
    """Pad a stencil system to a multiple of num_shards rows.

    Padding rows are identity (diag = 1, rhs = 0) so they stay decoupled and
    exactly preserve the CG trajectory of the unpadded system.
    Returns (data_p [K, NP], b_p [NP], n_orig).
    """
    k, n = data.shape
    np_rows = padded_size(n, num_shards)
    if np_rows == n:
        return data, b, n
    pad = np_rows - n
    data_p = torch.nn.functional.pad(data, (0, pad))
    data_p[diag_k, n:] = 1.0
    b_p = torch.nn.functional.pad(b, (0, pad))
    return data_p, b_p, n
