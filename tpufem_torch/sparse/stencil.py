"""Stencil (offset-diagonal) sparse matrix, as in tpufem.sparse.stencil.

Storing the matrix as K offset-diagonals ``data [K, NN]`` turns SpMV into

    y = sum_k data[k] * shift(x, offset_k)

with no column-index array.  ``stencil_matvec`` is the plain PyTorch
version; ``StencilMatrix.matvec`` goes through ``ops.stencil_cuda``, which
launches the CUDA kernel (K2) on a CUDA tensor and runs
``stencil_matvec`` on a CPU tensor.  ``stencil_pattern`` is the host
(numpy) plan of the index-based stencil assembly (``assemble.stencil``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpufem_torch.mesh.adjacency import _unique_pairs

__all__ = ["StencilPattern", "stencil_pattern", "StencilMatrix",
           "stencil_matvec"]


@dataclasses.dataclass(frozen=True)
class StencilPattern:
    """offsets [K] int64 (sorted, includes 0); slots [NE, npe, npe] int64
    flat index k*NN + row of every local-matrix entry; diag_k: index of
    offset 0; perm/sorted_slots: the sorted-assembly plan."""

    offsets: np.ndarray
    slots: np.ndarray
    perm: np.ndarray
    sorted_slots: np.ndarray
    diag_k: int
    num_rows: int

    @property
    def width(self) -> int:
        return self.offsets.shape[0]


def stencil_pattern(conn: np.ndarray, num_nodes: int,
                    max_offsets: int | None = None) -> StencilPattern:
    """The offset set and per-entry slots of stencil assembly.  Raises if
    the mesh gives more than ``max_offsets`` distinct offsets (it is then
    unstructured: use the ELL format)."""
    npe = conn.shape[1]
    _, urows, ucols, keys = _unique_pairs(conn, num_nodes)
    offsets = np.unique(ucols - urows)
    if max_offsets is not None and offsets.size > max_offsets:
        raise ValueError(
            f"{offsets.size} distinct offsets (> {max_offsets}); "
            "mesh is not stencil-structured — use the ELL format")
    entry_rows = keys // num_nodes
    entry_cols = keys % num_nodes
    k_idx = np.searchsorted(offsets, entry_cols - entry_rows)
    slot_flat = k_idx * num_nodes + entry_rows
    perm = np.argsort(slot_flat, kind="stable")
    diag_k = int(np.searchsorted(offsets, 0))
    assert offsets[diag_k] == 0
    return StencilPattern(offsets=offsets,
                          slots=slot_flat.reshape(-1, npe, npe),
                          perm=perm, sorted_slots=slot_flat[perm],
                          diag_k=diag_k, num_rows=num_nodes)


def stencil_matvec(data: torch.Tensor, offsets, x: torch.Tensor
                   ) -> torch.Tensor:
    """y[n] = sum_k data[k, n] * x[n + offsets[k]], x zero-padded by the
    largest |offset|."""
    n = x.shape[0]
    halo = int(max(abs(int(o)) for o in offsets))
    xp = torch.nn.functional.pad(x, (halo, halo))
    y = torch.zeros_like(x)
    for k, off in enumerate(offsets):
        y = y + data[k] * xp[halo + int(off): halo + int(off) + n]
    return y


class StencilMatrix:
    """data [K, NN] offset-diagonal storage; offsets are static metadata."""

    def __init__(self, data: torch.Tensor, offsets):
        self.data = data
        self.offsets = tuple(int(o) for o in offsets)

    @property
    def shape(self):
        n = self.data.shape[1]
        return (n, n)

    @property
    def dtype(self):
        return self.data.dtype

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        # imported here: ops.stencil_cuda builds on this module
        from tpufem_torch.ops.stencil_cuda import stencil_apply

        return stencil_apply(self.data, x, self.offsets)

    def __matmul__(self, x):
        return self.matvec(x)

    def diagonal(self) -> torch.Tensor:
        return self.data[self.offsets.index(0)]

    def to_dense(self) -> torch.Tensor:
        """The [NN, NN] dense matrix (small systems: debugging, tests)."""
        n = self.data.shape[1]
        A = self.data.new_zeros((n, n))
        rows = torch.arange(n, device=self.data.device)
        for k, off in enumerate(self.offsets):
            cols = rows + off
            valid = (cols >= 0) & (cols < n)
            A[rows[valid], cols[valid]] += self.data[k][valid]
        return A
