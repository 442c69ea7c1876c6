"""Stencil (offset-diagonal) sparse matrix, as in tpufem.sparse.stencil.

Storing the matrix as K offset-diagonals ``data [K, NN]`` turns SpMV into

    y = sum_k data[k] * shift(x, offset_k)

with no column-index array.  ``stencil_matvec`` is the plain PyTorch
version; the CUDA kernel behind ``ops.stencil_cuda`` computes the same
function.
"""
from __future__ import annotations

import torch

__all__ = ["StencilMatrix", "stencil_matvec"]


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

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return stencil_matvec(self.data, self.offsets, x)
