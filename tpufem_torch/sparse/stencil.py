"""Stencil (offset-diagonal) sparse matrix, as in tpufem.sparse.stencil.

Storing the matrix as K offset-diagonals ``data [K, NN]`` turns SpMV into

    y = sum_k data[k] * shift(x, offset_k)

with no column-index array.  ``stencil_matvec`` is the plain PyTorch
version; ``StencilMatrix.matvec`` goes through ``ops.stencil_cuda``, which
launches the CUDA kernel (K2) on a CUDA tensor and runs
``stencil_matvec`` on a CPU tensor.
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
