"""Fixed-width (ELL) sparse matrix container + SpMV, as in
tpufem.sparse.ell.

``data [NN, K]`` + ``cols [NN, K]`` (int32); padding slots point at their
own row with value 0, so no product needs a mask.

``matvec`` dispatches as the reference's does: when the matrix is banded
(bandwidth <= ``_AUTO_BAND_MAX``, true of RCM-ordered meshes) the banded
plan is built once and cached, and every product runs the banded kernel
(B9, sparse.ell_cuda); otherwise the gather form runs, which on a CUDA
tensor is the same kernel in absolute-column mode.  On a CPU tensor both
forms run their plain PyTorch versions.  The reference's pytree protocol,
its compile-time evaluation and its ``TPUFEM_BAND_DISPATCH`` switch exist
for ``jit`` or for the TPU's interpret mode on the CPU, and are not
ported.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from tpufem_torch.sparse.ell_cuda import (_numpy, auto_block_rows,
                                          ell_band_plan,
                                          ell_gather_matvec_cuda,
                                          ell_gather_matvec_multi_cuda,
                                          ell_matvec_cuda,
                                          ell_matvec_multi_cuda)

__all__ = ["ELLMatrix", "ell_matvec", "ell_matvec_multi", "reorder_ell"]

# bandwidth above this is not planned automatically
_AUTO_BAND_MAX = 4096


class _Linear(torch.autograd.Function):
    """A product that is linear in x through a kernel: its JVP applies the
    same kernel to the tangent (what matrix-free Newton-Krylov needs); the
    reverse mode raises, as the reference's kernel has no transpose rule
    either."""

    @staticmethod
    def forward(ctx, x, product):
        ctx.product = product
        return product(x)

    @staticmethod
    def jvp(ctx, x_t, _product_t):
        return ctx.product(x_t)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "the ELL kernels have no transpose rule (as in the reference); "
            "use forward mode (torch.autograd.forward_ad)")


class ELLMatrix:
    """ELL sparse matrix: data [NN, K], cols [NN, K] (int32) tensors."""

    def __init__(self, data, cols, row_lengths=None, diag_pos=None):
        self.data = data
        self.cols = cols
        self.row_lengths = row_lengths
        self.diag_pos = diag_pos
        # banded cache: (plan, data_t, rel) on data's device | None once
        # resolved; "unresolved" until the first product
        self._band = "unresolved"

    @property
    def shape(self):
        n = self.data.shape[0]
        return (n, n)

    @property
    def width(self):
        return self.data.shape[1]

    @property
    def dtype(self):
        return self.data.dtype

    def _resolve_band(self):
        """Build and cache the banded plan if the bandwidth is <=
        ``_AUTO_BAND_MAX``; a failed plan build warns and the gather form
        runs."""
        if self._band != "unresolved":
            return self._band
        self._band = None
        try:
            cols = _numpy(self.cols)
            n = cols.shape[0]
            bw = int(np.abs(cols.astype(np.int64)
                            - np.arange(n)[:, None]).max())
            if bw <= _AUTO_BAND_MAX:
                self.prime_band_plan(auto_block_rows(bw, n, cols.shape[1]))
        except Exception as exc:  # noqa: BLE001 - named, then the gather
            warnings.warn(
                f"ELLMatrix band-plan build failed ({type(exc).__name__}: "
                f"{exc}); falling back to the gather SpMV", RuntimeWarning,
                stacklevel=2)
            self._band = None
        return self._band

    def resolve_band(self):
        """Resolve the banded path now under the automatic policy."""
        self._resolve_band()
        return self

    def prime_band_plan(self, block_rows=None, segment: bool = True):
        """Build and cache the banded plan unconditionally (any bandwidth:
        the block size covers it).  Raises on failure."""
        plan = ell_band_plan(self.data, self.cols, block_rows=block_rows,
                             segment=segment)
        dev = self.data.device
        self._band = (plan, torch.as_tensor(plan.data_t, device=dev),
                      torch.as_tensor(plan.rel, device=dev))
        return self

    def matvec(self, x):
        band = self._resolve_band()
        if band is not None:
            plan, data_t, rel = band
            return _Linear.apply(
                x, lambda v: ell_matvec_cuda(plan, data_t, rel, v))
        return _Linear.apply(x, lambda v: ell_matvec(self.data, self.cols, v))

    def __matmul__(self, x):
        return self.matvec(x)

    def matvec_multi(self, X):
        """Y = A X for X [n, q]: one matrix read for all q columns (B10 on
        the banded path)."""
        band = self._resolve_band()
        if band is not None:
            plan, data_t, rel = band
            return _Linear.apply(
                X, lambda V: ell_matvec_multi_cuda(plan, data_t, rel, V))
        return _Linear.apply(
            X, lambda V: ell_matvec_multi(self.data, self.cols, V))

    def diagonal(self):
        """The diagonal, for Jacobi preconditioning."""
        if self.diag_pos is not None:
            return self.data.gather(1, self.diag_pos[:, None].long())[:, 0]
        rows = torch.arange(self.data.shape[0], device=self.data.device)
        # padding slots also have col == row but hold 0, and the real
        # diagonal appears once, so the masked row sum is exact
        return torch.where(self.cols == rows[:, None], self.data,
                           0.0).sum(dim=1)

    def to_dense(self):
        n, k = self.data.shape
        A = torch.zeros((n, n), dtype=self.data.dtype,
                        device=self.data.device)
        rows = torch.arange(n, device=self.data.device).repeat_interleave(k)
        return A.index_put_((rows, self.cols.reshape(-1).long()),
                            self.data.reshape(-1), accumulate=True)

    def transpose_matvec(self, x):
        """A^T x via scatter-add."""
        contrib = self.data * x[:, None]
        return torch.zeros_like(x).index_add_(
            0, self.cols.reshape(-1).long(), contrib.reshape(-1))


def ell_matvec(data, cols, x):
    """y[i] = sum_k data[i, k] x[cols[i, k]]: the gather form (the kernel
    in absolute-column mode on a CUDA tensor)."""
    return ell_gather_matvec_cuda(data, cols, x)


def ell_matvec_multi(data, cols, X):
    """Y[i, :] = sum_k data[i, k] X[cols[i, k], :]: the multi-RHS gather."""
    return ell_gather_matvec_multi_cuda(data, cols, X)


def reorder_ell(data, cols, perm):
    """Symmetric permutation A' = P A P^T of an ELL matrix (host setup).

    ``perm``: new index i holds old row perm[i] (e.g. from
    mesh.adjacency.reverse_cuthill_mckee).  Returns (data', cols') numpy
    arrays.
    """
    data = _numpy(data)
    cols = _numpy(cols)
    perm = np.asarray(perm)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return data[perm], inv[cols[perm]].astype(cols.dtype)
