"""BCSR (block-ELL) sparse matrix for vector-valued problems, as in
tpufem.sparse.bcsr.

Vector elements (2D/3D elasticity) couple nodes through dense b x b blocks
(b = components).  Storing one block per node-pattern slot, ``data [ns, K,
b, b]`` over the node adjacency ``cols [ns, K]``, keeps the index arrays b²
times smaller than scalar ELL.  DOFs are node-major, component-minor
(fem.space).

``matvec`` dispatches as ``ELLMatrix`` does: when the node pattern's
bandwidth is <= ``_AUTO_BAND_MAX`` the banded plan is built once and
cached, and every product runs the banded kernel (B12, sparse.ell_cuda);
otherwise the gather form runs, on a CUDA tensor the same kernel in
absolute-column mode.  On a CPU tensor both run their plain versions.  A
plan that cannot be built raises: the reference's warn-and-gather fallback
(``tpufem/sparse/bcsr.py:95-103``) is not ported.
"""
from __future__ import annotations

import torch

from tpufem_torch.assemble.dense import accumulate
from tpufem_torch.mesh.adjacency import ELLPattern
from tpufem_torch.sparse.ell import _AUTO_BAND_MAX, _bandwidth, _Linear
from tpufem_torch.sparse.ell_cuda import (_numpy, auto_block_rows,
                                          bcsr_band_plan,
                                          bcsr_gather_matvec_cuda,
                                          bcsr_matvec_cuda)

__all__ = ["BCSRMatrix", "assemble_bcsr", "assemble_bcsr_arrays",
           "apply_dirichlet_bcsr"]


class BCSRMatrix:
    """data [ns, K, b, b], cols [ns, K] (int32; the node pattern) tensors,
    diag_pos [ns] (the diagonal block's slot)."""

    def __init__(self, data, cols, diag_pos=None):
        self.data = data
        self.cols = cols
        self.diag_pos = diag_pos
        # banded cache: (plan, data_t, rel) on data's device | None once
        # resolved; "unresolved" until the first product
        self._band = "unresolved"

    @property
    def block_size(self):
        return self.data.shape[-1]

    @property
    def shape(self):
        n = self.data.shape[0] * self.block_size
        return (n, n)

    @property
    def dtype(self):
        return self.data.dtype

    def _resolve_band(self):
        """Build and cache the banded plan if the node pattern's bandwidth
        is <= ``_AUTO_BAND_MAX``."""
        if self._band == "unresolved":
            self._band = None
            if _bandwidth(_numpy(self.cols)) <= _AUTO_BAND_MAX:
                self.prime_band_plan()
        return self._band

    def resolve_band(self):
        """Resolve the banded path now under the automatic policy."""
        self._resolve_band()
        return self

    def prime_band_plan(self, block_rows=None, segment: bool = True,
                        cap_k: bool = False):
        """Build and cache the banded block plan unconditionally (any
        bandwidth: the block size covers it; ``block_rows=None`` picks the
        reference's ``auto_block_rows``).  Raises on failure.

        ``cap_k`` caps the block size by the block's K * b * b value
        planes (the reference's choice for Galerkin coarse levels with
        many slots); ``segment=False`` asks for the single-segment
        schedule.  The CUDA kernel gathers each column directly, so the
        schedule changes the plan, not the product."""
        cols = _numpy(self.cols)
        if block_rows is None:
            k = cols.shape[1] * self.block_size ** 2 if cap_k else None
            block_rows = auto_block_rows(_bandwidth(cols), cols.shape[0], k)
        plan, data_t = bcsr_band_plan(self.data, cols, block_rows=block_rows,
                                      segment=segment)
        dev = self.data.device
        self._band = (plan, torch.as_tensor(data_t, device=dev),
                      torch.as_tensor(plan.rel, device=dev))
        return self

    def _product(self, x):
        band = self._resolve_band()
        if band is None:
            return bcsr_gather_matvec_cuda(self.data, self.cols, x)
        plan, data_t, rel = band
        ns, b = self.data.shape[0], self.block_size
        # component-major view of the node-major vector, and back
        y = bcsr_matvec_cuda(plan, data_t, rel, x.reshape(ns, b).T)
        return y.T.reshape(-1)

    def matvec(self, x):
        return _Linear.apply(x, self._product)

    def __matmul__(self, x):
        return self.matvec(x)

    def diagonal_blocks(self):
        """The diagonal blocks [ns, b, b] (for block-Jacobi)."""
        if self.diag_pos is None:
            raise ValueError("BCSRMatrix needs diag_pos for its diagonal "
                             "blocks")
        rows = torch.arange(self.data.shape[0], device=self.data.device)
        return self.data[rows, self.diag_pos.long()]

    def to_dense(self):
        ns, k, b, _ = self.data.shape
        dev = self.data.device
        rows = (torch.arange(ns, device=dev)[:, None, None, None] * b
                + torch.arange(b, device=dev)[None, None, :, None])
        cols = (self.cols.long()[:, :, None, None] * b
                + torch.arange(b, device=dev)[None, None, None, :])
        A = torch.zeros((ns * b, ns * b), dtype=self.data.dtype, device=dev)
        return A.index_put_((rows.expand(ns, k, b, b).reshape(-1),
                             cols.expand(ns, k, b, b).reshape(-1)),
                            self.data.reshape(-1), accumulate=True)


def assemble_bcsr_arrays(slots, cols, diag_pos, element_matrices,
                         block_size: int) -> BCSRMatrix:
    """Local matrices [NE, nl*b, nl*b] (node-major, component-minor) -> a
    BCSRMatrix on the node pattern, with the flat [NE*nl*nl] scatter plan
    ``slots`` and the pattern's ``cols`` / ``diag_pos`` given as arrays.
    The blocks are summed with ``accumulate`` (deterministic on every
    device)."""
    ke = element_matrices
    dev = ke.device
    cols = torch.as_tensor(cols, device=dev)
    ns, K = cols.shape
    ne = ke.shape[0]
    b = block_size
    nl = ke.shape[1] // b
    blocks = ke.reshape(ne, nl, b, nl, b).permute(0, 1, 3, 2, 4).reshape(
        -1, b, b)
    index = torch.as_tensor(slots, device=dev).reshape(-1).long()
    flat = accumulate(ns * K, index, blocks)
    return BCSRMatrix(data=flat.reshape(ns, K, b, b), cols=cols,
                      diag_pos=None if diag_pos is None
                      else torch.as_tensor(diag_pos, device=dev))


def assemble_bcsr(pattern: ELLPattern, element_matrices, block_size: int
                  ) -> BCSRMatrix:
    """Local matrices [NE, nl*b, nl*b] -> BCSR on the scalar node pattern
    (``pattern`` built over the scalar DOF connectivity)."""
    return assemble_bcsr_arrays(pattern.slots, pattern.cols, pattern.diag_pos,
                                element_matrices, block_size)


def apply_dirichlet_bcsr(A: BCSRMatrix, b_vec, bc_mask, bc_values=None):
    """Symmetric DOF-level Dirichlet elimination on a BCSR system.  Returns
    (A, b); the given A is not modified.  The product A g is a one-time
    setup product on the pre-BC matrix: the gather form (B12's
    absolute-column mode on a CUDA tensor), as ``apply_dirichlet_ell``."""
    mask = torch.as_tensor(bc_mask, dtype=torch.bool, device=b_vec.device)
    if bc_values is None:
        g = torch.zeros_like(b_vec)
    else:
        g = torch.as_tensor(bc_values, dtype=b_vec.dtype,
                            device=b_vec.device).broadcast_to(b_vec.shape)
    g = torch.where(mask, g, 0.0)
    b_vec = b_vec - bcsr_gather_matvec_cuda(A.data, A.cols, g)
    b_vec = torch.where(mask, g, b_vec)

    ns, K, bs, _ = A.data.shape
    mask_b = mask.reshape(ns, bs)
    row_keep = (~mask_b).to(A.data.dtype)                 # [ns, b]
    col_keep = (~mask_b[A.cols.long()]).to(A.data.dtype)  # [ns, K, b]
    data = A.data * row_keep[:, None, :, None] * col_keep[:, :, None, :]
    # identity on constrained diagonal entries
    rows = torch.arange(ns, device=data.device)
    dpos = A.diag_pos.long()
    eye = torch.eye(bs, dtype=data.dtype, device=data.device)
    data[rows, dpos] = data[rows, dpos] + mask_b[:, :, None] * eye
    return BCSRMatrix(data, A.cols, A.diag_pos), b_vec
