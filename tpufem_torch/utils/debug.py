"""Debug and validation of the precomputed index plans, as in
tpufem.utils.debug.

Assembly is race-free by construction (sorted, deterministic
accumulation), so the debug mode validates the plans that replace
atomics: the bounds and the slot / column consistency of an ELL pattern,
the agreement of the two assembly reductions (scatter and slot-sorted),
and the structure of an assembled operator (symmetry, row sums).  The
assertions are the reference's, in its order.
"""
from __future__ import annotations

import numpy as np
import torch

from tpufem_torch.mesh.adjacency import ELLPattern

__all__ = ["validate_ell_pattern", "check_assembly_agreement",
           "check_operator_invariants"]


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def validate_ell_pattern(pattern: ELLPattern, dof_conn, num_dofs: int):
    """Assert structural invariants of an ELL scatter plan.

    Raises AssertionError with a specific message on the first violation.
    """
    conn = _host(dof_conn)
    ne, npe = conn.shape
    K = pattern.width
    assert pattern.cols.shape == (num_dofs, K), "cols shape mismatch"
    assert pattern.slots.shape == (ne, npe, npe), "slots shape mismatch"
    # bounds
    assert pattern.slots.min() >= 0, "negative slot index"
    assert pattern.slots.max() < num_dofs * K, "slot index out of range"
    assert pattern.cols.min() >= 0 and pattern.cols.max() < num_dofs, \
        "column index out of range"
    # every slot's row is the entry's row DOF and its column the entry's
    # column DOF
    rows = pattern.slots // K
    pos = pattern.slots % K
    expect_rows = np.broadcast_to(conn[:, :, None], pattern.slots.shape)
    assert (rows == expect_rows).all(), "slot row != entry row"
    got_cols = pattern.cols[rows.reshape(-1), pos.reshape(-1)]
    expect_cols = np.broadcast_to(conn[:, None, :], pattern.slots.shape)
    assert (got_cols == expect_cols.reshape(-1)).all(), \
        "slot column != entry column"
    # diagonal positions really point at the diagonal
    r = np.arange(num_dofs)
    assert (pattern.cols[r, pattern.diag_pos] == r).all(), \
        "diag_pos does not point at the diagonal"
    # row lengths consistent with the padding convention (padding = own
    # row)
    for i in range(min(num_dofs, 64)):
        L = int(pattern.row_lengths[i])
        assert (np.sort(pattern.cols[i, :L]) == pattern.cols[i, :L]).all(), \
            f"row {i} columns not sorted"
    return True


def check_assembly_agreement(pattern: ELLPattern, element_matrices,
                             atol: float = 0.0, rtol: float = 1e-12):
    """Run both deterministic reductions (``assemble.ell.ell_values``
    with ``method="scatter"`` and ``"sort"``) and compare them."""
    from tpufem_torch.assemble.ell import ell_values

    Ke = torch.as_tensor(element_matrices)
    a = _host(ell_values(pattern, Ke, method="scatter"))
    b = _host(ell_values(pattern, Ke, method="sort"))
    if not np.allclose(a, b, atol=atol, rtol=rtol):
        bad = np.unravel_index(np.argmax(np.abs(a - b)), a.shape)
        raise AssertionError(
            f"scatter vs sorted-segment-sum disagree at {bad}: "
            f"{a[bad]} vs {b[bad]}")
    return True


def check_operator_invariants(A_dense_or_ell, *, symmetric: bool = True,
                              zero_row_sums: bool = False,
                              atol: float = 1e-10):
    """Structural checks on an assembled operator (before the boundary
    conditions): an ``ELLMatrix`` (anything with ``to_dense``), a tensor
    or an array."""
    A = A_dense_or_ell
    if hasattr(A, "to_dense"):
        A = A.to_dense()
    A = _host(A)
    if symmetric:
        d = np.abs(A - A.T).max()
        assert d <= atol, f"operator not symmetric: max asym {d}"
    if zero_row_sums:
        d = np.abs(A.sum(axis=1)).max()
        assert d <= atol, f"row sums not zero: max {d}"
    return True
