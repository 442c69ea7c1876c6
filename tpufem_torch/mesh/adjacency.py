"""Mesh adjacency, ELL sparsity patterns and the assembly scatter plan (host
numpy), as in tpufem.mesh.adjacency.

The pattern, and the ELL slot of every one of the NE*npe*npe local-matrix
entries, is precomputed here once; the device then performs one
scatter-add with the precomputed flat slot indices, or a
gather-by-permutation + sorted segment sum.

The native host library (``tpufem_torch.native``, the JAX package's C++
source built at first use) takes the paths the reference gives it:
``reverse_cuthill_mckee`` with ``use_native=True`` (the default) and
``ell_pattern`` with ``with_sort_plan=False``.  The numpy code stays the
executable specification; the native one equals it exactly.  Where the
library cannot be built, those calls raise (the reference falls back to
numpy without a word); ``use_native=False`` runs the numpy version.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["node_adjacency", "ELLPattern", "ell_pattern",
           "greedy_element_coloring", "pattern_unique_keys",
           "slots_for_conn", "reverse_cuthill_mckee"]


def reverse_cuthill_mckee(cols: np.ndarray, *,
                          use_native: bool = True) -> np.ndarray:
    """Level-wise reverse Cuthill-McKee ordering from an ELL cols array.

    Returns ``perm`` with new index i holding old node ``perm[i]``; applying
    it shrinks the matrix bandwidth to about one mesh line, the
    precondition of the banded ELL kernel (sparse.ell_cuda).  BFS runs a
    whole level per step, ordering each level by (first parent's rank,
    degree); the start of each component is pseudo-peripheral (George-Liu).
    Self-loop padding entries are ignored.  ``use_native=True`` runs the
    native library's exact copy (and raises if it cannot be built).
    """
    cols = np.asarray(cols)
    n, K = cols.shape
    if use_native:
        from tpufem_torch import native
        return native.reverse_cuthill_mckee(cols)
    rows = np.repeat(np.arange(n, dtype=np.int64), K)
    c = cols.reshape(-1).astype(np.int64)
    m = rows != c                        # drop self/padding entries
    rows, c = rows[m], c[m]
    order_r = np.argsort(rows, kind="stable")
    rows, c = rows[order_r], c[order_r]
    deg = np.bincount(rows, minlength=n)
    row_start = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=row_start[1:])

    def neighbors_of(frontier):
        counts = deg[frontier]
        total = int(counts.sum())
        if total == 0:
            return (np.empty(0, np.int64),) * 2
        offs = np.zeros(frontier.size, dtype=np.int64)
        np.cumsum(counts[:-1], out=offs[1:])
        pos = np.arange(total, dtype=np.int64) - np.repeat(offs, counts)
        idx = np.repeat(row_start[frontier], counts) + pos
        src = np.repeat(frontier, counts)          # edge sources
        return src, c[idx]

    def bfs_levels(start, visited):
        """Run one component's BFS; returns the list of ordered levels."""
        frontier = np.array([start], dtype=np.int64)
        visited[start] = True
        levels = []
        while frontier.size:
            levels.append(frontier)
            src, nbrs = neighbors_of(frontier)
            fresh = ~visited[nbrs]
            src, nbrs = src[fresh], nbrs[fresh]
            if nbrs.size == 0:
                break
            pos = np.empty(n, dtype=np.int64)
            pos[frontier] = np.arange(frontier.size)
            rank = np.full(n, np.iinfo(np.int64).max, dtype=np.int64)
            np.minimum.at(rank, nbrs, pos[src])
            frontier = np.unique(nbrs)
            order = np.lexsort((deg[frontier], rank[frontier]))
            frontier = frontier[order]
            visited[frontier] = True
        return levels

    visited = np.zeros(n, bool)
    out = np.empty(n, dtype=np.int64)
    filled = 0
    big = np.iinfo(np.int64).max
    deg_masked = deg.astype(np.int64).copy()
    while filled < n:
        deg_masked[visited] = big
        start = int(np.argmin(deg_masked))
        depth = -1
        for _ in range(4):
            levels = bfs_levels(start, visited.copy())
            if len(levels) <= depth:
                break
            depth = len(levels)
            last = levels[-1]
            start = int(last[np.argmin(deg[last])])
        levels = bfs_levels(start, visited)
        for lvl in levels:
            out[filled:filled + lvl.size] = lvl
            filled += lvl.size
    return out[::-1].copy()


def _unique_pairs(conn: np.ndarray, num_nodes: int):
    """Sorted unique (row, col) pairs of the FEM sparsity pattern: every
    element couples all of its nodes pairwise, self-pairs included.
    Returns (unique keys, their rows, their cols, every entry's key
    row * num_nodes + col in element order)."""
    npe = conn.shape[1]
    c64 = conn.astype(np.int64)
    rows = np.repeat(c64, npe, axis=1).ravel()          # [NE*npe*npe]
    cols = np.tile(c64, (1, npe)).ravel()
    keys = rows * num_nodes + cols
    unique_keys = np.unique(keys)                        # sorted ascending
    return (unique_keys, unique_keys // num_nodes, unique_keys % num_nodes,
            keys)


def node_adjacency(conn: np.ndarray, num_nodes: int,
                   max_length: int | None = None):
    """Per-node sorted neighbour lists (self included), fixed width.

    Returns (lengths [NN] int32, indices [NN, K] int32); padding slots hold
    the node's own index so gathers stay in bounds.
    """
    _, urows, ucols, _ = _unique_pairs(conn, num_nodes)
    lengths = np.bincount(urows, minlength=num_nodes).astype(np.int32)
    K = int(lengths.max()) if max_length is None else int(max_length)
    if lengths.max() > K:
        raise ValueError(
            f"max_length={K} smaller than max row degree {int(lengths.max())}")
    row_start = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(lengths, out=row_start[1:])
    pos = np.arange(urows.size, dtype=np.int64) - row_start[urows]
    indices = np.repeat(np.arange(num_nodes, dtype=np.int32)[:, None], K,
                        axis=1)
    indices[urows, pos] = ucols.astype(np.int32)
    return lengths, indices


@dataclasses.dataclass(frozen=True)
class ELLPattern:
    """Fixed-width (ELL) sparsity pattern + assembly scatter plan.

    cols:         [NN, K] int32 column index per slot (padding = own row)
    row_lengths:  [NN]    int32 true row degrees
    slots:        [NE, npe, npe] int32 flat slot index (row*K + position)
                  of every local-matrix entry
    perm:         [NE*npe*npe] int64 permutation sorting entries by slot
    sorted_slots: [NE*npe*npe] int32 slot ids after permutation (ascending)
    diag_pos:     [NN] int32 within-row position of the diagonal entry
    unique_keys:  [nnz] int64 sorted flat keys row*NN+col of stored entries
    nnz:          true number of stored entries
    """

    cols: np.ndarray
    row_lengths: np.ndarray
    slots: np.ndarray
    perm: np.ndarray
    sorted_slots: np.ndarray
    diag_pos: np.ndarray
    unique_keys: np.ndarray
    nnz: int

    @property
    def num_rows(self) -> int:
        return self.cols.shape[0]

    @property
    def width(self) -> int:
        return self.cols.shape[1]


def ell_pattern(conn: np.ndarray, num_nodes: int, pad_to: int | None = None,
                with_sort_plan: bool = True) -> ELLPattern:
    """Build the ELL pattern and the full scatter plan for assembly.

    ``pad_to`` rounds the row width up (8 in 2D, 16 in 3D by the solver's
    default).  ``with_sort_plan=False`` skips the plan consumed only by
    ``assemble_ell(method="sort")``.

    One argsort of the flat (row, col) keys drives everything: the sorted
    run starts give the unique pattern, the inverse permutation gives every
    entry's slot, and, since slot order equals key order, the argsort is
    the ``method="sort"`` plan (numpy's default introsort: not stable, but
    deterministic).

    With ``with_sort_plan=False`` the native library's row counting sort
    (O(nnz)) builds the pattern instead, as in the reference; its
    ``perm``, ``sorted_slots`` and ``unique_keys`` are then None.
    """
    npe = conn.shape[1]
    if not with_sort_plan:
        from tpufem_torch import native
        guess = pad_to or (2 * npe + 2)
        cols, lengths, diag_pos, slots = native.ell_pattern2(
            conn, num_nodes, width_guess=guess)
        K = cols.shape[1]
        if pad_to is not None and K % pad_to:
            K = ((K + pad_to - 1) // pad_to) * pad_to
            cols, lengths, diag_pos, slots = native.ell_pattern2(
                conn, num_nodes, width_guess=K)
        return ELLPattern(cols=cols, row_lengths=lengths, slots=slots,
                          perm=None, sorted_slots=None, diag_pos=diag_pos,
                          unique_keys=None,
                          nnz=int(lengths.astype(np.int64).sum()))
    c64 = conn.astype(np.int64)
    keys = (np.broadcast_to(c64[:, :, None], (c64.shape[0], npe, npe))
            * num_nodes
            + c64[:, None, :]).reshape(-1)               # [NE*npe*npe]

    order = np.argsort(keys)
    skeys = keys[order]
    new_run = np.empty(skeys.size, bool)
    new_run[0] = True
    np.not_equal(skeys[1:], skeys[:-1], out=new_run[1:])
    unique_keys = skeys[new_run]
    urows = unique_keys // num_nodes
    ucols = unique_keys % num_nodes

    lengths = np.bincount(urows, minlength=num_nodes).astype(np.int32)
    K = int(lengths.max())
    if pad_to is not None:
        K = max(K, 1)
        K = ((K + pad_to - 1) // pad_to) * pad_to
    row_start = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(lengths, out=row_start[1:])

    cols = np.repeat(np.arange(num_nodes, dtype=np.int32)[:, None], K, axis=1)
    pos_in_row = np.arange(urows.size, dtype=np.int64) - row_start[urows]
    cols[urows, pos_in_row] = ucols.astype(np.int32)

    # every (element, i, j) entry -> rank in the sorted order -> unique id
    # (cumulative run count) -> within-row position
    uid = np.cumsum(new_run, dtype=np.int64) - 1         # [NE*npe*npe]
    u = np.empty(keys.size, dtype=np.int64)
    u[order] = uid
    entry_rows = keys // num_nodes
    slot_flat = entry_rows * K + (u - row_start[entry_rows])
    slots = slot_flat.reshape(-1, npe, npe).astype(np.int32)

    if with_sort_plan:
        perm = order
        sorted_slots = slot_flat[order].astype(np.int32)
    else:
        perm = sorted_slots = None

    # within-row position of the diagonal (self-pairs are always present)
    diag_keys = np.arange(num_nodes, dtype=np.int64) * (num_nodes + 1)
    diag_u = np.searchsorted(unique_keys, diag_keys)
    diag_pos = (diag_u - row_start[:-1]).astype(np.int32)

    return ELLPattern(cols=cols, row_lengths=lengths, slots=slots, perm=perm,
                      sorted_slots=sorted_slots, diag_pos=diag_pos,
                      unique_keys=unique_keys, nnz=int(unique_keys.size))


def greedy_element_coloring(conn: np.ndarray, num_nodes: int) -> np.ndarray:
    """Color elements so that no two elements of one color share a node.

    Within one color every local-matrix entry scatters to a distinct
    matrix slot, so a plain (non-atomic) accumulate is race-free.
    Vectorized greedy: in each round every node elects its lowest-id
    uncolored element; the elements winning all their nodes take the
    round's color.  Returns colors [NE] int32 (0-based).
    """
    ne, npe = conn.shape
    colors = np.full(ne, -1, dtype=np.int32)
    remaining = np.arange(ne)
    color = 0
    while remaining.size:
        winner = np.full(num_nodes, np.iinfo(np.int64).max, dtype=np.int64)
        sub = conn[remaining]
        np.minimum.at(winner, sub.ravel(), np.repeat(remaining, npe))
        wins = (winner[sub] == remaining[:, None]).all(axis=1)
        colors[remaining[wins]] = color
        remaining = remaining[~wins]
        color += 1
    return colors


def pattern_unique_keys(pattern: ELLPattern) -> np.ndarray:
    """Sorted flat keys row*NN+col of the pattern's stored entries,
    materialized from cols / row_lengths where the pattern does not hold
    them (the native pattern's ``unique_keys`` is None): rows ascend, and
    columns ascend within each row's real slots."""
    if pattern.unique_keys is not None:
        return pattern.unique_keys
    nn, K = pattern.cols.shape
    real = np.arange(K)[None, :] < pattern.row_lengths[:, None]
    keys_2d = (np.arange(nn, dtype=np.int64)[:, None] * nn
               + pattern.cols.astype(np.int64))
    return keys_2d[real]


def slots_for_conn(pattern: ELLPattern, conn: np.ndarray) -> np.ndarray:
    """Flat ELL slot index of every (i, j) DOF pair of an extra
    connectivity (e.g. boundary facets), all of whose pairs the pattern
    already holds (facet node pairs do: they co-occur in the owner
    element).  Returns [NC, n, n] int64 indices into data.reshape(-1)."""
    conn = np.asarray(conn, np.int64)
    nn, K = pattern.cols.shape
    unique_keys = pattern_unique_keys(pattern)
    row_start = np.zeros(nn + 1, dtype=np.int64)
    np.cumsum(pattern.row_lengths, out=row_start[1:])
    keys = (conn[:, :, None] * nn + conn[:, None, :]).reshape(-1)
    u = np.searchsorted(unique_keys, keys)
    if (u >= unique_keys.size).any() or not np.array_equal(
            unique_keys[np.minimum(u, unique_keys.size - 1)], keys):
        raise ValueError("connectivity pair missing from the ELL pattern")
    rows = keys // nn
    slots = rows * K + (u - row_start[rows])
    n = conn.shape[1]
    return slots.reshape(-1, n, n)
