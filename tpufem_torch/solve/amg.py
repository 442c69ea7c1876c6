"""Smoothed-aggregation algebraic multigrid for unstructured ELL systems,
as in tpufem.solve.amg.

Classical smoothed aggregation (Vanek/Mandel/Brezina '96): the setup runs
once on the host in float64 numpy (the JAX package's code, unchanged), with
the native host library (``tpufem_torch.native``) for the one sequential
loop (greedy aggregation) and the Galerkin product; the cycle runs on the
device.  Only what the reference puts on the device becomes tensors, in
``A.dtype`` on ``A``'s device: the level operators (``ELLMatrix``),
``inv_diag``, the interval scales ``tv``, ``emb`` and ``coarse_inv``.

* **Aggregation.**  ``greedy`` (Vanek's two-pass, aggregates numbered by
  their first fine node, so an RCM-ordered input keeps every coarse
  operator banded) or ``interval`` (fixed-stride windows along the RCM
  line; the transfers are a window sum / upsample plus one banded SpMV).
* **Transfers.**  ``transfer="banded"`` embeds the rectangular prolongator
  P [n_f, n_c] as a square banded matrix Qp on each aggregate's first fine
  node (Qr = Qp^T): a transfer is one square banded SpMV (kernel B9) and a
  sorted 1-D gather or scatter of the coarse vector.  ``"gather"`` applies
  P and P^T as their own ELL matrices (B9's absolute-column mode).
* **Cycle.**  Chebyshev polynomial smoothers in D^-1 A, Galerkin coarse
  operators and an exact dense coarsest solve: a fixed SPD operator, so a
  valid CG preconditioner.  ``apply_multi`` runs the same cycle on [n, q]
  blocks through the multi-RHS kernel B10.

Plans.  On the card (``A.data.device.type == "cuda"``) every level
operator and transfer matrix gets its banded plan at setup (the
reference's TPU branch, ``_prime_wide``), and a plan that cannot be built
raises: the reference drops such a failure without a word.  On the CPU
nothing is primed, as in the reference off the TPU (the operators resolve
their plans lazily; the transfer matrices take the gather form).  The
reference's ``TPUFEM_BAND_DISPATCH`` switch and its pytree registration
exist for the TPU and ``jit`` and are not ported.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from tpufem_torch.sparse.ell import (_AUTO_BAND_MAX, ELLMatrix, _bandwidth,
                                     ell_matvec, ell_matvec_multi)
from tpufem_torch.sparse.ell_cuda import _numpy, auto_block_rows

__all__ = ["AMGLevel", "AMGHierarchy", "build_amg", "greedy_aggregate",
           "merge_isolated_singletons", "sym_dense_inv"]


# -- aggregation ----------------------------------------------------------------

def greedy_aggregate(cols: np.ndarray, *, use_native: bool = True):
    """Two-pass greedy aggregation over an ELL adjacency pattern.

    Returns ``(agg, n_agg)``: aggregate id per node, ids numbered by first
    (minimum) member node so an RCM-ordered input yields band-preserving
    coarse numbering.  Pass 1: any node whose entire neighborhood is
    unaggregated seeds an aggregate containing itself + neighbors.  Pass 2
    attaches the rest to the pass-1 aggregate most frequent among their
    neighbors (ties: smallest id); isolated leftovers become singletons.
    The numpy loop is the executable specification; the native C++ version
    (csrc/meshgen.cpp:tpufem_greedy_aggregate) is exact parity.
    ``use_native=True`` runs it, and raises if it cannot be built.
    """
    cols = np.asarray(cols, np.int32)
    n, K = cols.shape
    if use_native:
        from tpufem_torch import native
        agg, na = native.greedy_aggregate(cols)
        return _renumber_by_first(agg, na, n)
    agg = np.full(n, -1, np.int64)
    na = 0
    for i in range(n):                      # pass 1
        if agg[i] != -1:
            continue
        nb = cols[i]
        nb = nb[nb != i]
        if (agg[nb] != -1).any():
            continue
        agg[i] = na
        agg[nb] = na
        na += 1
    pass1 = agg.copy()
    for i in range(n):                      # pass 2 (reads pass-1 state)
        if agg[i] != -1:
            continue
        nb = cols[i]
        nbagg = pass1[nb[nb != i]]
        nbagg = nbagg[nbagg != -1]
        if nbagg.size:
            ids, cnt = np.unique(nbagg, return_counts=True)
            agg[i] = ids[np.argmax(cnt)]    # unique is sorted: ties -> min
        else:
            agg[i] = na                     # isolated: singleton
            na += 1
    return _renumber_by_first(agg, na, n)


def merge_isolated_singletons(agg, nc, iso, group: int = 16,
                              span: Optional[int] = None):
    """Group decoupled singleton rows into positional aggregates.

    Symmetric Dirichlet elimination leaves constrained rows with NO
    off-diagonal coupling; greedy aggregation then makes each a pass-2
    singleton at EVERY level, so the ~4*sqrt(n) boundary rows of a 2D
    mesh never coarsen and eventually dominate the hierarchy (measured:
    the 491k-DOF scalar coarsest was 2833 rows of which 2800 were the
    boundary; the 982k-DOF block coarsest 10506 blocks / 319 s dense
    factorization — BENCH_NOTES r5 phases E1/E3).  Isolated rows carry
    no coupling at all, so ANY grouping is spectrally exact: coarse
    entries between group members are zero and the group's Galerkin
    diagonal stays identity-like.

    Groups follow the (RCM) row order AND are span-capped: boundary
    rows are ~bandwidth-spaced along an RCM order, so an unbounded
    group would stretch over group*bw fine rows — the embedded
    restriction Qr then carries the whole group in its first-member ROW
    (K += group) with bandwidth = the group span, which blew the b=3
    BCSR kernel's VMEM at 982k DOFs (94.5 MB window, hw r5 phase F1).
    ``span`` bounds last-first within a group (callers pass ~2x the
    level bandwidth); ``group`` bounds the member count (K growth).

    ``iso``: bool [n], rows with no nonzero off-diagonal entry.
    Returns the (compacted, renumbered-by-first) ``(agg, n_agg)``.
    """
    nloc = agg.shape[0]
    sizes = np.bincount(agg, minlength=nc)
    idx = np.nonzero(iso & (sizes[agg] == 1))[0]
    if idx.size < 2:
        return agg, nc
    span = int(span) if span is not None else nloc
    agg = np.asarray(agg).copy()
    gstart = idx[0]
    count = 0
    target = np.empty(idx.size, dtype=np.int64)
    for t, i in enumerate(idx):
        if count >= int(group) or i - gstart > span:
            gstart, count = i, 0
        target[t] = gstart
        count += 1
    agg[idx] = agg[target]                   # group takes 1st member's id
    uniq, agg = np.unique(agg, return_inverse=True)
    return _renumber_by_first(agg.astype(np.int64), uniq.size, nloc)


def sym_dense_inv(dense: np.ndarray) -> np.ndarray:
    """Inverse (or pseudo-inverse) of a dense symmetric matrix, on host.

    Cholesky-based (LAPACK dpotrf/dpotri, ~2n^3/3 flops) when the matrix
    is positive definite — measured 2.4 s vs np.linalg.eigh's 16.5 s at
    n=4000 on one host core, and the block-AMG coarsest at 982k DOFs paid
    393.9 s in eigh (BENCH_NOTES r5 phase C1) — with an eigh pseudo-inverse
    fallback when the coarsest carries a (near-)null space (stalled
    coarsening, pure-Neumann blocks).  Returns an exactly symmetric array.
    """
    dense = 0.5 * (dense + dense.T)
    try:
        from scipy.linalg import lapack
        c, info = lapack.dpotrf(dense, lower=1)
        if info == 0:
            inv, info = lapack.dpotri(c, lower=1)
            if info == 0:
                inv = np.tril(inv) + np.tril(inv, -1).T
                if np.isfinite(inv).all():
                    return inv
    except ImportError:
        pass
    w, V = np.linalg.eigh(dense)
    cut = np.abs(w).max() * max(dense.shape[0], 1) * np.finfo(np.float64).eps
    winv = np.where(np.abs(w) > cut, 1.0 / np.where(w != 0.0, w, 1.0), 0.0)
    return (V * winv) @ V.T


def _renumber_by_first(agg, na, n):
    """Renumber aggregate ids by minimum member node.  Any id assignment
    with the same partition normalizes to the same result, so the native
    and numpy paths agree bit-for-bit; on RCM input the coarse numbering
    then sweeps the band in fine order (band-preserving)."""
    first = np.full(na, n, np.int64)
    np.minimum.at(first, agg, np.arange(n, dtype=np.int64))
    order = np.argsort(first, kind="stable")
    rank = np.empty(na, np.int64)
    rank[order] = np.arange(na, dtype=np.int64)
    return rank[agg], na


# -- host-side sparse helpers (numpy, vectorized) -------------------------------

def _coo_dedup(rows, cols, vals, ncols):
    """Sum duplicate (row, col) COO entries.  Returns sorted (r, c, v)."""
    key = rows.astype(np.int64) * np.int64(ncols) + cols
    order = np.argsort(key, kind="stable")
    key = key[order]
    vals = vals[order]
    first = np.empty(key.shape, bool)
    first[0] = True
    np.not_equal(key[1:], key[:-1], out=first[1:])
    starts = np.flatnonzero(first)
    v = np.add.reduceat(vals, starts)
    k = key[starts]
    return (k // ncols).astype(np.int64), (k % ncols).astype(np.int64), v


def _coo_to_ell(rows, cols, vals, nrows, pad_cols=None):
    """(row-sorted, deduped) COO -> ELL data [n, K] / cols [n, K].

    Padding slots point at ``pad_cols[i]`` (default: own row) with value 0
    — the gather matvec needs no mask.  Real entries fill slots 0..len-1,
    so a row's first ``cols == row`` hit is always the real diagonal.
    """
    counts = np.bincount(rows, minlength=nrows).astype(np.int64)
    K = max(1, int(counts.max()))
    starts = np.zeros(nrows + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(rows.size, dtype=np.int64) - starts[rows]
    if pad_cols is None:
        pad_cols = np.arange(nrows, dtype=np.int64)
    data = np.zeros((nrows, K), vals.dtype)
    ell_cols = np.broadcast_to(pad_cols[:, None], (nrows, K)).copy()
    data[rows, pos] = vals
    ell_cols[rows, pos] = cols
    return data, ell_cols.astype(np.int32)


def _ell_to_coo(data, cols):
    """ELL -> COO, dropping zero-valued entries except the diagonal."""
    n, K = data.shape
    rows = np.repeat(np.arange(n, dtype=np.int64), K)
    c = cols.astype(np.int64).ravel()
    v = data.ravel()
    keep = (v != 0) | (rows == c)   # padding aliases diag with 0: dedup sums
    return rows[keep], c[keep], v[keep]


def _spmm_ell_coo(a_data, a_cols, p_data, p_cols, n_coarse, chunk):
    """C = A @ P for A, P in zero-padded ELL; returns deduped COO of C.

    Triplet expansion per fine-row chunk: N*K*Kp raw triplets, deduped
    chunkwise to bound memory; chunks own disjoint row ranges so the
    concatenation stays deduped and row-sorted.
    """
    n = a_data.shape[0]
    out = []
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        ad = a_data[s:e]                      # [m, K]
        ac = a_cols[s:e].astype(np.int64)     # [m, K]
        pd = p_data[ac]                       # [m, K, Kp]
        pc = p_cols[ac].astype(np.int64)      # [m, K, Kp]
        kkp = ad.shape[1] * pd.shape[2]
        vals = (ad[:, :, None] * pd).ravel()
        rows = np.repeat(np.arange(s, e, dtype=np.int64), kkp)
        cols = pc.ravel()
        keep = vals != 0
        keep[::kkp] = True                    # keep every row alive
        out.append(_coo_dedup(rows[keep], cols[keep], vals[keep], n_coarse))
    return (np.concatenate([o[0] for o in out]),
            np.concatenate([o[1] for o in out]),
            np.concatenate([o[2] for o in out]))


def _spmm_t_coo(p_data, p_cols, c_rows, c_cols, c_vals, n_coarse, chunk):
    """G = P^T @ C for P in zero-padded ELL and C in row-sorted COO."""
    parts = []
    m = c_rows.size
    Kp = p_data.shape[1]
    for s in range(0, m, chunk):
        e = min(m, s + chunk)
        ci = c_rows[s:e]
        w = p_data[ci]                        # [mm, Kp]
        a = p_cols[ci].astype(np.int64)       # [mm, Kp]
        vals = (c_vals[s:e, None] * w).ravel()
        rows = a.ravel()
        cols = np.repeat(c_cols[s:e], Kp)
        keep = vals != 0
        keep[::Kp] = True
        parts.append(_coo_dedup(rows[keep], cols[keep], vals[keep],
                                n_coarse))
    r = np.concatenate([p[0] for p in parts])
    c = np.concatenate([p[1] for p in parts])
    v = np.concatenate([p[2] for p in parts])
    return _coo_dedup(r, c, v, n_coarse)



# -- hierarchy ------------------------------------------------------------------

class AMGLevel(NamedTuple):
    A: ELLMatrix            # level operator (banded ELL, kernel B9)
    inv_diag: torch.Tensor  # 1 / diag(A)
    lmax: float             # Gershgorin bound on spec(D^-1 A)
    p_data: torch.Tensor    # prolongator ELL values   [n_f, Kp]   (gather)
    p_cols: torch.Tensor    # prolongator ELL columns  [n_f, Kp]   (gather)
    r_data: torch.Tensor    # restriction (= P^T) values [n_c, Kr] (gather)
    r_cols: torch.Tensor    # restriction ELL columns    [n_c, Kr] (gather)
    # interval (fixed-stride contiguous) aggregation: transfers are a
    # window sum / upsample plus one banded SpMV
    s: int = 0              # aggregate stride (0 = greedy)
    tv: torch.Tensor = None  # [n_f] tentative scales 1/sqrt(|agg|)
    omega: float = 0.0      # prolongator smoothing weight
    # greedy + banded-embedded transfers: P [n_f, n_c] embedded as a SQUARE
    # banded matrix (column c at fine column emb[c], the aggregate's first
    # member); Qr = Qp^T
    Qp: ELLMatrix = None    # embedded prolongator  [n_f, n_f]
    Qr: ELLMatrix = None    # embedded restriction  [n_f, n_f]
    emb: torch.Tensor = None  # [n_c] int64, first fine member per aggregate
    # interval transfers with the tv / omega / inv_diag scalings folded
    # into operator copies (float64 on the host): one banded SpMV each,
    #   restrict: w = Rop @ res;  prolong: x = Pop @ upsample(xc)
    Rop: ELLMatrix = None
    Pop: ELLMatrix = None


class AMGHierarchy(NamedTuple):
    levels: tuple           # tuple[AMGLevel], fine -> coarse
    coarse_inv: torch.Tensor  # dense inverse of the coarsest operator
    smoother_degree: int
    smoother_ratio: float
    operator_complexity: float   # sum(nnz of all A_l) / nnz(A_0)
    gamma: int = 1          # coarse visits per cycle: 1 = V-cycle, 2 = W

    def apply(self, r):
        """z = cycle(r): the SPD preconditioner application."""
        return _vcycle(self, 0, r)

    def __call__(self, r):
        return self.apply(r)

    def apply_multi(self, R):
        """Z = cycle(R) column-wise for R [n, q]: one matrix stream per
        level visit for all q columns (kernel B10)."""
        return _vcycle_multi(self, 0, R)


def _on_card(t) -> bool:
    return isinstance(t, torch.Tensor) and t.device.type == "cuda"


def _prime_wide(M: ELLMatrix, cols_np, segment: bool = True):
    """Build M's banded plan now, on the card: every hierarchy matrix gets
    its plan at setup, wide bands included (the reference's TPU branch).
    Under ``_AUTO_BAND_MAX`` the plan takes the reference's automatic
    block size, over it one that covers the band.  A plan that cannot be
    built raises (the reference's ``except Exception: pass`` is not
    ported).  On the CPU nothing is primed.  Returns the route: "banded",
    or None where nothing was done."""
    if M._band != "unresolved" or not _on_card(M.data):
        return None
    n, k = cols_np.shape
    bw = _bandwidth(cols_np)
    block_rows = (auto_block_rows(bw, n, k) if bw <= _AUTO_BAND_MAX
                  else None)
    M.prime_band_plan(block_rows, segment=segment)
    return "banded"


def _diag_of(data, cols):
    """Row diagonal, robust to zero-valued padding aliasing it."""
    n = data.shape[0]
    return np.where(cols == np.arange(n, dtype=np.int64)[:, None],
                    data, 0.0).sum(1)


def _cheb_coeffs(degree, lmax, ratio):
    """rho recurrence of the Chebyshev smoother (host floats)."""
    lmin = lmax / ratio
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta
    rhos = []
    rho = 1.0 / sigma1
    for _ in range(degree):
        rhos.append(rho)
        rho = 1.0 / (2.0 * sigma1 - rho)
    return theta, delta, rhos


def _cheb_smooth(mv, inv_d, lmax, degree, ratio, r0):
    """z ~ A^-1 r0 by the degree-m Chebyshev polynomial in D^-1 A, over
    [lmax / ratio, lmax] (coarse levels own everything below).  ``mv`` is
    any matvec closure (the distributed cycle passes its halo SpMV)."""
    theta, delta, rhos = _cheb_coeffs(degree, lmax, ratio)
    d = (inv_d * r0) / theta
    z = d
    r = r0
    for k in range(1, degree):
        r = r - mv(d)
        d = rhos[k] * rhos[k - 1] * d + (2.0 * rhos[k] / delta) * (inv_d * r)
        z = z + d
    return z


def _smooth(level: AMGLevel, degree, ratio, r0):
    return _cheb_smooth(level.A.matvec, level.inv_diag, level.lmax,
                        degree, ratio, r0)


def _smooth_multi(level: AMGLevel, degree, ratio, R0):
    return _cheb_smooth(level.A.matvec_multi, level.inv_diag[:, None],
                        level.lmax, degree, ratio, R0)


def _window_sum(w, s):
    n = w.shape[0]
    nc = -(-n // s)
    pad = w.new_zeros((nc * s - n,) + tuple(w.shape[1:]))
    return torch.cat([w, pad]).reshape((nc, s) + tuple(w.shape[1:])).sum(1)


def _restrict(lv: AMGLevel, res):
    """rc = P^T res: (Qr res)[emb] (embedded), P^T's own ELL (gather), or
    the interval window sum of Rop res."""
    if lv.emb is not None:
        return lv.Qr.matvec(res)[lv.emb]
    if lv.s == 0:
        return ell_matvec(lv.r_data, lv.r_cols, res)
    if lv.Rop is not None:
        w = lv.Rop.matvec(res)
    else:
        w = lv.tv * (res - lv.omega * lv.A.matvec(lv.inv_diag * res))
    return _window_sum(w, lv.s)


def _prolong(lv: AMGLevel, xc):
    """x = P xc: Qp (xc scattered at emb), P's ELL, or Pop upsample(xc)."""
    if lv.emb is not None:
        xe = xc.new_zeros(lv.Qp.data.shape[0])
        xe[lv.emb] = xc
        return lv.Qp.matvec(xe)
    if lv.s == 0:
        return ell_matvec(lv.p_data, lv.p_cols, xc)
    n = lv.tv.shape[0]
    u = torch.repeat_interleave(xc, lv.s, dim=0)[:n]
    if lv.Pop is not None:
        return lv.Pop.matvec(u)
    t = lv.tv * u
    return t - lv.omega * (lv.inv_diag * lv.A.matvec(t))


def _restrict_multi(lv: AMGLevel, res):
    """_restrict on [n, q] blocks."""
    if lv.emb is not None:
        return lv.Qr.matvec_multi(res)[lv.emb]
    if lv.s == 0:
        return ell_matvec_multi(lv.r_data, lv.r_cols, res)
    if lv.Rop is not None:
        w = lv.Rop.matvec_multi(res)
    else:
        w = lv.tv[:, None] * (
            res - lv.omega * lv.A.matvec_multi(lv.inv_diag[:, None] * res))
    return _window_sum(w, lv.s)


def _prolong_multi(lv: AMGLevel, xc):
    """_prolong on [n_c, q] blocks."""
    if lv.emb is not None:
        xe = xc.new_zeros((lv.Qp.data.shape[0], xc.shape[1]))
        xe[lv.emb] = xc
        return lv.Qp.matvec_multi(xe)
    if lv.s == 0:
        return ell_matvec_multi(lv.p_data, lv.p_cols, xc)
    n = lv.tv.shape[0]
    u = torch.repeat_interleave(xc, lv.s, dim=0)[:n]
    if lv.Pop is not None:
        return lv.Pop.matvec_multi(u)
    t = lv.tv[:, None] * u
    return t - lv.omega * (lv.inv_diag[:, None] * lv.A.matvec_multi(t))


def _vcycle_multi(h: AMGHierarchy, l: int, R):
    """The V/W-cycle on [n, q] blocks."""
    if l == len(h.levels):
        return h.coarse_inv @ R
    lv = h.levels[l]
    deg, ratio = h.smoother_degree, h.smoother_ratio
    X = _smooth_multi(lv, deg, ratio, R)
    res = R - lv.A.matvec_multi(X)
    rc = _restrict_multi(lv, res)
    xc = _vcycle_multi(h, l + 1, rc)
    if h.gamma >= 2 and l + 1 < len(h.levels):
        cA = h.levels[l + 1].A
        xc = xc + _vcycle_multi(h, l + 1, rc - cA.matvec_multi(xc))
    X = X + _prolong_multi(lv, xc)
    X = X + _smooth_multi(lv, deg, ratio, R - lv.A.matvec_multi(X))
    return X


def _vcycle(h: AMGHierarchy, l: int, r):
    if l == len(h.levels):
        return h.coarse_inv @ r
    lv = h.levels[l]
    deg, ratio = h.smoother_degree, h.smoother_ratio
    x = _smooth(lv, deg, ratio, r)                       # pre-smooth (x0=0)
    res = r - lv.A.matvec(x)
    rc = _restrict(lv, res)
    xc = _vcycle(h, l + 1, rc)
    # W-cycle (gamma=2): re-visit the coarse problem with its updated
    # residual; skipped when the next level is the dense exact solve
    if h.gamma >= 2 and l + 1 < len(h.levels):
        cA = h.levels[l + 1].A
        xc = xc + _vcycle(h, l + 1, rc - cA.matvec(xc))
    x = x + _prolong(lv, xc)                             # correct
    x = x + _smooth(lv, deg, ratio, r - lv.A.matvec(x))  # post-smooth
    return x


def build_amg(A: ELLMatrix, *, coarse_n: int = 1200, max_levels: int = 12,
              omega_scale: float = 4.0 / 3.0, smoother_degree: int = 2,
              smoother_ratio: float = 8.0, aggregation: str = "greedy",
              interval_size: int = 6, cycle: str = "V",
              strength: float = 0.0, transfer: str = "banded",
              chunk: int = 1 << 21, native_setup: bool = True,
              walls_out: Optional[dict] = None) -> AMGHierarchy:
    """Build a smoothed-aggregation hierarchy from a concrete ELL matrix.

    ``A`` should be RCM-ordered (banded): min-index-numbered aggregates
    then keep every coarse operator banded.  All setup math runs in
    float64 on the host; device tensors are cast to ``A.dtype`` on ``A``'s
    device.

    ``aggregation``: "greedy" (Vanek two-pass) or "interval" (fixed-stride
    contiguous aggregates of ``interval_size`` along the RCM line).
    ``transfer`` (greedy only): "banded" (square embedded Qp / Qr) or
    "gather" (P and P^T as their own ELL matrices).  ``strength`` > 0
    aggregates on the strength-filtered graph |a_ij| >= strength
    sqrt(|a_ii a_jj|).  ``cycle``: "V" or "W".

    ``native_setup``: greedy aggregation and the Galerkin product run in
    the native host library (True; raises if it cannot be built) or in the
    numpy specification (False), which give the same hierarchy.  The
    reference takes the library where it loads and numpy otherwise.

    ``walls_out``: optional dict filled with cumulative per-stage setup
    seconds (aggregate / smooth_p / galerkin / plans / transfers /
    coarse_inv); ``coarse_rows``, ``levels`` (rows per level),
    ``operator_complexity``, and ``gather``: the operators that ride the
    gather form on the card (none: every one gets its banded plan).
    """
    if aggregation not in ("greedy", "interval"):
        raise ValueError(f"unknown aggregation {aggregation!r}")
    if cycle not in ("V", "W"):
        raise ValueError(f"unknown cycle {cycle!r}")
    if transfer not in ("banded", "gather"):
        raise ValueError(f"unknown transfer {transfer!r}")
    import time

    def _tick(key, t0):
        if walls_out is not None:
            walls_out[key] = (walls_out.get(key, 0.0)
                              + time.perf_counter() - t0)
        return time.perf_counter()

    data = _numpy(A.data).astype(np.float64)
    cols = _numpy(A.cols)
    dtype = A.dtype
    dev = A.data.device
    on_card = _on_card(A.data)

    def tensor(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    def index(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    levels = []
    nnz0 = float(np.count_nonzero(data))
    nnz_total = nnz0
    fine_A = A

    for level_idx in range(max_levels):
        n = data.shape[0]
        if n <= coarse_n:
            break
        t0 = time.perf_counter()
        diag = _diag_of(data, cols)
        inv_d = np.where(diag != 0, 1.0 / diag, 1.0)
        if aggregation == "interval":
            s = int(interval_size)
            agg = np.arange(n, dtype=np.int64) // s
            nc = int((n - 1) // s) + 1
        else:
            agg_cols = cols
            if strength > 0.0:
                # classical SA strength-of-connection: keep (i, j) only if
                # |a_ij| >= theta sqrt(|a_ii a_jj|); weak edges point back
                # at their own row (= removed from the aggregation graph)
                ad = np.abs(diag)
                thr = strength * np.sqrt(
                    ad[:, None] * ad[cols.astype(np.int64)])
                keep = np.abs(data) >= thr
                agg_cols = np.where(
                    keep, cols,
                    np.arange(n, dtype=cols.dtype)[:, None]).astype(np.int32)
            agg, nc = greedy_aggregate(agg_cols, use_native=native_setup)
            if 2 * nc > n and strength > 0.0:
                # coarsening degraded (ratio < 2): retry on the full graph
                # (dense Galerkin levels leave the strength filter a
                # near-empty graph; BENCH_NOTES r5 phase E1)
                agg2, nc2 = greedy_aggregate(cols, use_native=native_setup)
                if nc2 < nc:
                    agg, nc = agg2, nc2
            # decoupled rows (symmetric Dirichlet elimination) are
            # permanent singletons: group them so they coarsen too
            # (span-capped at ~2x the level bandwidth so the embedded
            # transfers stay banded)
            iso = ~(((cols != np.arange(n, dtype=cols.dtype)[:, None])
                     & (data != 0)).any(axis=1))
            bw = int(np.abs(cols.astype(np.int64)
                            - np.arange(n, dtype=np.int64)[:, None]).max())
            agg, nc = merge_isolated_singletons(
                agg, nc, iso, span=max(2 * bw, 2048))
            if nc >= 0.7 * n:
                # still stalled: stop here and let the dense coarsest
                # solve take the remainder, unless that would be too large
                if n > max(4 * coarse_n, 20_000):
                    raise ValueError(
                        f"AMG coarsening stalled at {n} rows (aggregation "
                        f"produced {nc} aggregates) — too large for the "
                        "dense coarsest solve; lower `strength` or use "
                        "aggregation='interval'")
                break
        t0 = _tick("aggregate", t0)
        count = np.bincount(agg, minlength=nc).astype(np.float64)
        tval = 1.0 / np.sqrt(count)[agg]          # normalized tentative T

        lmax = float(np.max(np.abs(data).sum(1) * inv_d))   # Gershgorin
        omega = omega_scale / lmax

        # P = (I - omega D^-1 A) T  as deduped COO over [n, nc]
        ar, ac, av = _ell_to_coo(data, cols)
        pr = np.concatenate([ar, np.arange(n, dtype=np.int64)])
        pc = np.concatenate([agg[ac], agg])
        pv = np.concatenate([-omega * inv_d[ar] * av * tval[ac], tval])
        pr, pc, pv = _coo_dedup(pr, pc, pv, nc)
        p_data, p_cols = _coo_to_ell(pr, pc, pv, n, pad_cols=agg)
        t0 = _tick("smooth_p", t0)

        # Galerkin A_c = P^T (A P): the native single-pass product, or the
        # chunked numpy specification
        if native_setup:
            from tpufem_torch import native
            c_data, c_cols = native.galerkin_ell(data, cols, p_data, p_cols,
                                                 nc)
        else:
            cr, cc, cv = _spmm_ell_coo(data, cols, p_data, p_cols, nc,
                                       chunk)
            gr, gc, gv = _spmm_t_coo(p_data, p_cols, cr, cc, cv, nc, chunk)
            c_data, c_cols = _coo_to_ell(gr, gc, gv, nc)
        nnz_total += float(np.count_nonzero(c_data))
        t0 = _tick("galerkin", t0)

        Adev = fine_A if fine_A is not None else ELLMatrix(
            tensor(data), index(cols.astype(np.int32)))
        # every level operator's plan at setup on the card (the finest
        # included; a no-op where the caller primed it)
        _prime_wide(Adev, cols, segment=(level_idx == 0))
        fine_A = None
        t0 = _tick("plans", t0)
        if aggregation == "interval":
            # Rop = diag(tv)(I - omega A D^-1), Pop = (I - omega D^-1 A)
            # diag(tv) (= Rop^T), folded in float64
            c64 = cols.astype(np.int64)
            dslot = np.argmax(cols == np.arange(n)[:, None], axis=1)
            Rop = Pop = None
            if (cols[np.arange(n), dslot] == np.arange(n)).all():
                rop = -omega * tval[:, None] * data * inv_d[c64]
                pop = -omega * inv_d[:, None] * data * tval[c64]
                rop[np.arange(n), dslot] += tval
                pop[np.arange(n), dslot] += tval
                cols_dev = index(cols.astype(np.int32))
                Rop = ELLMatrix(tensor(rop), cols_dev)
                Pop = ELLMatrix(tensor(pop), cols_dev)
                if on_card:
                    _prime_wide(Rop, cols, segment=(level_idx == 0))
                    _prime_wide(Pop, cols, segment=(level_idx == 0))
                else:
                    Rop._band = Pop._band = None    # gather on the CPU
            levels.append(AMGLevel(
                A=Adev, inv_diag=tensor(inv_d), lmax=lmax,
                p_data=None, p_cols=None, r_data=None, r_cols=None,
                s=s, tv=tensor(tval), omega=float(omega),
                Rop=Rop, Pop=Pop))
        elif transfer == "banded":
            # P [n, nc] embedded as a SQUARE banded matrix on each
            # aggregate's first fine member (emb strictly increasing), so
            # Qp's bandwidth ~ fine bandwidth + aggregate span; Qr = Qp^T
            emb = np.full(nc, n, np.int64)
            np.minimum.at(emb, agg, np.arange(n, dtype=np.int64))
            qp_data, qp_cols = _coo_to_ell(pr, emb[pc], pv, n)
            rr, rc_, rv = _coo_dedup(emb[pc], pr, pv, n)
            qr_data, qr_cols = _coo_to_ell(rr, rc_, rv, n)
            Qp = ELLMatrix(tensor(qp_data), index(qp_cols))
            Qr = ELLMatrix(tensor(qr_data), index(qr_cols))
            if on_card:
                _prime_wide(Qp, qp_cols, segment=(level_idx == 0))
                _prime_wide(Qr, qr_cols, segment=(level_idx == 0))
            else:
                Qp._band = Qr._band = None          # gather on the CPU
            levels.append(AMGLevel(
                A=Adev, inv_diag=tensor(inv_d), lmax=lmax,
                p_data=None, p_cols=None, r_data=None, r_cols=None,
                Qp=Qp, Qr=Qr, emb=index(emb)))
        else:
            # restriction = P^T as its own ELL; pad slots point at each
            # aggregate's first member (valid, in-band)
            rr, rc_, rv = _coo_dedup(pc, pr, pv, n)
            r_pad = np.full(nc, n, np.int64)
            np.minimum.at(r_pad, agg, np.arange(n, dtype=np.int64))
            r_data, r_cols = _coo_to_ell(rr, rc_, rv, nc, pad_cols=r_pad)
            levels.append(AMGLevel(
                A=Adev, inv_diag=tensor(inv_d), lmax=lmax,
                p_data=tensor(p_data), p_cols=index(p_cols),
                r_data=tensor(r_data), r_cols=index(r_cols)))
        t0 = _tick("transfers", t0)
        data, cols = c_data, c_cols

    # coarsest: explicit dense inverse
    t0 = time.perf_counter()
    n = data.shape[0]
    dense = np.zeros((n, n))
    np.add.at(dense, (np.repeat(np.arange(n), data.shape[1]),
                      cols.astype(np.int64).ravel()), data.ravel())
    coarse_inv = tensor(sym_dense_inv(dense))
    _tick("coarse_inv", t0)
    if walls_out is not None:
        walls_out["coarse_rows"] = int(n)
        walls_out["levels"] = [int(lv.A.shape[0]) for lv in levels]
        walls_out["operator_complexity"] = nnz_total / nnz0
        walls_out["gather"] = _gather_routes(levels) if on_card else []

    return AMGHierarchy(levels=tuple(levels), coarse_inv=coarse_inv,
                        smoother_degree=int(smoother_degree),
                        smoother_ratio=float(smoother_ratio),
                        operator_complexity=nnz_total / nnz0,
                        gamma={"V": 1, "W": 2}[cycle])


def _gather_routes(levels) -> list:
    """Names of the hierarchy's matrices that ride the gather form."""
    out = []
    for i, lv in enumerate(levels):
        for name in ("A", "Qp", "Qr", "Rop", "Pop"):
            M = getattr(lv, name)
            if M is not None and M._band in (None, "unresolved"):
                out.append(f"{name}{i}")
        if lv.s == 0 and lv.emb is None:
            out += [f"P{i}", f"R{i}"]
    return out
