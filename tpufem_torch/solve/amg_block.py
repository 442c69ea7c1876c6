"""Block smoothed-aggregation AMG for BCSR systems (vector elasticity), as
in tpufem.solve.amg_block.

Nodal smoothed aggregation (Vanek/Mandel/Brezina '96, the vector form)
over the BCSR node graph.  The setup is the JAX package's float64 numpy,
unchanged, with the native host library (``tpufem_torch.native``) for the
blocked products; the cycle runs on the device, its products through
``BCSRMatrix.matvec`` (kernel B12, or B12g where a level's node band is
wider than ``_AUTO_BAND_MAX``).

* **Aggregation on the node graph**, strength-filtered by block Frobenius
  norms ||A_ij||_F >= theta sqrt(||A_ii||_F ||A_jj||_F): one aggregate
  groups whole nodes.
* **Near-null-space tentative prolongator.**  ``B [ns*b, m]``: the m = b
  translations (the default) or the rigid body modes
  (``rigid_body_modes(coords)``; m = 3 in 2D, 6 in 3D), QR-factored per
  aggregate, so every coarse level is a BCSR system of m x m blocks.
* **Block-diagonal smoothed prolongator** P = (I - omega Db^-1 A) T.
* **Banded-embedded transfers** (``transfer="banded"``, the default): P
  [ns x nc] (b x m blocks) is embedded as a SQUARE block matrix Qp on each
  aggregate's first fine node, each block zero-padded to p x p, p =
  max(b, m) (3 in 2D, 6 in 3D); a transfer is one banded block SpMV plus
  a sorted 1-D block scatter or gather.  ``transfer="gather"`` applies
  the block-ELL P and P^T directly (plain PyTorch: XLA's gather in the
  reference).
* **Cycle**: block-Chebyshev smoothers (the block-diagonal apply is a
  batched product, as in the reference), Galerkin coarse operators and
  one dense coarsest inverse: SPD, a valid CG preconditioner.

Plans.  On the card (``A.data.device.type == "cuda"``) the finest level
resolves its plan by the bandwidth rule (banded under
``_AUTO_BAND_MAX``, the gather kernel B12g above it) and every coarse
level and transfer matrix gets its banded plan at setup; a plan that
cannot be built raises (the reference, on the TPU, falls back with a
warning).  ``walls_out["gather"]`` names the matrices that ride B12g.  On
the CPU nothing is primed, as in the reference off the TPU.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from tpufem_torch.solve.amg import (_cheb_coeffs, greedy_aggregate,
                                    merge_isolated_singletons, sym_dense_inv)
from tpufem_torch.sparse.bcsr import BCSRMatrix
from tpufem_torch.sparse.ell_cuda import _numpy

__all__ = ["BlockAMGLevel", "BlockAMGHierarchy", "build_block_amg",
           "rigid_body_modes"]


def rigid_body_modes(coords: np.ndarray) -> np.ndarray:
    """Near-null space of the elasticity operator: translations + rotations.

    coords [ns, d] -> B [ns*d, m] with m = 3 (d=2) or 6 (d=3), node-major
    component-minor DOF order (tpufem.fem.space).  Columns: d unit
    translations, then the infinitesimal rotations about the domain center
    (centering keeps the columns well-conditioned before the per-aggregate
    QR).
    """
    c = np.asarray(coords, np.float64)
    ns, d = c.shape
    c = c - c.mean(axis=0)
    if d == 2:
        m = 3
        B = np.zeros((ns, d, m))
        B[:, 0, 0] = 1.0
        B[:, 1, 1] = 1.0
        B[:, 0, 2] = -c[:, 1]
        B[:, 1, 2] = c[:, 0]
    elif d == 3:
        m = 6
        B = np.zeros((ns, d, m))
        for k in range(3):
            B[:, k, k] = 1.0
        B[:, 1, 3] = -c[:, 2]; B[:, 2, 3] = c[:, 1]    # rot x
        B[:, 0, 4] = c[:, 2];  B[:, 2, 4] = -c[:, 0]   # rot y
        B[:, 0, 5] = -c[:, 1]; B[:, 1, 5] = c[:, 0]    # rot z
    else:
        raise ValueError(f"unsupported dim {d}")
    return B.reshape(ns * d, m)


# -- host-side blocked sparse helpers --------------------------------------

def _bcoo_dedup(rows, cols, vals, ncols):
    """Sum duplicate (row, col) block entries; vals [nnz, p, q].
    Returns sorted (r, c, v)."""
    key = rows.astype(np.int64) * np.int64(ncols) + cols
    order = np.argsort(key, kind="stable")
    key = key[order]
    vals = vals[order]
    first = np.empty(key.shape, bool)
    first[0] = True
    np.not_equal(key[1:], key[:-1], out=first[1:])
    starts = np.flatnonzero(first)
    v = np.add.reduceat(vals, starts, axis=0)
    k = key[starts]
    return (k // ncols).astype(np.int64), (k % ncols).astype(np.int64), v


def _bcoo_to_bell(rows, cols, vals, nrows):
    """(row-sorted, deduped) block COO -> data [n, K, p, q] / cols [n, K].
    Padding slots point at the own row with zero blocks."""
    p, q = vals.shape[1:]
    counts = np.bincount(rows, minlength=nrows).astype(np.int64)
    K = max(1, int(counts.max()))
    starts = np.zeros(nrows + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(rows.size, dtype=np.int64) - starts[rows]
    data = np.zeros((nrows, K, p, q), vals.dtype)
    ell_cols = np.broadcast_to(
        np.arange(nrows, dtype=np.int64)[:, None], (nrows, K)).copy()
    data[rows, pos] = vals
    ell_cols[rows, pos] = cols
    return data, ell_cols.astype(np.int32)


def _bell_to_bcoo(data, cols):
    """Block ELL -> block COO, dropping all-zero blocks except diagonals."""
    n, K = data.shape[:2]
    rows = np.repeat(np.arange(n, dtype=np.int64), K)
    c = cols.astype(np.int64).ravel()
    v = data.reshape(n * K, *data.shape[2:])
    keep = (v != 0).any(axis=(1, 2)) | (rows == c)
    return rows[keep], c[keep], v[keep]


def _bspmm(a_data, a_cols, p_data, p_cols, n_coarse, chunk):
    """C = A @ P for block-ELL A [n,K,b,b] and P [n,Kp,b,m]; deduped COO."""
    n, K = a_data.shape[:2]
    out = []
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        ad = a_data[s:e]                          # [r, K, b, b]
        ac = a_cols[s:e].astype(np.int64)         # [r, K]
        pd = p_data[ac]                           # [r, K, Kp, b, m]
        pc = p_cols[ac].astype(np.int64)          # [r, K, Kp]
        vals = np.einsum("rkxy,rkpym->rkpxm", ad, pd, optimize=True)
        kkp = K * pd.shape[2]
        b, m = vals.shape[3], vals.shape[4]
        vals = vals.reshape(-1, b, m)
        rows = np.repeat(np.arange(s, e, dtype=np.int64), kkp)
        cols = pc.reshape(-1)
        keep = (vals != 0).any(axis=(1, 2))
        keep[::kkp] = True                        # keep every row alive
        out.append(_bcoo_dedup(rows[keep], cols[keep], vals[keep],
                               n_coarse))
    return (np.concatenate([o[0] for o in out]),
            np.concatenate([o[1] for o in out]),
            np.concatenate([o[2] for o in out], axis=0))


def _bspmm_t(p_data, p_cols, c_rows, c_cols, c_vals, n_coarse, chunk):
    """G = P^T @ C for block-ELL P [n,Kp,b,m] and block COO C ([b,m])."""
    parts = []
    nnz = c_rows.size
    Kp = p_data.shape[1]
    for s in range(0, nnz, chunk):
        e = min(nnz, s + chunk)
        ci = c_rows[s:e]
        w = p_data[ci]                            # [r, Kp, b, m]
        a = p_cols[ci].astype(np.int64)           # [r, Kp]
        vals = np.einsum("rpbm,rbn->rpmn", w, c_vals[s:e], optimize=True)
        vals = vals.reshape(-1, vals.shape[2], vals.shape[3])
        rows = a.reshape(-1)
        cols = np.repeat(c_cols[s:e], Kp)
        keep = (vals != 0).any(axis=(1, 2))
        keep[::Kp] = True
        parts.append(_bcoo_dedup(rows[keep], cols[keep], vals[keep],
                                 n_coarse))
    r = np.concatenate([p[0] for p in parts])
    c = np.concatenate([p[1] for p in parts])
    v = np.concatenate([p[2] for p in parts], axis=0)
    return _bcoo_dedup(r, c, v, n_coarse)


def _block_diag_of(data, cols):
    """[ns, b, b] diagonal blocks (padding-safe)."""
    n = data.shape[0]
    mask = (cols == np.arange(n, dtype=np.int64)[:, None])
    return (data * mask[:, :, None, None]).sum(axis=1)


def _tentative(agg, nc, B, b):
    """Per-aggregate QR of the near-null space.

    Returns (t_data [ns, 1, b, m] block-ELL with cols=agg, Bc [nc*m, m]).
    Aggregates are processed batched by size (variable-size-safe); an
    aggregate with fewer rows than modes keeps a rank-deficient R (its
    zero rows are harmless in the Galerkin product but the caller should
    prefer m <= min aggregate size * b).
    """
    ns = agg.shape[0]
    m = B.shape[1]
    Bn = B.reshape(ns, b, m)
    order = np.argsort(agg, kind="stable")
    sizes = np.bincount(agg, minlength=nc)
    t_data = np.zeros((ns, 1, b, m))
    Bc = np.zeros((nc, m, m))
    starts = np.zeros(nc + 1, np.int64)
    np.cumsum(sizes, out=starts[1:])
    for sz in np.unique(sizes):
        ids = np.flatnonzero(sizes == sz)         # aggregates of this size
        # member nodes [na, sz] in fine order
        members = order[starts[ids][:, None] + np.arange(sz)]
        Ba = Bn[members].reshape(ids.size, sz * b, m)     # [na, sz*b, m]
        Q, R = np.linalg.qr(Ba)        # [na, sz*b, k], [na, k, m]
        k = Q.shape[2]                 # k = min(sz*b, m)
        # sign-normalize (diag(R) >= 0) so results don't depend on LAPACK
        sgn = np.sign(R[:, np.arange(k), np.arange(k)])
        sgn[sgn == 0] = 1.0
        Q = Q * sgn[:, None, :]
        R = R * sgn[:, :, None]
        if k < m:
            # aggregate too small to carry all m modes (e.g. a singleton
            # node with rotations): keep the k it supports, zero-pad — the
            # coarse B rows for the missing modes are zero, harmless in
            # the Galerkin product (pinv handles the coarsest singularity)
            Q = np.concatenate(
                [Q, np.zeros((ids.size, sz * b, m - k))], axis=2)
            R = np.concatenate(
                [R, np.zeros((ids.size, m - k, m))], axis=1)
        t_data[members.reshape(-1), 0] = Q.reshape(-1, b, m)
        Bc[ids] = R
    return t_data, Bc.reshape(nc * m, m)



# -- hierarchy ---------------------------------------------------------------

class BlockAMGLevel(NamedTuple):
    A: BCSRMatrix              # level operator [ns, K, b, b]
    inv_diag: torch.Tensor     # [ns, b, b] exact block-diagonal inverses
    lmax: float                # Gershgorin-style bound on spec(Db^-1 A)
    p_data: torch.Tensor       # prolongator blocks [n_f, Kp, b, m] (gather)
    p_cols: torch.Tensor       # [n_f, Kp] coarse aggregate ids (gather)
    r_data: torch.Tensor       # restriction blocks [n_c, Kr, m, b] (gather)
    r_cols: torch.Tensor       # [n_c, Kr] fine node ids (gather)
    # banded-embedded transfer mode: square p x p block matrices over the
    # FINE node set; p_data / r_data are then None
    Qp: BCSRMatrix = None      # embedded prolongator [ns, Kq, p, p]
    Qr: BCSRMatrix = None      # embedded restriction [ns, Kq, p, p]
    emb: torch.Tensor = None   # [nc] int64, first fine node per aggregate
    m: int = 0                 # coarse modes per aggregate


class BlockAMGHierarchy(NamedTuple):
    levels: tuple
    coarse_inv: torch.Tensor
    smoother_degree: int
    smoother_ratio: float
    operator_complexity: float
    gamma: int = 1

    def apply(self, r):
        """z = cycle(r): the SPD preconditioner application (node-major
        r [ns * b])."""
        return _block_cycle(self, 0, r)

    def __call__(self, r):
        return self.apply(r)


def _bdinv_apply(inv_diag, r):
    ns, b, _ = inv_diag.shape
    return torch.einsum("nxy,ny->nx", inv_diag,
                        r.reshape(ns, b)).reshape(-1)


def _bell_matvec(data, cols, x):
    """Block-ELL [n, K, p, q] @ x [ncols*q] -> [n*p] (gather form).  A
    padding slot of a rectangular operator holds a zero block and its own
    row index, which may lie past x: clamped, as XLA's gather clamps."""
    n, K, p, q = data.shape
    xb = x.reshape(-1, q)
    g = xb[cols.long().clamp(max=xb.shape[0] - 1)]    # [n, K, q]
    return torch.einsum("nkpq,nkq->np", data, g).reshape(-1)


def _block_cheb_smooth(A: BCSRMatrix, inv_diag, lmax, degree, ratio, r0):
    """Chebyshev polynomial in Db^-1 A (block-Jacobi-preconditioned), the
    recurrence of solve/amg.py's _cheb_smooth."""
    theta, delta, rhos = _cheb_coeffs(degree, lmax, ratio)
    d = _bdinv_apply(inv_diag, r0) / theta
    z = d
    r = r0
    for k in range(1, degree):
        r = r - A.matvec(d)
        d = (rhos[k] * rhos[k - 1] * d
             + (2.0 * rhos[k] / delta) * _bdinv_apply(inv_diag, r))
        z = z + d
    return z


def _blk_restrict(lv: BlockAMGLevel, res):
    """P^T res.  Embedded mode: (Qr res_pad)[emb, :m], one square banded
    block SpMV plus a sorted 1-D block gather."""
    if lv.emb is not None:
        ns = lv.Qr.data.shape[0]
        p = lv.Qr.block_size
        b = lv.A.block_size
        re = res.reshape(ns, b)
        if p != b:
            re = torch.cat([re, re.new_zeros((ns, p - b))], dim=1)
        y = lv.Qr.matvec(re.reshape(-1)).reshape(ns, p)
        return y[lv.emb][:, :lv.m].reshape(-1)
    return _bell_matvec(lv.r_data, lv.r_cols, res)


def _blk_prolong(lv: BlockAMGLevel, xc):
    """P xc.  Embedded mode: Qp (xc_pad scattered at emb), a sorted 1-D
    block scatter plus one square banded block SpMV."""
    if lv.emb is not None:
        ns = lv.Qp.data.shape[0]
        p = lv.Qp.block_size
        b = lv.A.block_size
        xb = xc.reshape(-1, lv.m)
        if p != lv.m:
            xb = torch.cat([xb, xb.new_zeros((xb.shape[0], p - lv.m))],
                           dim=1)
        xe = xc.new_zeros((ns, p))
        xe[lv.emb] = xb
        y = lv.Qp.matvec(xe.reshape(-1)).reshape(ns, p)
        return y[:, :b].reshape(-1)
    return _bell_matvec(lv.p_data, lv.p_cols, xc)


def _block_cycle(h: BlockAMGHierarchy, l: int, r):
    if l == len(h.levels):
        return h.coarse_inv @ r
    lv = h.levels[l]
    deg, ratio = h.smoother_degree, h.smoother_ratio
    x = _block_cheb_smooth(lv.A, lv.inv_diag, lv.lmax, deg, ratio, r)
    res = r - lv.A.matvec(x)
    rc = _blk_restrict(lv, res)
    xc = _block_cycle(h, l + 1, rc)
    if h.gamma >= 2 and l + 1 < len(h.levels):
        cA = h.levels[l + 1].A
        xc = xc + _block_cycle(h, l + 1, rc - cA.matvec(xc))
    x = x + _blk_prolong(lv, xc)
    x = x + _block_cheb_smooth(lv.A, lv.inv_diag, lv.lmax, deg, ratio,
                               r - lv.A.matvec(x))
    return x


def build_block_amg(A: BCSRMatrix, *, B: Optional[np.ndarray] = None,
                    coords: Optional[np.ndarray] = None,
                    coarse_n: int = 600, max_levels: int = 12,
                    omega_scale: float = 4.0 / 3.0,
                    smoother_degree: int = 2, smoother_ratio: float = 8.0,
                    strength: float = 0.06, cycle: str = "V",
                    chunk: int = 1 << 19, transfer: str = "banded",
                    native_setup: bool = True,
                    walls_out: Optional[dict] = None) -> BlockAMGHierarchy:
    """Build a block-SA hierarchy from a concrete BCSR matrix.

    ``B`` is the near-null space [ns*b, m] (node-major component-minor);
    default: the m = b translations, or with ``coords`` the rigid body
    modes.  ``coarse_n`` counts coarse scalar DOFs (nc * m).  ``strength``
    filters the aggregation graph by block Frobenius norms.  All setup
    math is float64 on the host; device tensors take A's dtype and device.
    ``transfer``: "banded" (embedded square Qp / Qr) or "gather".
    ``native_setup``: the blocked products in the native host library
    (True; raises if it cannot be built) or the numpy specification
    (False), as the reference's flag, which falls back to numpy where the
    library does not load.
    ``walls_out``: optional dict filled with cumulative per-stage setup
    seconds (diag_lmax / aggregate / tentative / smooth_p / galerkin /
    plans / transfers / coarse_inv); ``coarse_rows``, ``levels`` (block
    rows per level), ``operator_complexity`` and ``gather``: the matrices
    that ride the gather kernel B12g on the card.
    """
    if cycle not in ("V", "W"):
        raise ValueError(f"unknown cycle {cycle!r}")
    if transfer not in ("banded", "gather"):
        raise ValueError(f"unknown transfer {transfer!r}")
    data = _numpy(A.data).astype(np.float64)
    cols = _numpy(A.cols)
    dtype = A.data.dtype
    dev = A.data.device
    on_card = dev.type == "cuda"
    b = data.shape[-1]
    if B is None:
        if coords is not None:
            B = rigid_body_modes(coords)
        else:
            B = np.tile(np.eye(b), (data.shape[0], 1))
    B = np.asarray(B, np.float64)
    m = B.shape[1]
    use_native = bool(native_setup)
    if use_native:
        from tpufem_torch import native

    def tensor(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    def index(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    import time

    def _tick(key, t0):
        if walls_out is not None:
            walls_out[key] = (walls_out.get(key, 0.0)
                              + time.perf_counter() - t0)
        return time.perf_counter()

    levels = []
    nnz0 = float(np.count_nonzero((data != 0).any(axis=(2, 3))))
    nnz_total = nnz0

    for level in range(max_levels):
        ns = data.shape[0]
        if ns * b <= coarse_n or ns <= 1:
            break
        t0 = time.perf_counter()

        # block-diagonal inverse + Gershgorin-style lmax on Db^-1 A
        Dblk = _block_diag_of(data, cols)
        try:
            Dinv = np.linalg.inv(Dblk)
        except np.linalg.LinAlgError:
            Dinv = np.linalg.pinv(Dblk)
        scaled = np.einsum("nxy,nkyq->nkxq", Dinv, data, optimize=True)
        fro = np.sqrt((scaled ** 2).sum(axis=(2, 3)))
        lmax = float(fro.sum(axis=1).max())
        omega = omega_scale / lmax
        t0 = _tick("diag_lmax", t0)

        # strength-filtered nodal aggregation (block Frobenius norms);
        # theta halves per level (Vanek's choice: Galerkin levels are
        # denser and more uniformly coupled)
        nf = np.sqrt((data ** 2).sum(axis=(2, 3)))          # [ns, K]
        dn = np.sqrt((Dblk ** 2).sum(axis=(1, 2)))          # [ns]
        thr = (strength * 0.5 ** level) * np.sqrt(
            np.maximum(dn[:, None] * dn[cols.astype(np.int64)], 1e-300))
        agg_cols = np.where(nf >= thr, cols,
                            np.arange(ns, dtype=cols.dtype)[:, None]
                            ).astype(np.int32)
        agg, nc = greedy_aggregate(agg_cols, use_native=use_native)
        if 2 * nc > ns:
            # coarsening degraded (ratio < 2): retry on the full block
            # graph (BENCH_NOTES r5 phase E1).  The reference has no
            # `strength > 0` guard here (solve/amg.py has one); matched.
            agg2, nc2 = greedy_aggregate(cols, use_native=use_native)
            if nc2 < nc:
                agg, nc = agg2, nc2
        # decoupled block rows (symmetric Dirichlet elimination) are
        # permanent singletons: group them so they coarsen too
        # (span-capped at ~2x the level bandwidth so the embedded
        # transfers stay banded)
        iso = ~(((cols != np.arange(ns, dtype=cols.dtype)[:, None])
                 & (data != 0).any(axis=(2, 3))).any(axis=1))
        bw = int(np.abs(cols.astype(np.int64)
                        - np.arange(ns, dtype=np.int64)[:, None]).max())
        agg, nc = merge_isolated_singletons(
            agg, nc, iso, span=max(2 * bw, 2048))
        t0 = _tick("aggregate", t0)
        if nc >= 0.7 * ns:
            # still stalled: dense-coarsest fallback, size-guarded
            if ns * b > max(4 * coarse_n, 20_000):
                raise ValueError(
                    f"block-AMG coarsening stalled at {ns} nodes "
                    f"({nc} aggregates) — too large for the dense "
                    "coarsest solve; lower `strength`")
            break

        # tentative (per-aggregate QR of B) and smoothed prolongator
        t_data, Bc = _tentative(agg, nc, B, b)     # [ns,1,b,m], [nc*m, m]
        t_cols = agg[:, None].astype(np.int32)
        t0 = _tick("tentative", t0)
        if use_native:                              # A T
            cr, cc, cv = _bell_to_bcoo(*native.bspmm_bell(
                data, cols, t_data, t_cols, nc))
        else:
            cr, cc, cv = _bspmm(data, cols, t_data, t_cols, nc, chunk)
        # P = T - omega Dinv (A T): merge the two block-COO terms
        pr = np.concatenate([np.arange(ns, dtype=np.int64), cr])
        pc = np.concatenate([agg, cc])
        pv = np.concatenate([t_data[:, 0],
                             -omega * np.einsum("rxy,rym->rxm", Dinv[cr],
                                                cv, optimize=True)], axis=0)
        pr, pc, pv = _bcoo_dedup(pr, pc, pv, nc)
        p_data, p_cols = _bcoo_to_bell(pr, pc, pv, ns)
        t0 = _tick("smooth_p", t0)

        # Galerkin A_c = P^T (A P): native single pass, or the numpy spec
        if use_native:
            c_data, c_cols = native.galerkin_bell(
                data, cols, p_data, p_cols, nc)
        else:
            cr, cc, cv = _bspmm(data, cols, p_data, p_cols, nc, chunk)
            gr, gc, gv = _bspmm_t(p_data, p_cols, cr, cc, cv, nc, chunk)
            c_data, c_cols = _bcoo_to_bell(gr, gc, gv, nc)
        nnz_total += float(np.count_nonzero(
            (c_data != 0).any(axis=(2, 3))))
        t0 = _tick("galerkin", t0)

        # setup-time plans on the card: the finest level by the bandwidth
        # rule, every coarse level primed (K-capped block size), no
        # fallback
        A_lvl = BCSRMatrix(tensor(data), index(cols.astype(np.int32)))
        if on_card:
            if level == 0:
                A_lvl.resolve_band()
            else:
                A_lvl.prime_band_plan(segment=False, cap_k=True)
        t0 = _tick("plans", t0)

        if transfer == "banded":
            # embed P [ns x nc] (b x m blocks) as a SQUARE block matrix on
            # each aggregate's first fine member (emb strictly increasing),
            # blocks padded to p x p, p = max(b, m); Qr = Qp^T
            p_sz = max(b, m)
            emb = np.full(nc, ns, np.int64)
            np.minimum.at(emb, agg, np.arange(ns, dtype=np.int64))
            qv = np.zeros((pv.shape[0], p_sz, p_sz), pv.dtype)
            qv[:, :b, :m] = pv
            qp_data, qp_cols = _bcoo_to_bell(pr, emb[pc], qv, ns)
            qtv = np.zeros((pv.shape[0], p_sz, p_sz), pv.dtype)
            qtv[:, :m, :b] = np.swapaxes(pv, 1, 2)
            qr_r, qr_c, qr_v = _bcoo_dedup(emb[pc], pr, qtv, ns)
            qr_data, qr_cols = _bcoo_to_bell(qr_r, qr_c, qr_v, ns)
            Qp_m = BCSRMatrix(tensor(qp_data), index(qp_cols))
            Qr_m = BCSRMatrix(tensor(qr_data), index(qr_cols))
            if on_card:
                for Qm in (Qp_m, Qr_m):
                    Qm.prime_band_plan(segment=(level == 0), cap_k=True)
            levels.append(BlockAMGLevel(
                A=A_lvl, inv_diag=tensor(Dinv), lmax=lmax,
                p_data=None, p_cols=None, r_data=None, r_cols=None,
                Qp=Qp_m, Qr=Qr_m, emb=index(emb), m=m))
        else:
            # restriction = P^T as its own block ELL (pad: own row)
            rr, rc_, rv = _bcoo_dedup(pc, pr,
                                      np.swapaxes(pv, 1, 2), ns)
            r_data, r_cols = _bcoo_to_bell(rr, rc_, rv, nc)
            levels.append(BlockAMGLevel(
                A=A_lvl, inv_diag=tensor(Dinv), lmax=lmax,
                p_data=tensor(p_data), p_cols=index(p_cols),
                r_data=tensor(r_data), r_cols=index(r_cols), m=m))
        t0 = _tick("transfers", t0)
        data, cols, B, b = c_data, c_cols, Bc, m

    # coarsest: explicit dense inverse
    t0 = time.perf_counter()
    ns = data.shape[0]
    bb = data.shape[-1]
    n = ns * bb
    dense = np.zeros((n, n))
    ridx = np.repeat(np.arange(ns), data.shape[1])
    cidx = cols.astype(np.int64).ravel()
    for x in range(bb):
        for y in range(bb):
            np.add.at(dense, (ridx * bb + x, cidx * bb + y),
                      data[:, :, x, y].ravel())
    # symmetric (pseudo-)inverse: Cholesky when SPD, eigh pseudo-inverse
    # when the coarsest carries a rigid-body null space
    coarse_inv = tensor(sym_dense_inv(dense))
    _tick("coarse_inv", t0)
    if walls_out is not None:
        walls_out["coarse_rows"] = int(n)
        walls_out["levels"] = [int(lv.A.data.shape[0]) for lv in levels]
        walls_out["operator_complexity"] = nnz_total / max(nnz0, 1.0)
        walls_out["gather"] = [
            f"{name}{i}" for i, lv in enumerate(levels)
            for name in ("A", "Qp", "Qr")
            if getattr(lv, name) is not None
            and getattr(lv, name)._band in (None, "unresolved")
        ] if on_card else []

    return BlockAMGHierarchy(levels=tuple(levels), coarse_inv=coarse_inv,
                             smoother_degree=int(smoother_degree),
                             smoother_ratio=float(smoother_ratio),
                             operator_complexity=nnz_total / max(nnz0, 1.0),
                             gamma={"V": 1, "W": 2}[cycle])
