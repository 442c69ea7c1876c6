"""ELL SpMV kernels for banded unstructured meshes: B9, its per-block
route B11 and B10 (csrc/ell.cu), as in tpufem.sparse.ell_pallas.

The banded plan (``ell_band_plan``) is the reference's: rows in blocks of
R, the matrix transposed to data_t / rel [K, NP] with each column stored
as a window-relative position rel = col - (blockstart - R) in [0, 3R)
(int16 while 3R <= 32767, else int32), plus the TPU kernel's schedule
(per-slot delta lists, the per-block delta table ``dtab``, the block
``segments``).  The schedule exists to drive the TPU's lane gathers; the
CUDA kernel gathers each column directly, so ``segmented`` and
``per_block`` are accepted and every call is one launch.

  * ``ell_matvec_cuda`` (B9; B11 with ``per_block=True``):
    y = A x from the plan;
  * ``ell_matvec_multi_cuda`` (B10): Y = A X for X [n, q];
  * ``ell_gather_matvec_cuda`` / ``ell_gather_matvec_multi_cuda``: the same
    kernels in absolute-column mode on row-major data / cols [N, K] (the
    gather form of ``ELLMatrix``).

Each wrapper launches its kernel for a CUDA tensor and runs its plain
PyTorch version (the ``*_plain`` functions) for a CPU tensor, and counts
its launches.  What bounds the kernels is noted in the CUDA source.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from tpufem_torch.ops._build import check_launch, load_library, stream_handle

__all__ = ["ELLBandPlan", "ell_band_plan", "auto_block_rows",
           "ell_matvec_cuda", "ell_matvec_multi_cuda",
           "ell_gather_matvec_cuda", "ell_gather_matvec_multi_cuda",
           "ell_band_matvec_plain", "ell_band_matvec_multi_plain",
           "ell_gather_matvec_plain", "ell_gather_matvec_multi_plain"]


class ELLBandPlan(NamedTuple):
    """Static plan of the banded ELL SpMV (host numpy arrays)."""
    rel: np.ndarray          # [K, NP] int16/int32 window-relative positions
    data_t: np.ndarray       # [K, NP] values (transposed, padded)
    n: int                   # original rows
    np_rows: int             # padded rows (multiple of R)
    block_rows: int          # R
    d_lists: tuple           # per-slot window-row deltas used (TPU schedule)
    width: int
    dtab: object = None      # [nb, K, dmax] per-block deltas (per_block)
    segments: object = None  # ((start, end, d_lists), ...) block ranges


# sentinel "no delta" entry of ELLBandPlan.dtab
_D_NONE = 64


def auto_block_rows(bw: int, n: int, k: int = None) -> int:
    """The reference's block-size policy: as large as possible, capped at
    8192 (int16 rel at 3R) and keeping >= 8 blocks, always covering the
    bandwidth; ``k`` (slot count) caps K * R / 128 <= 1024 unless the
    bandwidth needs more."""
    r = max(256, -(-bw // 128) * 128,
            min(8192, -(-n // (8 * 128)) * 128))
    if k and k > 0:
        cap = max(256, (1024 // int(k)) * 128)
        r = min(r, max(cap, -(-bw // 128) * 128, 256))
    return r


def _numpy(a) -> np.ndarray:
    """A host numpy array of a numpy array or a tensor on any device."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def ell_band_plan(data, cols, *, block_rows: int = None,
                  per_block: bool = False, segment: bool = True,
                  max_segments: int = 16) -> ELLBandPlan:
    """Rewrite an ELL matrix (data [N, K], cols [N, K]; numpy arrays or
    tensors) for the banded kernel.

    Requires bandwidth <= block_rows: every cols[i, :] must lie in
    [blockstart(i) - R, blockstart(i) + 2R).  Raises ValueError otherwise
    (renumber the mesh with RCM, or raise block_rows).  ``block_rows=None``
    picks ``auto_block_rows``.
    """
    data = _numpy(data)
    cols = _numpy(cols)
    if block_rows is None:
        nn = cols.shape[0]
        bw = int(np.abs(cols.astype(np.int64)
                        - np.arange(nn)[:, None]).max()) if nn else 0
        block_rows = auto_block_rows(bw, nn, cols.shape[1])
    R = int(block_rows)
    if R % 128:
        raise ValueError("block_rows must be a multiple of 128")
    n, K = data.shape
    if n and (cols.min() < 0 or cols.max() >= n):
        raise ValueError("column index out of range")
    nb = max(1, -(-n // R))
    np_rows = nb * R
    pad = np_rows - n
    if pad:
        data = np.pad(data, ((0, pad), (0, 0)))
        # padding rows point at themselves (value 0)
        self_cols = np.arange(n, np_rows, dtype=cols.dtype)[:, None]
        cols = np.concatenate(
            [cols, np.broadcast_to(self_cols, (pad, K)).copy()])

    blk = np.arange(np_rows) // R
    w0 = (blk - 1) * R                        # window start per row
    rel = cols.astype(np.int64) - w0[:, None]
    if rel.min() < 0 or rel.max() >= 3 * R:
        bw = int(np.abs(cols - np.arange(np_rows)[:, None]).max())
        raise ValueError(
            f"matrix bandwidth {bw} exceeds block_rows {R}; renumber the "
            "mesh (RCM) or increase block_rows")
    idx_dtype = np.int16 if 3 * R <= 32767 else np.int32
    rel_t = np.ascontiguousarray(rel.T.astype(idx_dtype))     # [K, NP]
    data_t = np.ascontiguousarray(data.T)                      # [K, NP]

    # the TPU kernel's schedule: per slot, the window-row deltas
    # d = rel // 128 - (R/128 + own sublane) that occur
    sub = R // 128
    own_sub = (np.arange(np_rows) % R) // 128                  # [NP]
    d_lists = []
    dmat = np.empty((K, np_rows), np.int64)
    for k in range(K):
        d = rel_t[k].astype(np.int64) // 128 - (sub + own_sub)
        if d.min() < -sub or d.max() > sub:
            bw = int(np.abs(cols.astype(np.int64)
                            - np.arange(np_rows)[:, None]).max())
            raise ValueError(
                f"matrix bandwidth {bw} exceeds block_rows {R}; renumber "
                "the mesh (reverse_cuthill_mckee) or increase block_rows")
        d_lists.append(tuple(int(v) for v in np.unique(d)))
        dmat[k] = d

    db = dmat.reshape(K, nb, R)
    uniq = None
    dtab = None
    if per_block:
        uniq = [[frozenset(np.unique(db[k, j]).tolist()) for k in range(K)]
                for j in range(nb)]
        dmax = max(1, max(len(u) for row in uniq for u in row))
        dtab = np.full((nb, K, dmax), _D_NONE, np.int32)
        for j in range(nb):
            for k in range(K):
                u = sorted(uniq[j][k])
                dtab[j, k, :len(u)] = u

    segments = None
    if segment and nb > 1:
        if uniq is None:
            uniq = [[frozenset(np.unique(db[k, j]).tolist())
                     for k in range(K)] for j in range(nb)]
        segments = _segment_blocks(uniq, nb, K, max_segments)
    return ELLBandPlan(rel=rel_t, data_t=data_t, n=n, np_rows=np_rows,
                       block_rows=R, d_lists=tuple(d_lists), width=K,
                       dtab=dtab, segments=segments)


def _segment_blocks(uniq, nb, K, max_segments):
    """Greedy contiguous segmentation of the block range (the TPU
    schedule): each segment's per-slot delta union stays under a round
    cap, raised until the segment count fits ``max_segments``."""
    lo = max(sum(len(s) for s in row) for row in uniq)     # densest block
    for cap in range(lo, 16 * K + 1, 2):
        segs = []
        j = 0
        while j < nb:
            cur = [set() for _ in range(K)]
            start = j
            while j < nb:
                trial = [cur[k] | uniq[j][k] for k in range(K)]
                if sum(len(s) for s in trial) > cap and j > start:
                    break
                cur = trial
                j += 1
            segs.append((start, j, tuple(tuple(sorted(s)) for s in cur)))
            if len(segs) > max_segments:
                break
        if len(segs) <= max_segments:
            return tuple(segs)
    return None                                             # give up: global


# -- plain versions --------------------------------------------------------------

def _window_cols(plan, rel_dev):
    """[K, NP] absolute columns (i // R - 1) R + rel of the banded plan."""
    R = plan.block_rows
    rows = torch.arange(plan.np_rows, device=rel_dev.device)
    return (rows // R - 1) * R + rel_dev.long()


def _padded(x, np_rows):
    if x.shape[0] == np_rows:
        return x
    pad = x.new_zeros((np_rows - x.shape[0],) + tuple(x.shape[1:]))
    return torch.cat([x, pad])


def ell_band_matvec_plain(plan: ELLBandPlan, data_dev, rel_dev, x):
    """Plain PyTorch version of B9/B11: the window arithmetic written out,
    x padded to NP, y summed in slot order; returns y [n]."""
    cols = _window_cols(plan, rel_dev)
    xp = _padded(x, plan.np_rows)
    y = torch.zeros(plan.np_rows, dtype=x.dtype, device=x.device)
    for k in range(plan.width):
        y = y + data_dev[k] * xp[cols[k]]
    return y[:plan.n]


def ell_band_matvec_multi_plain(plan: ELLBandPlan, data_dev, rel_dev, X):
    """Plain PyTorch version of B10: Y = A X for X [n or NP, q]."""
    cols = _window_cols(plan, rel_dev)
    Xp = _padded(X, plan.np_rows)
    Y = torch.zeros((plan.np_rows, X.shape[1]), dtype=X.dtype,
                    device=X.device)
    for k in range(plan.width):
        Y = Y + data_dev[k][:, None] * Xp[cols[k]]
    return Y[:plan.n]


def ell_gather_matvec_plain(data, cols, x):
    """y[i] = sum_k data[i, k] x[cols[i, k]]: gather + row reduction, in
    slot order (the kernel's order, so the two agree bit for bit)."""
    c = cols.long()
    y = torch.zeros(data.shape[0], dtype=x.dtype, device=x.device)
    for k in range(data.shape[1]):
        y = y + data[:, k] * x[c[:, k]]
    return y


def ell_gather_matvec_multi_plain(data, cols, X):
    """Y[i, :] = sum_k data[i, k] X[cols[i, k], :], in slot order."""
    c = cols.long()
    Y = torch.zeros((data.shape[0], X.shape[1]), dtype=X.dtype,
                    device=X.device)
    for k in range(data.shape[1]):
        Y = Y + data[:, k, None] * X[c[:, k]]
    return Y


# -- the kernels ---------------------------------------------------------------

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_ARGS = (_P, _P, _P, _P, _LL, _I, _LL, _LL, _LL, _I, _P)
_ENTRY = {(torch.float32, torch.int16): "tpufem_ell_spmv_f32_i16",
          (torch.float32, torch.int32): "tpufem_ell_spmv_f32_i32",
          (torch.float64, torch.int16): "tpufem_ell_spmv_f64_i16",
          (torch.float64, torch.int32): "tpufem_ell_spmv_f64_i32"}


def _lib():
    return load_library("ell.cu", {e: _ARGS for e in _ENTRY.values()})


def _expect(what, t, dtype, shape, device):
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or t.device != device or not t.is_contiguous()):
        raise ValueError(f"{what}: expected contiguous {dtype} "
                         f"{tuple(shape)} on {device}, got {tuple(t.shape)} "
                         f"{t.dtype} {t.device}")


def _launch(what, data, idx, x, rows, k, row_stride, slot_stride, block_rows,
            q):
    """One launch of csrc/ell.cu on (data, idx) of the vectors' type: k
    slots per row at the given strides; x holds the rows the columns
    reach, q its columns (1: a vector)."""
    entry = _ENTRY.get((data.dtype, idx.dtype))
    if entry is None:
        raise TypeError(f"{what}: takes (value, index) types "
                        f"{sorted(_ENTRY, key=str)}, got ({data.dtype}, "
                        f"{idx.dtype})")
    if x.dtype != data.dtype or x.device != data.device \
            or not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous {data.dtype} on "
                         f"{data.device}, got {x.dtype} {x.device}")
    shape = (rows,) if q == 1 and x.dim() == 1 else (rows, q)
    with torch.cuda.device(x.device):
        y = torch.empty(shape, dtype=x.dtype, device=x.device)
        status = getattr(_lib(), entry)(
            data.data_ptr(), idx.data_ptr(), x.data_ptr(), y.data_ptr(),
            rows, k, row_stride, slot_stride, block_rows, q, stream_handle())
    check_launch(status, what)
    return y


def _check_band(what, plan, data_dev, rel_dev, x, rows_axis_len):
    K, NP = plan.width, plan.np_rows
    _expect(what + " data_t", data_dev, x.dtype, (K, NP), x.device)
    if rel_dev.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"{what}: rel must be int16 or int32, got "
                        f"{rel_dev.dtype}")
    _expect(what + " rel", rel_dev, rel_dev.dtype, (K, NP), x.device)
    if rows_axis_len not in (plan.n, NP):
        raise ValueError(f"{what}: x has {rows_axis_len} rows, the plan "
                         f"{plan.n} (or {NP} padded)")


def ell_matvec_cuda(plan: ELLBandPlan, data_dev, rel_dev, x, *,
                    per_block: bool = False, segmented=None):
    """B9: y = A x with the banded kernel; B11 with ``per_block=True``
    (the plan must carry its ``dtab``).

    data_dev / rel_dev: device copies of plan.data_t / plan.rel ([K, NP]);
    x [n] (or [NP]); returns y [n].  ``segmented`` is accepted for the
    reference's signature; every call is one launch.  No host sync.
    """
    del segmented
    if per_block and plan.dtab is None:
        raise ValueError("per_block needs a plan built with per_block=True")
    if x.device.type == "cpu":
        return ell_band_matvec_plain(plan, data_dev, rel_dev, x)
    what = "ell_matvec" + ("_per_block" if per_block else "")
    if x.dim() != 1:
        raise ValueError(f"{what}: x must be 1-D, got {tuple(x.shape)}")
    _check_band(what, plan, data_dev, rel_dev, x, x.shape[0])
    y = _launch(what, data_dev, rel_dev, x, plan.n, plan.width, 1,
                plan.np_rows, plan.block_rows, 1)
    ell_matvec_cuda.launches += 1
    if per_block:
        ell_matvec_cuda.launches_per_block += 1
    return y


ell_matvec_cuda.launches = 0
ell_matvec_cuda.launches_per_block = 0


def ell_matvec_multi_cuda(plan: ELLBandPlan, data_dev, rel_dev, X, *,
                          segmented=None):
    """B10: Y = A X for X [n, q] (or [NP, q]) with the banded kernel, the
    matrix read once for all q columns; returns Y [n, q].  No host
    sync."""
    del segmented
    if X.dim() != 2:
        raise ValueError("ell_matvec_multi_cuda expects X [N, q]")
    if X.device.type == "cpu":
        return ell_band_matvec_multi_plain(plan, data_dev, rel_dev, X)
    _check_band("ell_matvec_multi", plan, data_dev, rel_dev, X, X.shape[0])
    Y = _launch("ell_matvec_multi", data_dev, rel_dev, X, plan.n,
                plan.width, 1, plan.np_rows, plan.block_rows, X.shape[1])
    ell_matvec_multi_cuda.launches += 1
    return Y


ell_matvec_multi_cuda.launches = 0


def _check_gather(what, data, cols, x):
    n, K = data.shape
    _expect(what + " data", data, x.dtype, (n, K), x.device)
    _expect(what + " cols", cols, torch.int32, (n, K), x.device)
    if x.shape[0] != n:
        raise ValueError(f"{what}: x has {x.shape[0]} rows, the matrix {n}")


def ell_gather_matvec_cuda(data, cols, x):
    """y = A x on row-major data / cols [N, K] (absolute columns): the B9
    kernel in absolute-column mode.  No host sync."""
    if x.device.type == "cpu":
        return ell_gather_matvec_plain(data, cols, x)
    _check_gather("ell_gather_matvec", data, cols, x)
    if x.dim() != 1:
        raise ValueError("ell_gather_matvec: x must be 1-D")
    n, K = data.shape
    y = _launch("ell_gather_matvec", data, cols, x, n, K, K, 1, 0, 1)
    ell_gather_matvec_cuda.launches += 1
    return y


ell_gather_matvec_cuda.launches = 0


def ell_gather_matvec_multi_cuda(data, cols, X):
    """Y = A X for X [N, q] on row-major data / cols [N, K]: the B10
    kernel in absolute-column mode.  No host sync."""
    if X.dim() != 2:
        raise ValueError("ell_gather_matvec_multi expects X [N, q]")
    if X.device.type == "cpu":
        return ell_gather_matvec_multi_plain(data, cols, X)
    _check_gather("ell_gather_matvec_multi", data, cols, X)
    n, K = data.shape
    Y = _launch("ell_gather_matvec_multi", data, cols, X, n, K, K, 1, 0,
                X.shape[1])
    ell_gather_matvec_multi_cuda.launches += 1
    return Y


ell_gather_matvec_multi_cuda.launches = 0
