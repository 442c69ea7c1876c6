"""ELL SpMV kernels for banded unstructured meshes: B9, its per-block
route B11 and B10 (csrc/ell.cu), and the BCSR block SpMV B12
(csrc/bcsr.cu), as in tpufem.sparse.ell_pallas.

The banded plan (``ell_band_plan``) is the reference's: rows in blocks of
R, the matrix transposed to data_t / rel [K, NP] with each column stored
as a window-relative position rel = col - (blockstart - R) in [0, 3R)
(int16 while 3R <= 32767, else int32), plus the TPU kernel's schedule
(per-slot delta lists, the per-block delta table ``dtab``, the block
``segments``).  The schedule exists to drive the TPU's lane gathers; the
CUDA kernel gathers each column directly, so ``segmented`` and
``per_block`` are accepted and every call is one launch.  Unlike the
reference's, the plan keeps only the slot planes that hold a nonzero in
some row (``width`` counts them: an AMG level of padded width 6144 keeps
its longest row's 95), records each row's length ``row_len`` (the slot
after its last nonzero) and B9's form (``ell_band_design``).  A zero slot
adds 0 x = +-0 to a sum that starts at +0, which leaves it as it is, so
the products are unchanged for finite x; an inf or NaN of x that only a
dropped or trailing padding slot reaches no longer reaches y.

  * ``ell_matvec_cuda`` (B9; B11 with ``per_block=True``):
    y = A x from the plan, in its form: "rows", a thread a row on the
    planes up to its length; "sliced", a thread a row on the rows sorted
    by length in windows and laid out in slices of 32; "split", lanes a
    row on the rows packed row after row, the products added in slot
    order out of shared memory (the layout ``ell_band_prepare`` builds
    once, which its owner passes to each product); the non-empty rows
    alone where they are few;
  * ``ell_matvec_multi_cuda`` (B10): Y = A X for X [n, q], a thread a row
    with its q sums in registers, X's rows staged in shared memory where
    a block's columns fit the window ``ell_multi_tiling`` gives;
  * ``ell_gather_matvec_cuda`` (B9g): the same product on row-major data
    / cols [N, K] with absolute columns (the gather form of
    ``ELLMatrix``); on tall matrices a thread a row (its rows as they are,
    or staged through shared memory) or 4 lanes a row relaying the sum,
    else lanes a row summing out of shared memory; a zero value's x
    skipped (``ell_gather_tiling``);
    ``ell_gather_matvec_multi_cuda``: B10 in absolute-column mode;
  * ``bcsr_matvec_cuda`` (B12, both TPU variants): y = A x for a BCSR
    matrix of b x b blocks (b = 2 to 6, ``BCSR_BLOCK_SIZES``) on the
    node pattern's banded plan (``bcsr_band_plan``), x and y
    component-major [b, n]: for b = 2, 3 and K = 8, 16 a thread a block
    row, the slots unrolled, in tiles of ``bcsr_band_tiling`` rows; for
    every other shape (the AMG levels') a run-time slot loop in groups
    loaded ahead, a thread a row in tiles of ``bcsr_loop_tiling`` rows or
    b threads a row (``bcsr_band_design``);
    ``bcsr_gather_matvec_cuda`` (B12g, its own kernel in csrc/bcsr.cu):
    the same product on row-major data [NR, K, b, b] / cols [NR, K] and
    node-major x (the gather form of ``BCSRMatrix``), staged through
    shared memory in tiles of consecutive rows (``bcsr_gather_tiling``).

Each wrapper launches its kernel for a CUDA tensor and runs its plain
PyTorch version (the ``*_plain`` functions) for a CPU tensor, and counts
its launches.  What bounds the kernels is noted in the CUDA source.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from tpufem_torch.ops._build import check_launch, load_library, stream_handle

__all__ = ["ELLBandPlan", "ell_band_plan", "auto_block_rows",
           "ell_matvec_cuda", "ell_matvec_multi_cuda", "ell_multi_tiling",
           "ell_multi_designs", "bcsr_band_tiling",
           "ell_gather_matvec_cuda", "ell_gather_matvec_multi_cuda",
           "ell_band_matvec_plain", "ell_band_matvec_multi_plain",
           "ell_gather_matvec_plain", "ell_gather_matvec_multi_plain",
           "bcsr_band_plan", "bcsr_matvec_cuda", "bcsr_gather_matvec_cuda",
           "bcsr_band_matvec_plain", "bcsr_gather_matvec_plain",
           "bcsr_gather_tiling", "BCSR_BLOCK_SIZES", "bcsr_band_design",
           "bcsr_loop_tiling"]


class EllForm(NamedTuple):
    """B9's form for a banded plan (``ell_band_design``)."""
    name: str                # "rows", "sliced" or "split"
    compact: bool            # "sliced" / "split": the non-empty rows alone
    tile_rows: int           # "split": rows a block (256 / lanes a row)

    def __str__(self):
        if self.name == "rows":
            return "rows: a thread a row on the slot planes"
        what = ("sliced: a thread a row on slices of 32 sorted rows"
                if self.name == "sliced" else
                f"split: packed rows, {self.tile_rows} a block x "
                f"{_SPLIT_THREADS // self.tile_rows} lanes")
        return what + (", the non-empty rows alone" if self.compact else "")


class ELLBandPlan(NamedTuple):
    """Static plan of the banded ELL SpMV (host numpy arrays).  ``width``
    counts the slot planes kept: those with a nonzero value in some row
    (at least one)."""
    rel: np.ndarray          # [K, NP] int16/int32 window-relative positions
    data_t: np.ndarray       # [K, NP] values (transposed, padded)
    n: int                   # original rows
    np_rows: int             # padded rows (multiple of R)
    block_rows: int          # R
    d_lists: tuple           # per-slot window-row deltas used (TPU schedule)
    width: int
    dtab: object = None      # [nb, K, dmax] per-block deltas (per_block)
    segments: object = None  # ((start, end, d_lists), ...) block ranges
    row_len: object = None   # [NP] int32: the slot after a row's last nonzero
    form: object = None      # EllForm of B9 (ell_band_design)


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
    # the slot planes with a nonzero value in some row (at least one):
    # a plane of zeros adds +-0 to every sum, which leaves it as it is
    keep = np.flatnonzero((data != 0).any(axis=0))
    if keep.size == 0:
        keep = np.zeros(1, np.int64)
    K = int(keep.size)
    rel_t = np.ascontiguousarray(rel.T[keep].astype(idx_dtype))  # [K, NP]
    data_t = np.ascontiguousarray(data.T[keep])                # [K, NP]

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
    row_len, form = band_rows(data_t, n)
    return ELLBandPlan(rel=rel_t, data_t=data_t, n=n, np_rows=np_rows,
                       block_rows=R, d_lists=tuple(d_lists), width=K,
                       dtab=dtab, segments=segments, row_len=row_len,
                       form=form)


# threads a block of B9's "split" form and of B9g
_SPLIT_THREADS = 256
# rows x lanes B9 aims to keep in flight: about half the threads the
# card's 132 SMs hold (2048 each)
_LANE_TARGET = 1 << 17
# "sliced": rows sorted by length within windows of this many, and the
# rows it takes at the least (measured at the P2-tet hierarchy's level 1,
# 87,435 rows, against "split": PERF.md)
_SLICE_WINDOW = 1024
_SLICED_MIN = 32768
_MAX_LANES = 256
# "rows" needs this share of the slot planes' lines a warp reads to be its
# rows' own slots (even row lengths): "rows" measured 7-38% faster than
# "sliced" at shares of 0.98 and over (P1, Q1 quads, the random K = 8
# matrix), "sliced" 9% faster at p2's level-1 A (about 0.89) and even at
# the hex fine A (PERF.md)
_PLANE_SHARE = 0.95
_SMS = 132                     # streaming multiprocessors of the H100 SXM
# shared memory of a block's products (rows x a chunk of slots); where a
# launch has fewer blocks than the card has SMs (a few long rows), up to
# _SPLIT_SMEM_FEW, so that a long row's slots load in one pass
_SPLIT_SMEM = 32 * 1024
# B9g on tall matrices (rows up to _GATHER_ROW_MAX slots), by what
# measured fastest of its three designs (PERF.md): fp64 rows of
# _STAGE_SLOTS slots (whole groups of 4) staged in chunks of _STAGE_CHUNK
# (hex K = 32: 0.1552 ms; 0.1621 a thread a row, 0.1658 4 lanes a row),
# longer fp64 rows _GATHER_LANES lanes a row (P2-tet K = 80: 0.2996; 0.3366
# a thread a row, 0.3978 staged), else a thread a row (K = 8 fp32: 0.0388;
# 0.0464 staged, 0.0635 4 lanes a row)
_GATHER_ROW_MAX = 256
_STAGE_SLOTS = range(17, 33)
_STAGE_CHUNK = 16
_GATHER_LANES = 4
_SPLIT_SMEM_FEW = 192 * 1024


def ell_band_design(row_len) -> EllForm:
    """B9's form for a plan whose rows have lengths ``row_len`` [n] (the
    slot after each row's last nonzero).  Where fewer than half the rows
    are non-empty (an embedded restriction, Qr), only those are computed
    (``compact``); of the m rows computed:

      * "rows", a thread a row on the plan's slot planes, where all n rows
        are computed, n reaches ``_LANE_TARGET`` and the lengths are even
        enough that the planes' lines hold what they need: of each 32
        consecutive rows' (a warp's) lines up to its longest row, a share
        ``_PLANE_SHARE`` or more is the rows' own slots;
      * "sliced", a thread a row on slices of 32 rows sorted by length
        within windows of ``_SLICE_WINDOW`` rows, each row's slots in
        whole groups of 4 a lane, where m reaches ``_SLICED_MIN``
        otherwise (fewer rows leave the card's threads idle);
      * "split", the packed rows with 256 / tile_rows lanes a row (a power
        of 2): about a lane per 8 slots of the mean row, at least 4,
        doubled while m x lanes falls short of the target and the lanes
        of half the longest row, at most 256.
    """
    lens = np.asarray(row_len, dtype=np.int64)
    rows, live = lens.size, int(np.count_nonzero(lens))
    if live == 0:
        return EllForm("rows", False, 1)
    compact = 2 * live < rows
    longest, total = int(lens.max()), int(lens.sum())
    m = live if compact else rows
    if m >= _LANE_TARGET and not compact:
        warps = np.pad(lens, (0, -rows % 32)).reshape(-1, 32).max(axis=1)
        if total >= _PLANE_SHARE * 32 * int(warps.sum()):
            return EllForm("rows", False, 1)
    if m >= _SLICED_MIN:
        return EllForm("sliced", compact, 1)
    lanes = max(4, 1 << max(0, math.ceil(math.log2(total / m / 8))))
    while m * lanes < _LANE_TARGET and 2 * lanes < longest:
        lanes *= 2
    lanes = min(lanes, _MAX_LANES)
    return EllForm("split", compact, _SPLIT_THREADS // lanes)


def ell_split_chunk(itemsize: int, tile_rows: int, k: int,
                    blocks: int = _SMS) -> int:
    """Slots a pass of B9's "split" form (and of B9g) stages: all k where
    tile_rows rows of them fit ``_SPLIT_SMEM`` (``_SPLIT_SMEM_FEW`` for a
    launch of fewer ``blocks`` than the card's SMs; a row's products an
    odd pitch apart), else the most that do."""
    budget = _SPLIT_SMEM if blocks >= _SMS else _SPLIT_SMEM_FEW
    return max(1, min(k, budget // (tile_rows * itemsize) - 1))


def ell_gather_tiling(itemsize: int, k: int, rows: int):
    """B9g's tile for ``rows`` rows of ``k`` slots of ``itemsize``-byte
    values: (tile_rows, chunk).  Where the rows reach ``_LANE_TARGET`` and
    are at most ``_GATHER_ROW_MAX`` slots long: for fp64 rows of
    ``_STAGE_SLOTS`` slots in whole groups of 4, (0, ``_STAGE_CHUNK``), a
    thread a row, each block's rows staged through shared memory in
    chunks of that many slots; for longer fp64 rows, (-``_GATHER_LANES``,
    0), that many lanes a row, the sum relayed between them in slot order;
    else (0, 0), a thread a row on the rows as they are, its slots read in
    groups of 4 (16-byte loads where k allows).  Else lanes a row with the
    products summed out of shared memory: a power of 2 about k / 8 (each
    lane then loads about 8 slots), at least 32 bytes of a row per load (8
    fp32 or 4 fp64 lanes), at most 256; a block 256 threads; the slots
    staged in chunks (``ell_split_chunk``)."""
    if rows >= _LANE_TARGET and k <= _GATHER_ROW_MAX:
        if itemsize == 8 and k in _STAGE_SLOTS and k % 4 == 0:
            return 0, _STAGE_CHUNK
        if itemsize == 8 and k > _STAGE_SLOTS[-1]:
            return -_GATHER_LANES, 0
        return 0, 0
    lanes = max(32 // itemsize, 1 << max(0, math.ceil(math.log2(
        max(1, -(-k // 8))))))
    lanes = min(_MAX_LANES, lanes)
    tile_rows = _SPLIT_THREADS // lanes
    return tile_rows, ell_split_chunk(itemsize, tile_rows, k)


def ell_stage_smem(itemsize: int, chunk: int) -> int:
    """Shared memory of B9g's staged form for chunks of ``chunk`` slots
    (a multiple of 4): a block's 128 rows of values and of columns, each
    row an odd number of 16-byte units (csrc/ell.cu's stage_smem)."""
    return 128 * (((chunk * itemsize // 16) | 1) + ((chunk // 4) | 1)) * 16


def band_rows(data_t, n: int):
    """(row_len [NP] int32, EllForm) of a banded plan's values data_t
    [K, NP]: a row's length is the slot after its last nonzero (0 for an
    empty or padding row)."""
    nz = np.asarray(data_t) != 0
    K, NP = nz.shape
    last = K - np.argmax(nz[::-1], axis=0)
    row_len = np.where(nz.any(axis=0), last, 0).astype(np.int32)
    row_len[n:] = 0
    return row_len, ell_band_design(row_len[:n])


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
_TYPES = {(torch.float32, torch.int16): "f32_i16",
          (torch.float32, torch.int32): "f32_i32",
          (torch.float64, torch.int16): "f64_i16",
          (torch.float64, torch.int32): "f64_i32"}
# B9: data, idx, len, live, bits, x, y, rows, count, plane, block_rows, k,
# form, tile_shift, chunk, stream
_BAND_ARGS = (_P,) * 7 + (_LL,) * 4 + (_I,) * 4 + (_P,)
_BAND_ENTRY = {key: f"tpufem_ell_band_{t}" for key, t in _TYPES.items()}
_FORM_CODE = {"rows": 0, "split": 1, "sliced": 2}
# B9g: data, cols, x, y, rows, k, tile_shift, chunk, stream
_GATHER1_ARGS = (_P,) * 4 + (_LL, _I, _I, _I, _P)
_GATHER1_ENTRY = {torch.float32: "tpufem_ell_gather_f32",
                  torch.float64: "tpufem_ell_gather_f64"}
# B10: data, idx, x, y, rows, k, row_stride, slot_stride, block_rows, q,
# align, threads, window, stream
_MULTI_ARGS = (_P,) * 4 + (_LL, _I, _LL, _LL, _LL, _I, _I, _I, _I, _P)
_MULTI_ENTRY = {key: f"tpufem_ell_spmv_multi_{t}"
                for key, t in _TYPES.items()}


def ell_signatures() -> dict:
    """Every entry point of csrc/ell.cu with its ctypes arguments."""
    return {**{e: _BAND_ARGS for e in _BAND_ENTRY.values()},
            **{e: _GATHER1_ARGS for e in _GATHER1_ENTRY.values()},
            **{e: _MULTI_ARGS for e in _MULTI_ENTRY.values()}}


def _lib():
    return load_library("ell.cu", ell_signatures())


# B10's designs (threads a block, one row each; X rows a block stages in
# shared memory, 0: none): every design the sweep (``scripts/kernel_ab.py
# --tiles``) times, and by (value bytes, q) the one it measured fastest
ELL_MULTI_THREADS = (64, 128, 256)
ELL_MULTI_WINDOWS = (0, 2560, 4096)
_MULTI_PICKED = {(4, 3): (256, 2560), (4, 8): (256, 0)}
_SMEM_PER_BLOCK = 232448       # 227 KB of shared memory a block may take
# of which B10 may stage: the rest is kept for its static part
_STAGE_LIMIT = _SMEM_PER_BLOCK - 1024


def ell_multi_designs(itemsize: int, q: int):
    """Every (threads, window rows) B10 can launch for q columns of
    ``itemsize``-byte values."""
    return [(t, w) for t in ELL_MULTI_THREADS for w in ELL_MULTI_WINDOWS
            if w * q * itemsize <= _STAGE_LIMIT]


def ell_multi_tiling(itemsize: int, q: int):
    """B10's design for ``q`` columns of ``itemsize``-byte values:
    (threads a block, one row a thread; rows of X a block stages in shared
    memory, 0: none), one of ``ell_multi_designs``."""
    return _MULTI_PICKED.get((itemsize, q), (256, 0))


class EllBandLayout:
    """What B9 reads in its plan's form, on the device (``ell_band_prepare``),
    with the launch's fixed arguments.  "rows": the plan's device planes
    and the row lengths; "split": the rows' slots packed row after row in
    whole groups of 4 and their offsets; "sliced": the rows sorted by
    length in windows, in slices of 32 (``groups`` groups of 4 a row), each
    position's groups and row.  Where only the non-empty rows are
    computed, their bitmap.  It holds the arrays it was built from, and
    their versions: ``fits`` says whether it still stands for them.  Its
    owner keeps it (``ELLMatrix`` beside its plan); nothing else does, so
    it goes with its owner."""

    __slots__ = ("plan", "src", "versions", "length", "live", "bits",
                 "data", "rel", "groups", "dtype", "device", "entry",
                 "args", "fn", "__weakref__")

    def __init__(self, plan, data_dev, rel_dev, length, live, bits, data,
                 rel, groups=0):
        self.plan, self.src = plan, (data_dev, rel_dev)
        self.versions = (data_dev._version, rel_dev._version)
        self.length, self.live, self.bits = length, live, bits
        self.data, self.rel, self.groups = data, rel, groups
        self.dtype, self.device = data_dev.dtype, data_dev.device
        self.entry = _BAND_ENTRY.get((data_dev.dtype, rel_dev.dtype))
        form = plan.form
        # the rows computed: all n ("rows"), or those packed or sliced
        count = (plan.n if form.name == "rows" else length.shape[0]
                 - (form.name == "split"))
        shift = chunk = 0
        if form.name == "split":    # a tile of rows other than 1 ... 128 raises
            t = form.tile_rows
            shift = t.bit_length() - 1 if t > 0 and t & (t - 1) == 0 else -1
            chunk = ell_split_chunk(data_dev.element_size(), t, plan.width,
                                    -(-count // t))

        def ptr(t):
            return None if t is None else t.data_ptr()

        # the C entry's arguments around x and y (ell_signatures)
        self.args = ((ptr(data), ptr(rel), ptr(length), ptr(live),
                      ptr(bits)),
                     (plan.n, count,
                      groups if form.name == "sliced" else plan.np_rows,
                      plan.block_rows, plan.width,
                      _FORM_CODE.get(form.name, -1), shift, chunk))
        self.fn = None                  # the entry, bound at the first launch

    def fits(self, plan, data_dev, rel_dev) -> bool:
        """Whether the layout stands for this plan and these arrays as they
        are now (the same objects, their contents unchanged)."""
        return (plan is self.plan and data_dev is self.src[0]
                and rel_dev is self.src[1]
                and (data_dev._version, rel_dev._version) == self.versions)

    def nbytes(self) -> int:
        """Device bytes the layout adds to the plan's planes."""
        return sum(t.numel() * t.element_size()
                   for t in (self.length, self.live, self.bits, self.data,
                             self.rel)
                   if t is not None and t is not self.src[0]
                   and t is not self.src[1])


def ell_band_prepare(plan: ELLBandPlan, data_dev, rel_dev) -> EllBandLayout:
    """The device arrays B9 reads in the plan's form, built on the device
    from data_dev / rel_dev and the plan's row lengths: for "rows" the row
    lengths; for "split" each computed row's slots up to its length
    (rounded up to a whole group of 4 with zeros that point at the row),
    packed row after row in slot order, and their offsets; for "sliced"
    the same rows sorted by length within windows of ``_SLICE_WINDOW`` and
    laid out in slices of 32, a group of 4 slots of the slice's 32 rows
    contiguous.  Build it once where the planes are made and pass it to
    each product (``ell_matvec_cuda(..., layout=)``); nothing caches it."""
    dev, n = data_dev.device, plan.n
    if plan.row_len is None or plan.form is None:
        raise ValueError("ell_band_prepare: the plan has no row lengths")
    lens = plan.row_len[:n]
    if plan.form.name == "rows":            # no lengths: every row full
        return EllBandLayout(plan, data_dev, rel_dev,
                             None if (lens == plan.width).all()
                             else torch.as_tensor(lens, device=dev), None,
                             None, data_dev, rel_dev)
    rows = (np.flatnonzero(lens) if plan.form.compact
            else np.arange(n)).astype(np.int32)
    groups = (lens[rows].astype(np.int64) + 3) // 4
    live = torch.as_tensor(rows, device=dev)
    k4 = -(-plan.width // 4) * 4
    R = plan.block_rows

    def rows_of(t, pad):            # [m, k4]: the computed rows' slots
        t = (t.index_select(1, live.long()) if plan.form.compact
             else t[:, :n]).t()
        if k4 == plan.width:
            return t
        return torch.cat([t, pad[:, None].to(t.dtype).expand(
            -1, k4 - plan.width)], 1)

    # each row's slots up to its length rounded up to a whole group of 4
    # (the plan's own zero padding, then zeros pointing at the row)
    own = R + live.long() % R
    full_d = rows_of(data_dev, torch.zeros_like(own))
    full_r = rows_of(rel_dev, own)
    bits = None
    if plan.form.compact:
        words = np.zeros(-(-n // 32), np.uint32)
        np.bitwise_or.at(words, rows // 32,
                         np.left_shift(1, rows % 32).astype(np.uint32))
        bits = torch.as_tensor(words.view(np.int32), device=dev)
    if plan.form.name == "split":
        ptr = np.zeros(rows.size + 1, np.int64)
        np.cumsum(4 * groups, out=ptr[1:])
        if ptr[-1] >= 2 ** 31:
            raise ValueError("ell_band_prepare: over 2^31 packed slots")
        keep = (torch.arange(k4, device=dev)[None, :]
                < torch.as_tensor(4 * groups, device=dev)[:, None])
        return EllBandLayout(
            plan, data_dev, rel_dev,
            torch.as_tensor(ptr.astype(np.int32), device=dev),
            live if plan.form.compact else None, bits, full_d[keep],
            full_r[keep])
    # "sliced"
    perm = np.lexsort((-groups, np.arange(rows.size) // _SLICE_WINDOW))
    g = max(1, int(groups.max()) if groups.size else 1)
    p_dev = torch.as_tensor(perm, device=dev)
    pad = -rows.size % 32

    def sliced(t):                  # [slices, g, 32, 4], flattened
        t = t.index_select(0, p_dev)[:, :4 * g]
        t = torch.cat([t, t.new_zeros((pad, 4 * g))])
        return t.reshape(-1, 32, g, 4).permute(0, 2, 1, 3).reshape(-1)

    return EllBandLayout(
        plan, data_dev, rel_dev,
        torch.as_tensor(groups[perm].astype(np.int32), device=dev),
        torch.as_tensor(rows[perm], device=dev), bits,
        sliced(full_d).contiguous(), sliced(full_r).contiguous(), g)


def _row_align(itemsize: int, q: int, *tensors) -> int:
    """The bytes (16, 8 or the value's) every row of q values of each
    tensor starts on: what B10's vector accesses may assume."""
    return math.gcd(16, q * itemsize, *(t.data_ptr() for t in tensors))


def _expect(what, t, dtype, shape, device):
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or t.device != device or not t.is_contiguous()):
        raise ValueError(f"{what}: expected contiguous {dtype} "
                         f"{tuple(shape)} on {device}, got {tuple(t.shape)} "
                         f"{t.dtype} {t.device}")


def _new_output(n, **kw):
    """B9's and B9g's output, every row of which the kernel writes."""
    return torch.empty(n, **kw)


def _check_types(what, table, key, data, x):
    entry = table.get(key)
    if entry is None:
        raise TypeError(f"{what}: takes (value, index) types "
                        f"{sorted(_TYPES, key=str)}, got {key}")
    if x.dtype != data.dtype or x.device != data.device \
            or not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous {data.dtype} on "
                         f"{data.device}, got {x.dtype} {x.device}")
    return entry


def _launch_multi(what, data, idx, X, rows, k, row_stride, slot_stride,
                  block_rows):
    """One launch of B10 (csrc/ell.cu) on (data, idx) of X's type: k slots
    per row at the given strides; X [rows the columns reach, q]."""
    entry = _check_types(what, _MULTI_ENTRY, (data.dtype, idx.dtype), data,
                         X)
    q = X.shape[1]
    with torch.cuda.device(X.device):
        Y = torch.empty((rows, q), dtype=X.dtype, device=X.device)
        threads, window = ell_multi_tiling(X.element_size(), q)
        if not block_rows:          # absolute columns: no band to stage
            window = 0
        status = getattr(_lib(), entry)(
            data.data_ptr(), idx.data_ptr(), X.data_ptr(), Y.data_ptr(),
            rows, k, row_stride, slot_stride, block_rows, q,
            _row_align(X.element_size(), q, X, Y), threads, window,
            stream_handle())
    check_launch(status, what)
    return Y


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


def _band_layout(what, plan, data_dev, rel_dev, x, layout):
    """The layout a B9 launch reads: ``layout`` where it still fits the
    plan and arrays (else raises), else one prepared now (the arrays
    checked first)."""
    if layout is None:
        _check_band(what, plan, data_dev, rel_dev, x, x.shape[0])
        return ell_band_prepare(plan, data_dev, rel_dev)
    if not layout.fits(plan, data_dev, rel_dev):
        raise ValueError(f"{what}: the layout was prepared for another plan "
                         "or arrays, or their contents changed since "
                         "(ell_band_prepare again)")
    return layout


def _band_launch(what, lay, x):
    """One launch of B9 on a prepared layout: y [n] for x [n or NP]."""
    plan = lay.plan
    if (x.dtype != lay.dtype or x.device != lay.device or x.dim() != 1
            or x.shape[0] not in (plan.n, plan.np_rows)
            or not x.is_contiguous()):
        raise ValueError(f"{what}: x must be contiguous {lay.dtype} [n] or "
                         f"[NP] on {lay.device}, got {x.dtype} "
                         f"{tuple(x.shape)} {x.device}")
    fn = lay.fn
    if fn is None:
        if lay.entry is None:
            raise TypeError(f"{what}: takes (value, index) types "
                            f"{sorted(_TYPES, key=str)}, got "
                            f"({lay.dtype}, {lay.rel.dtype})")
        fn = lay.fn = getattr(_lib(), lay.entry)
    with torch.cuda.device(x.device):
        y = _new_output(plan.n, dtype=x.dtype, device=x.device)
        status = fn(*lay.args[0], x.data_ptr(), y.data_ptr(), *lay.args[1],
                    stream_handle())
    check_launch(status, what)
    return y


def ell_matvec_cuda(plan: ELLBandPlan, data_dev, rel_dev, x, *,
                    per_block: bool = False, segmented=None, layout=None):
    """B9: y = A x with the banded kernel in the plan's form
    (``ell_band_design``); B11 with ``per_block=True`` (the plan must
    carry its ``dtab``).

    data_dev / rel_dev: device copies of plan.data_t / plan.rel ([K, NP]);
    x [n] (or [NP]); returns y [n].  ``layout``: the arrays the form reads
    (``ell_band_prepare`` on these arrays); without it each call prepares
    them first.  ``segmented`` is accepted for the reference's signature;
    every call is one launch.  No host sync (once prepared).
    """
    del segmented
    if per_block and plan.dtab is None:
        raise ValueError("per_block needs a plan built with per_block=True")
    if x.device.type == "cpu":
        return ell_band_matvec_plain(plan, data_dev, rel_dev, x)
    what = "ell_matvec" + ("_per_block" if per_block else "")
    if x.dim() != 1:
        raise ValueError(f"{what}: x must be 1-D, got {tuple(x.shape)}")
    y = _band_launch(what, _band_layout(what, plan, data_dev, rel_dev, x,
                                        layout), x)
    ell_matvec_cuda.launches += 1
    if per_block:
        ell_matvec_cuda.launches_per_block += 1
    return y


ell_matvec_cuda.launches = 0
ell_matvec_cuda.launches_per_block = 0


def ell_matvec_multi_cuda(plan: ELLBandPlan, data_dev, rel_dev, X, *,
                          segmented=None, layout=None):
    """B10: Y = A X for X [n, q] (or [NP, q]) with the banded kernel, the
    matrix read once for all q columns; returns Y [n, q].  One column
    takes B9's kernel (``layout`` as ``ell_matvec_cuda``'s).  No host
    sync."""
    del segmented
    if X.dim() != 2:
        raise ValueError("ell_matvec_multi_cuda expects X [N, q]")
    if X.device.type == "cpu":
        return ell_band_matvec_multi_plain(plan, data_dev, rel_dev, X)
    _check_band("ell_matvec_multi", plan, data_dev, rel_dev, X, X.shape[0])
    if X.shape[1] == 1:         # one column: B9's kernel
        x = X.reshape(-1)
        Y = _band_launch("ell_matvec_multi", _band_layout(
            "ell_matvec_multi", plan, data_dev, rel_dev, x, layout),
            x)[:, None]
    else:
        Y = _launch_multi("ell_matvec_multi", data_dev, rel_dev, X, plan.n,
                          plan.width, 1, plan.np_rows, plan.block_rows)
    ell_matvec_multi_cuda.launches += 1
    return Y


ell_matvec_multi_cuda.launches = 0


def _check_gather(what, data, cols, x):
    n, K = data.shape
    _expect(what + " data", data, x.dtype, (n, K), x.device)
    _expect(what + " cols", cols, torch.int32, (n, K), x.device)
    # x holds the rows the columns reach: any count (a rectangular
    # operator, e.g. an AMG prolongator, gathers from fewer or more rows)
    if x.shape[0] < 1:
        raise ValueError(f"{what}: x has no rows")


def _gather_launch(what, data, cols, x):
    """One launch of B9g: y [N] for x [rows the columns reach]."""
    entry = _check_types(what, _GATHER1_ENTRY, data.dtype, data, x)
    n, K = data.shape
    t, chunk = ell_gather_tiling(x.element_size(), K, n)
    # a thread a row: -1; -t lanes a row: -log2(-t); a tile of rows other
    # than 1 ... 128 raises
    shift = (-((-t).bit_length() - 1) if t < 0
             else t.bit_length() - 1 if t & (t - 1) == 0 else -4)
    with torch.cuda.device(x.device):
        y = _new_output(n, dtype=x.dtype, device=x.device)
        status = getattr(_lib(), entry)(
            data.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(), n,
            K, shift, chunk, stream_handle())
    check_launch(status, what)
    return y


def ell_gather_matvec_cuda(data, cols, x):
    """y = A x on row-major data / cols [N, K] (absolute columns into the
    rows of x, which may number other than N): kernel B9g in the design
    ``ell_gather_tiling`` picks, summed in slot order, a zero value's x
    skipped.  No host sync."""
    if x.device.type == "cpu":
        return ell_gather_matvec_plain(data, cols, x)
    what = "ell_gather_matvec"
    _check_gather(what, data, cols, x)
    if x.dim() != 1:
        raise ValueError(f"{what}: x must be 1-D")
    y = _gather_launch(what, data, cols, x)
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
    if X.shape[1] == 1:         # one column: B9g's kernel
        Y = _gather_launch("ell_gather_matvec_multi", data, cols,
                           X.reshape(-1))[:, None]
    else:
        Y = _launch_multi("ell_gather_matvec_multi", data, cols, X, n, K, K,
                          1, 0)
    ell_gather_matvec_multi_cuda.launches += 1
    return Y


ell_gather_matvec_multi_cuda.launches = 0


# -- B12: the BCSR block SpMV ------------------------------------------------------

def bcsr_band_plan(data, cols, *, block_rows: int = 1024, **plan_kw):
    """Banded plan of a BCSR matrix (data [NR, K, b, b], cols [NR, K];
    numpy arrays or tensors).

    Returns (plan, data_t [K, b, b, NP] numpy): the plan's rel and schedule
    are ``ell_band_plan``'s on the node pattern (its own data_t holds ones:
    only the pattern matters), the values are transposed to block-plane
    major so each (c, d) component streams contiguously.
    """
    data = _numpy(data)
    cols = _numpy(cols)
    nr, K, b, _ = data.shape
    scalar = np.ones((nr, K), data.dtype)     # only the pattern matters
    plan = ell_band_plan(scalar, cols, block_rows=block_rows, **plan_kw)
    pad = plan.np_rows - nr
    if pad:
        data = np.pad(data, ((0, pad), (0, 0), (0, 0), (0, 0)))
    return plan, np.ascontiguousarray(np.transpose(data, (1, 2, 3, 0)))


def bcsr_band_matvec_plain(plan: ELLBandPlan, data_dev, rel_dev, x):
    """Plain PyTorch version of B12: x [b, n] (or [b, NP]) padded to NP as
    the reference pads it; y [b, n] summed k outer, then source component
    d, each product added to every output c (the TPU kernel's order)."""
    cols = _window_cols(plan, rel_dev)
    b = data_dev.shape[1]
    xp = x
    if x.shape[-1] != plan.np_rows:
        xp = torch.cat([x, x.new_zeros((b, plan.np_rows - x.shape[-1]))], 1)
    y = [torch.zeros(plan.np_rows, dtype=x.dtype, device=x.device)
         for _ in range(b)]
    for k in range(plan.width):
        for d in range(b):
            g = xp[d][cols[k]]
            for c in range(b):
                y[c] = y[c] + data_dev[k, c, d] * g
    return torch.stack(y)[:, :plan.n]


def bcsr_gather_matvec_plain(data, cols, x):
    """The gather form y = A x: data [NR, K, b, b], cols [NR, K], x
    node-major [NR * b] -> y [NR * b].  The reference's
    ``(data * x[cols][:, :, None, :]).sum((1, 3))`` with its sum written
    out in B12's order (k, then d), so B12g (``bcsr_gather_matvec_cuda``)
    equals it bit for bit."""
    nr, K, b, _ = data.shape
    xb = x.reshape(nr, b)
    c = cols.long()
    y = torch.zeros((nr, b), dtype=x.dtype, device=x.device)
    for k in range(K):
        g = xb[c[:, k]]                                   # [NR, b]
        for d in range(b):
            y = y + data[:, k, :, d] * g[:, d, None]
    return y.reshape(-1)


# the block sizes B12 and B12g are built for: 2 and 3 (2D and 3D
# elasticity), up to 6 (the block AMG's transfers and coarse levels)
BCSR_BLOCK_SIZES = (2, 3, 4, 5, 6)
# data, idx, x, y, rows, k, 10 strides, tile_rows, stream
_BCSR_ARGS = (_P, _P, _P, _P, _LL, _I) + (_LL,) * 10 + (_I, _P)
_BCSR_ENTRY = {(t, i, b): f"tpufem_bcsr_spmv_{tn}_{iname}_b{b}"
               for t, tn in ((torch.float32, "f32"), (torch.float64, "f64"))
               for i, iname in ((torch.int16, "i16"), (torch.int32, "i32"))
               for b in BCSR_BLOCK_SIZES}
# B12, B threads a row: the same arguments
_OUT_ENTRY = {key: name.replace("spmv", "out")
              for key, name in _BCSR_ENTRY.items()}
# data, cols, x, y, nr, k, tile_rows, stream
_GATHER_ARGS = (_P, _P, _P, _P, _LL, _I, _I, _P)
_GATHER_ENTRY = {(t, b): f"tpufem_bcsr_gather_{tn}_b{b}"
                 for t, tn in ((torch.float32, "f32"), (torch.float64, "f64"))
                 for b in BCSR_BLOCK_SIZES}


def _bcsr_lib():
    return load_library("bcsr.cu", {
        **{e: _BCSR_ARGS for e in _BCSR_ENTRY.values()},
        **{e: _BCSR_ARGS for e in _OUT_ENTRY.values()},
        **{e: _GATHER_ARGS for e in _GATHER_ENTRY.values()}})


# B12's block rows a block (one thread each, at most 384): every tile the
# sweep (``scripts/kernel_ab.py --tiles``) times at the paths' shapes
BCSR_TILE_ROWS = (128, 256, 384)


def bcsr_band_tiling() -> int:
    """B12's block rows a block (one thread a row), one of
    ``BCSR_TILE_ROWS``: 384, the fastest (or within 1% of it) at each of
    the elasticity paths' four shapes and types in the sweep, so every
    shape and type takes it."""
    return 384


# the "out" form: block rows a block (B threads each), and the rows under
# which it is taken
_OUT_ROWS = 32
_OUT_MAX_ROWS = 65536


def bcsr_band_design(b: int, k: int, rows: int) -> str:
    """B12's form for ``rows`` block rows of b x b blocks and k slots:
    "unrolled" (b = 2, 3 with K = 8 or 16, the elasticity operators: a
    thread a row, the slots unrolled and loaded ahead), "out" (b threads a
    row, a run-time slot loop in groups loaded ahead: b = 2, 3 on fewer
    than 65,536 rows, the 982k hierarchy's coarse levels and transfers) or
    "loop" (a thread a row, the run-time slot loop in groups: every other
    shape, b = 4 to 6 among them, where b threads a row measured slower).
    The picks are ``scripts/bcsr_amg_ab.py``'s fastest (PERF.md)."""
    if b <= 3 and k in (8, 16):
        return "unrolled"
    return "out" if b <= 3 and rows < _OUT_MAX_ROWS else "loop"


def bcsr_loop_tiling(rows: int) -> int:
    """Block rows a block of B12's run-time-K instance: 384, or fewer
    (down to 32, whole warps) where the rows are few, so that the blocks
    fill two per SM of the card's 132 (the AMG's coarse levels: a few
    hundred to a few thousand rows; measured, PERF.md)."""
    per_block = -(-int(rows) // (2 * _SMS))
    return max(32, min(384, -(-per_block // 32) * 32))


def _bcsr_launch(what, data, idx, x, y, rows, k, d_strides, i_strides,
                 block_rows):
    """One launch of B12 on the banded plan: ``rows`` block rows of ``k``
    slots; d_strides (row, slot, component) of data, i_strides (row, slot)
    of the indices; x and y 2-D [b, rows-or-more] views (component,
    node).  The instance and its tile by ``bcsr_band_design``."""
    b = data.shape[1]
    design = bcsr_band_design(b, k, rows)
    entry = (_OUT_ENTRY if design == "out" else _BCSR_ENTRY).get(
        (data.dtype, idx.dtype, b))
    if entry is None:
        raise TypeError(f"{what}: takes fp32/fp64 values, int16/int32 "
                        f"indices and b in {BCSR_BLOCK_SIZES}, got "
                        f"({data.dtype}, {idx.dtype}, b={b})")
    if x.dtype != data.dtype or x.device != data.device:
        raise ValueError(f"{what}: x must be {data.dtype} on {data.device}, "
                         f"got {x.dtype} {x.device}")
    tile_rows = {"unrolled": bcsr_band_tiling, "out": lambda: _OUT_ROWS,
                 "loop": lambda: bcsr_loop_tiling(rows)}[design]()
    with torch.cuda.device(x.device):
        status = getattr(_bcsr_lib(), entry)(
            data.data_ptr(), idx.data_ptr(), x.data_ptr(), y.data_ptr(),
            rows, k, *d_strides, *i_strides, block_rows, *x.stride(),
            *y.stride(), tile_rows, stream_handle())
    check_launch(status, what)
    return y


def bcsr_matvec_cuda(plan: ELLBandPlan, data_dev, rel_dev, x, *,
                     per_block: bool = False):
    """B12: y = A x for a banded BCSR matrix.

    data_dev [K, b, b, NP] (from ``bcsr_band_plan``), rel_dev [K, NP], x
    [b, n] (or [b, NP]) component-major, in any strides (a transposed view
    of a node-major vector is fine); returns y [b, n].  ``per_block`` (the
    TPU's delta-table variant; the plan must carry its ``dtab``) launches
    the same kernel.  No host sync.
    """
    if per_block and plan.dtab is None:
        raise ValueError("per_block needs a plan built with per_block=True")
    if x.device.type == "cpu":
        return bcsr_band_matvec_plain(plan, data_dev, rel_dev, x)
    what = "bcsr_matvec" + ("_per_block" if per_block else "")
    K, NP = plan.width, plan.np_rows
    if data_dev.dim() != 4 or x.dim() != 2:
        raise ValueError(f"{what}: expected data_t [K, b, b, NP] and x "
                         f"[b, n], got {tuple(data_dev.shape)} and "
                         f"{tuple(x.shape)}")
    b = data_dev.shape[1]
    _expect(what + " data_t", data_dev, x.dtype, (K, b, b, NP), x.device)
    if rel_dev.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"{what}: rel must be int16 or int32, got "
                        f"{rel_dev.dtype}")
    _expect(what + " rel", rel_dev, rel_dev.dtype, (K, NP), x.device)
    if x.shape[0] != b or x.shape[1] not in (plan.n, NP):
        raise ValueError(f"{what}: x has shape {tuple(x.shape)}, the plan "
                         f"[{b}, {plan.n}] (or {NP} padded)")
    y = torch.empty((b, plan.n), dtype=x.dtype, device=x.device)
    _bcsr_launch(what, data_dev, rel_dev, x, y, plan.n, K,
                 (1, b * b * NP, NP), (1, NP), plan.block_rows)
    bcsr_matvec_cuda.launches += 1
    bcsr_matvec_cuda.launches_by_block[b] += 1
    if per_block:
        bcsr_matvec_cuda.launches_per_block += 1
    return y


bcsr_matvec_cuda.launches = 0
bcsr_matvec_cuda.launches_per_block = 0
# the launches by block size b (the AMG hierarchies' 3 x 3 and 6 x 6)
bcsr_matvec_cuda.launches_by_block = dict.fromkeys(BCSR_BLOCK_SIZES, 0)


_GATHER_MAX_THREADS = 384
# bytes of one staged tile: two buffers of about this size leave room for
# four blocks on an SM, which measured fastest at the paths' shapes
_GATHER_STAGE = 24 * 1024


def _span_region(nbytes: int) -> int:
    """Shared memory of one staged span of ``nbytes`` at any 16-byte phase:
    its window of whole 16-byte chunks with 16 bytes of padding after every
    128 (csrc/bcsr.cu's span_region)."""
    window = (nbytes + 30) // 16 * 16
    return window + ((window - 16) >> 7) * 16


@functools.lru_cache(maxsize=None)
def bcsr_gather_tiling(itemsize: int, b: int, k: int):
    """B12g's tile for b x b blocks of ``itemsize``-byte values and ``k``
    slots: (tile_rows, shared memory bytes of its ring of two buffers).

    The most rows (128 down to 4, b threads a row) whose staged values and
    columns fit ``_GATHER_STAGE``; past that size 4 rows, or 2 or 1 where
    the two buffers of 4 do not fit a block's 227 KB (the fat-K, 6 x 6
    coarse levels of a block AMG hierarchy: 1 row of K = 128 fp64 blocks
    stages 37 KB).  Raises ValueError where not even one row fits (k
    beyond about 390 fp64 6 x 6 slots)."""
    def stage(r):
        return (_span_region(r * k * b * b * itemsize)
                + _span_region(r * k * 4))

    rows = None
    for r in (128, 64, 32, 16, 8, 4):
        if r * b <= _GATHER_MAX_THREADS and stage(r) <= _GATHER_STAGE:
            rows = r
            break
    if rows is None:
        rows = next((r for r in (4, 2, 1)
                     if 2 * stage(r) <= _SMEM_PER_BLOCK), None)
    if rows is None:
        raise ValueError(f"B12g: no tile of {k} slots of {b} x {b} blocks "
                         f"of {itemsize}-byte values fits shared memory")
    return rows, 2 * stage(rows)


def bcsr_gather_matvec_cuda(data, cols, x):
    """y = A x on row-major data [NR, K, b, b] / int32 cols [NR, K]
    (absolute columns) for node-major x [NR * b]: kernel B12g, which
    stages tiles of rows through shared memory (``bcsr_gather_tiling``).
    Any contiguous views are taken.  No host sync."""
    if x.device.type == "cpu":
        return bcsr_gather_matvec_plain(data, cols, x)
    what = "bcsr_gather_matvec"
    if data.dim() != 4:
        raise ValueError(f"{what}: expected data [NR, K, b, b], got "
                         f"{tuple(data.shape)}")
    nr, K, b, _ = data.shape
    _expect(what + " data", data, x.dtype, (nr, K, b, b), x.device)
    _expect(what + " cols", cols, torch.int32, (nr, K), x.device)
    _expect(what + " x", x, x.dtype, (nr * b,), x.device)
    entry = _GATHER_ENTRY.get((x.dtype, b))
    if entry is None:
        raise TypeError(f"{what}: takes fp32/fp64 values and b in "
                        f"{BCSR_BLOCK_SIZES}, got {x.dtype}, b={b}")
    rows, _ = bcsr_gather_tiling(x.element_size(), b, K)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        status = getattr(_bcsr_lib(), entry)(
            data.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(), nr,
            K, rows, stream_handle())
    check_launch(status, what)
    bcsr_gather_matvec_cuda.launches += 1
    return y


bcsr_gather_matvec_cuda.launches = 0
