"""ctypes loader for the native host library, as in tpufem.native.

``csrc/meshgen.cpp`` (the JAX package's C++ source, its code unchanged) is
a C-ABI shared object for the host setup's sequential loops: mesh
generation, the node adjacency and ELL pattern, reverse Cuthill-McKee,
greedy aggregation and the AMG Galerkin products.  ``build_native``
compiles it with the host compiler (``g++ -O2 -fPIC -std=c++17 -shared``,
the reference's Makefile flags) into ``tpufem_torch/_build/`` at first
use, never at import, keyed by a hash of the source and the flags.

Unlike the reference, nothing here falls back: a library that cannot be
built or loaded raises, and the callers that take ``use_native`` /
``native_setup`` run the numpy specification only when the caller asks
for it with False.

Usage:
    from tpufem_torch import native
    lengths, idx = native.node_adjacency(conn, nn)
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["CXX", "CXX_FLAGS", "build_native", "available",
           "rectangle_mesh", "box_mesh", "node_adjacency", "ell_pattern",
           "greedy_aggregate", "ell_pattern2", "galerkin_ell", "bspmm_bell",
           "galerkin_bell", "reverse_cuthill_mckee"]

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "meshgen.cpp"
_BUILD = _PKG / "_build"

# the host compiler (a name on PATH or a path) and the reference's flags
CXX = "g++"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared")

_lib: Optional[ctypes.CDLL] = None

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def _library_path() -> Path:
    h = hashlib.sha256()
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD / f"meshgen-{h.hexdigest()[:16]}.so"


def build_native(force: bool = False) -> Path:
    """Compile the library (once per source and flags) and return its
    path.  Raises RuntimeError when the compiler is missing or fails."""
    so = _library_path()
    if so.exists() and not force:
        return so
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(f"native library: host compiler {CXX!r} not "
                           "found (the port builds csrc/meshgen.cpp at "
                           "first use)")
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native library: {CXX} failed on meshgen.cpp "
                           f"(rc {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def _load() -> ctypes.CDLL:
    """The bound library, built at the first call; raises on failure."""
    global _lib
    if _lib is None:
        _lib = _bind(ctypes.CDLL(str(build_native())))
    return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.tpufem_rectangle_mesh.argtypes = [
        ctypes.c_double] * 4 + [ctypes.c_int64] * 2 + [_f64p, _i32p, _i32p]
    lib.tpufem_rectangle_mesh.restype = None
    lib.tpufem_box_mesh.argtypes = [
        ctypes.c_double] * 6 + [ctypes.c_int64] * 3 + [_f64p, _i32p, _i32p]
    lib.tpufem_box_mesh.restype = None
    lib.tpufem_node_adjacency.argtypes = [
        _i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_int32, _i32p, ctypes.c_void_p]
    lib.tpufem_node_adjacency.restype = ctypes.c_int32
    lib.tpufem_ell_pattern.argtypes = [
        _i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_int32, _i32p, _i32p, _i32p]
    lib.tpufem_ell_pattern.restype = ctypes.c_int64
    lib.tpufem_rcm.argtypes = [_i32p, ctypes.c_int64, ctypes.c_int32, _i64p]
    lib.tpufem_rcm.restype = None
    lib.tpufem_greedy_aggregate.argtypes = [
        _i32p, ctypes.c_int64, ctypes.c_int32, _i64p]
    lib.tpufem_greedy_aggregate.restype = ctypes.c_int64
    lib.tpufem_ell_pattern2.argtypes = [
        _i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.tpufem_ell_pattern2.restype = ctypes.c_int64
    lib.tpufem_galerkin_ell.argtypes = [
        _f64p, _i32p, ctypes.c_int64, ctypes.c_int32,
        _f64p, _i32p, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p]
    lib.tpufem_galerkin_ell.restype = ctypes.c_int64
    blk_args = [
        _f64p, _i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        _f64p, _i32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p]
    lib.tpufem_bspmm_bell.argtypes = blk_args
    lib.tpufem_bspmm_bell.restype = ctypes.c_int64
    lib.tpufem_galerkin_bell.argtypes = blk_args
    lib.tpufem_galerkin_bell.restype = ctypes.c_int64
    return lib


def available() -> bool:
    """True once the library is built and bound; raises if it cannot be
    (the reference returns False and its callers fall back)."""
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def rectangle_mesh(x0, x1, y0, y1, n_row, n_col):
    """Structured rectangle mesh -> (coords, conn, flags)."""
    lib = _load()
    nn = (n_row + 1) * (n_col + 1)
    ne = 2 * n_row * n_col
    coords = np.empty((nn, 2), np.float64)
    conn = np.empty((ne, 3), np.int32)
    flags = np.empty(nn, np.int32)
    lib.tpufem_rectangle_mesh(x0, x1, y0, y1, n_row, n_col,
                              coords, conn, flags)
    return coords, conn, flags


def box_mesh(x0, x1, y0, y1, z0, z1, nx, ny, nz):
    """Structured Kuhn-tetrahedron box mesh -> (coords, conn, flags)."""
    lib = _load()
    nn = (nx + 1) * (ny + 1) * (nz + 1)
    ne = 6 * nx * ny * nz
    coords = np.empty((nn, 3), np.float64)
    conn = np.empty((ne, 4), np.int32)
    flags = np.empty(nn, np.int32)
    lib.tpufem_box_mesh(x0, x1, y0, y1, z0, z1, nx, ny, nz,
                        coords, conn, flags)
    return coords, conn, flags


def node_adjacency(conn: np.ndarray, num_nodes: int,
                   max_length: int | None = None):
    """Per-node neighbour lists (parity with
    mesh.adjacency.node_adjacency)."""
    lib = _load()
    conn = np.ascontiguousarray(conn, np.int32)
    ne, npe = conn.shape
    lengths = np.empty(num_nodes, np.int32)
    if max_length is None:
        max_length = int(lib.tpufem_node_adjacency(conn, ne, npe, num_nodes,
                                                   0, lengths, None))
    indices = np.empty((num_nodes, max_length), np.int32)
    got = lib.tpufem_node_adjacency(conn, ne, npe, num_nodes, max_length,
                                    lengths, _ptr(indices))
    if got > max_length:
        raise ValueError(f"max_length={max_length} < max degree {got}")
    return lengths, indices


def ell_pattern(conn: np.ndarray, num_nodes: int, width: int):
    """ELL cols / diagonal / slots.  Returns (nnz, cols, diag_pos, slots)."""
    lib = _load()
    conn = np.ascontiguousarray(conn, np.int32)
    ne, npe = conn.shape
    cols = np.empty((num_nodes, width), np.int32)
    diag = np.empty(num_nodes, np.int32)
    slots = np.empty((ne, npe, npe), np.int32)
    nnz = lib.tpufem_ell_pattern(conn, ne, npe, num_nodes, width,
                                 cols, diag, slots)
    if nnz < 0:
        raise ValueError(f"width {width} smaller than max row degree")
    return int(nnz), cols, diag, slots


def greedy_aggregate(cols: np.ndarray):
    """Two-pass greedy aggregation (partition parity with
    solve.amg.greedy_aggregate; ids in raw creation order, the caller
    renumbers).  Returns (agg [n] int64, n_agg)."""
    lib = _load()
    cols = np.ascontiguousarray(cols, np.int32)
    n, k = cols.shape
    agg = np.empty(n, np.int64)
    na = lib.tpufem_greedy_aggregate(cols, n, k, agg)
    return agg, int(na)


def ell_pattern2(conn: np.ndarray, num_nodes: int, width_guess: int = 8):
    """ELL pattern + scatter slots by a row counting sort (O(nnz)).
    Returns (cols [nn, K] int32, lengths [nn] int32, diag_pos [nn] int32,
    slots [ne, npe, npe] int32) with K >= the true max row degree; a
    guess below it is retried at the width the library asks for."""
    lib = _load()
    conn = np.ascontiguousarray(conn, np.int32)
    ne, npe = conn.shape
    W = max(int(width_guess), 1)
    for _ in range(4):
        cols = np.empty((num_nodes, W), np.int32)
        lengths = np.empty(num_nodes, np.int32)
        diag = np.empty(num_nodes, np.int32)
        slots = np.empty((ne, npe, npe), np.int32)
        need = lib.tpufem_ell_pattern2(conn, ne, npe, num_nodes, W,
                                       _ptr(cols), _ptr(lengths),
                                       _ptr(diag), _ptr(slots))
        if need < 0:
            raise ValueError("ell_pattern2: ne*npe^2 exceeds int32 range")
        if need <= W:
            return cols, lengths, diag, slots
        W = int(need)
    raise RuntimeError("ell_pattern2 width did not converge")


def galerkin_ell(a_data: np.ndarray, a_cols: np.ndarray,
                 p_data: np.ndarray, p_cols: np.ndarray, nc: int,
                 width_guess: int = 0):
    """A_c = P^T A P over zero-padded ELL operands (the AMG setup's hot
    loop).  Returns (c_data [nc, W] float64, c_cols [nc, W] int32)."""
    lib = _load()
    a_data = np.ascontiguousarray(a_data, np.float64)
    a_cols = np.ascontiguousarray(a_cols, np.int32)
    p_data = np.ascontiguousarray(p_data, np.float64)
    p_cols = np.ascontiguousarray(p_cols, np.int32)
    if a_data.shape != a_cols.shape or p_data.shape != p_cols.shape:
        raise ValueError("data/cols shape mismatch")
    if a_data.shape[0] != p_data.shape[0]:
        raise ValueError("A and P row counts differ")
    n, K = a_data.shape
    Kp = p_data.shape[1]
    W = int(width_guess) or max(4 * K, 24)
    for _ in range(3):
        c_data = np.empty((nc, W), np.float64)
        c_cols = np.empty((nc, W), np.int32)
        need = lib.tpufem_galerkin_ell(a_data, a_cols, n, K, p_data, p_cols,
                                       Kp, nc, W, _ptr(c_data), _ptr(c_cols))
        if need <= W:
            return c_data, c_cols
        W = int(need)
    raise RuntimeError("galerkin_ell width did not converge")


def _check_block_operands(a_data, a_cols, p_data, p_cols):
    a_data = np.ascontiguousarray(a_data, np.float64)
    a_cols = np.ascontiguousarray(a_cols, np.int32)
    p_data = np.ascontiguousarray(p_data, np.float64)
    p_cols = np.ascontiguousarray(p_cols, np.int32)
    if a_data.shape[:2] != a_cols.shape or p_data.shape[:2] != p_cols.shape:
        raise ValueError("block data/cols shape mismatch")
    if a_data.shape[0] != p_data.shape[0]:
        raise ValueError("A and P row counts differ")
    if (a_data.shape[2] != a_data.shape[3]
            or a_data.shape[3] != p_data.shape[2]):
        raise ValueError("block dims incompatible (A [n,K,b,b], P [n,Kp,b,m])")
    return a_data, a_cols, p_data, p_cols


def _block_product(entry, a_data, a_cols, p_data, p_cols, nc, width_guess,
                   first, out_rows):
    a_data, a_cols, p_data, p_cols = _check_block_operands(
        a_data, a_cols, p_data, p_cols)
    n, K, b, _ = a_data.shape
    Kp, m = p_data.shape[1], p_data.shape[3]
    W = int(width_guess) or first(K)
    rows = n if out_rows == "n" else nc
    bm = (b, m) if out_rows == "n" else (m, m)
    for _ in range(3):
        c_data = np.empty((rows, W) + bm, np.float64)
        c_cols = np.empty((rows, W), np.int32)
        need = entry(a_data.reshape(-1), a_cols, n, K, b,
                     p_data.reshape(-1), p_cols, Kp, m, nc, W,
                     _ptr(c_data), _ptr(c_cols))
        if need <= W:
            return c_data, c_cols
        W = int(need)
    return None


def bspmm_bell(a_data: np.ndarray, a_cols: np.ndarray,
               p_data: np.ndarray, p_cols: np.ndarray, nc: int,
               width_guess: int = 0):
    """Blocked SpMM C = A @ P over zero-padded block-ELL operands.
    A [n,K,b,b]/[n,K], P [n,Kp,b,m]/[n,Kp] -> (c_data [n,W,b,m], c_cols)."""
    out = _block_product(_load().tpufem_bspmm_bell, a_data, a_cols, p_data,
                         p_cols, nc, width_guess, lambda K: max(2 * K, 16),
                         "n")
    if out is None:
        raise RuntimeError("bspmm_bell width did not converge")
    return out


def galerkin_bell(a_data: np.ndarray, a_cols: np.ndarray,
                  p_data: np.ndarray, p_cols: np.ndarray, nc: int,
                  width_guess: int = 0):
    """Blocked Galerkin A_c = P^T A P (the block analogue of
    galerkin_ell).  Returns (c_data [nc, W, m, m] float64, c_cols [nc, W]
    int32)."""
    out = _block_product(_load().tpufem_galerkin_bell, a_data, a_cols,
                         p_data, p_cols, nc, width_guess,
                         lambda K: max(4 * K, 24), "nc")
    if out is None:
        raise RuntimeError("galerkin_bell width did not converge")
    return out


def reverse_cuthill_mckee(cols: np.ndarray) -> np.ndarray:
    """Level-set RCM (exact parity with
    mesh.adjacency.reverse_cuthill_mckee's numpy version)."""
    lib = _load()
    cols = np.ascontiguousarray(cols, np.int32)
    n, k = cols.shape
    perm = np.empty(n, np.int64)
    lib.tpufem_rcm(cols, n, k, perm)
    return perm
