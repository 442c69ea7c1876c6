"""Fused V-cycle transfers: kernels K3 and K4 (csrc/mg_transfer.cu).

K3 ``const_residual_restrict_embedded`` replaces
tpufem/ops/mg_transfer_pallas.py::_kern_rr:  rc = mask_c(R (r - A e)).
K4 ``const_prolong_add_smooth_embedded`` replaces ::_kern_pas:
e' = S_omega(r, e + P ec), optionally with <r, e'>.

R/P structure (solve/multigrid.py): P = W . inject2, R = sample2 . W with
W = I + 0.5 * (Kuhn adjacency stencil); A is the constant-coefficient
operator of the level (weights + row-type code plane).  Each wrapper
launches its kernel for a CUDA tensor and runs its plain version — the
unfused composition of ``solve.multigrid`` — for a CPU tensor.  Both
kernels stage tiles of 128 fine store columns through shared memory and
march over ranges of planes; ``transfer_tiling`` picks each launch's tile.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from tpufem_torch.ops._build import check_launch, load_library, stream_handle
from tpufem_torch.ops.stencil_cuda import (const_matvec_plain,
                                           const_stencil_apply_plain)
from tpufem_torch.solve.multigrid import prolong, restrict

__all__ = ["const_residual_restrict_embedded",
           "const_prolong_add_smooth_embedded",
           "const_residual_restrict_plain", "const_prolong_add_smooth_plain",
           "transfer_tiling", "transfer_smem", "TILE_ROWS"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_RR_ARGS = (_P,) * 10 + (_I, _I, _I, _P)
_PAS_ARGS = (_P,) * 12 + (_I, _D, _D, _I, _I, _P)
_SIGNATURES = {
    "tpufem_residual_restrict_f32": _RR_ARGS,
    "tpufem_residual_restrict_f64": _RR_ARGS,
    "tpufem_prolong_add_smooth_f32": _PAS_ARGS,
    "tpufem_prolong_add_smooth_f64": _PAS_ARGS,
    "tpufem_mg_transfer_smem": (_I, _I, _I),
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

_TILE_X = 128             # fine store columns of a tile (K3: 64 coarse ones)
_SMS = 132                # streaming multiprocessors of the H100 SXM
_MIN_BLOCKS = 3 * _SMS // 2   # the fewest working blocks a tile leaves
# the tile rows (K4: fine, K3: coarse) the launchers have a kernel for
# (csrc/mg_transfer.cu's TPUFEM_PAS_ROWS, TPUFEM_RR_ROWS), the rows picked
# per item size, and the plane counts tried, most first (the sweep of
# scripts/kernel_ab.py --tiles)
TILE_ROWS = {"K4": (4, 6, 8), "K3": (2, 3, 4)}
_ROWS = {"K4": {4: 8, 8: 4}, "K3": {4: 4, 8: 3}}
_PLANES = {"K4": (32, 16, 8, 4, 2), "K3": (16, 8, 4, 2)}

# the output allocation of K3 (a test fills it with NaN first: the kernel
# must write every coarse row)
_new_output = torch.empty


def _lib():
    return load_library("mg_transfer.cu", _SIGNATURES)


def transfer_smem(kernel: str, itemsize: int, ty: int) -> int:
    """Dynamic shared memory (bytes) of a K3 or K4 block with ``ty`` tile
    rows (csrc/mg_transfer.cu's rr_smem / pas_smem).  K4: eight planes of
    ty + 2 rows of 128 columns and a 16-byte chunk either side (code 3, e
    2, masked e' 3) and four of the ty x 128 core (r 2, e' 2).  K3: seven
    planes of 2 ty + 3 rows of 132 (e 2, code 2, masked 3), two of r (2 ty
    + 1 rows of 132), the ty x 64 coarse codes, four residual planes (2 ty
    + 1 rows of 130) and two of their interior flags (bytes, rounded up to
    16)."""
    if kernel == "K4":
        return (8 * (ty + 2) * (_TILE_X + 32 // itemsize)
                + 4 * ty * _TILE_X) * itemsize
    er, qr = 2 * ty + 3, 2 * ty + 1
    return ((7 * er * (_TILE_X + 4) + 2 * qr * (_TILE_X + 4)
             + ty * _TILE_X // 2 + 4 * qr * (_TILE_X + 2)) * itemsize
            + -(-2 * qr * (_TILE_X + 2) // 16) * 16)


def _tiles(n, t):
    return -(-n // t)


def _working(lo, hi, tile, count):
    """Tiles of ``tile`` (``count`` of them from 0) that meet [lo, hi]."""
    return sum(1 for i in range(count) if i * tile <= hi
               and (i + 1) * tile > lo)


@functools.lru_cache(maxsize=None)
def transfer_tiling(kernel: str, itemsize: int, fine_store_grid: tuple,
                    coarse_store_grid: tuple, coarse_node_grid: tuple):
    """(ty, tz, shared memory bytes, grid) of one K3 or K4 launch.

    K4 tiles the fine store grid: 128 columns x ``ty`` rows x ``tz``
    planes.  K3 tiles the coarse one: 64 columns x ``ty`` rows x ``tz``
    planes, whose fine footprint is 128 columns (plus halo) by 2 ty + 1
    rows.  ``ty`` is fixed per kernel and item size; ``tz`` is the largest
    of 32 (K4 only), 16, 8, 4 and 2 that leaves at least three working
    blocks for every two SMs (K3's blocks that hold no coarse node only
    write zeros and do not count), else 2.  The grid is (columns, rows,
    planes) of tiles."""
    ty = _ROWS[kernel][itemsize]
    if kernel == "K4":
        z, y, x = fine_store_grid
        cols = x // _TILE_X
        work = lambda tz: cols * _tiles(y, ty) * _tiles(z, tz)
    else:
        z, y, x = coarse_store_grid
        n0, n1, n2 = coarse_node_grid
        cols = x // (_TILE_X // 2)
        rows = _working(1, n2, _TILE_X // 2, cols) * _working(
            1, n1, ty, _tiles(y, ty))
        work = lambda tz: rows * _working(1, n0, tz, _tiles(z, tz))
    planes = _PLANES[kernel]
    tz = next((t for t in planes if work(t) >= _MIN_BLOCKS), planes[-1])
    grid = (cols, _tiles(y, ty), _tiles(z, tz))
    return ty, tz, transfer_smem(kernel, itemsize, ty), grid


def _node_grid(plan, x):
    return plan.extract_field(x).reshape(plan.info.node_grid)


def const_residual_restrict_plain(weights, code_f, code_c, r, e,
                                  fine_plan, coarse_plan):
    """Plain PyTorch version of K3: residual, extract, W + sample, embed,
    zero the coarse Dirichlet rows."""
    resid = r - const_matvec_plain(weights, code_f, fine_plan.offsets, e)
    rc = coarse_plan.embed_field(restrict(_node_grid(fine_plan, resid), 3))
    return torch.where(code_c == 2.0, 0.0, rc)


def const_prolong_add_smooth_plain(weights, code_f, ec, r, e, fine_plan,
                                   coarse_plan, *, omega: float = 0.8,
                                   with_dot: bool = False):
    """Plain PyTorch version of K4: prolong, embed, add, one const Jacobi
    sweep (and <r, y>)."""
    ep = e + fine_plan.embed_field(prolong(_node_grid(coarse_plan, ec), 3))
    return const_stencil_apply_plain("smooth", weights, code_f, ep,
                                     fine_plan.offsets, b=r, omega=omega,
                                     with_dot=with_dot)


def _check(tensors, shapes, what):
    ref = tensors[0]
    if ref.dtype not in _SUFFIX:
        raise TypeError(f"{what}: float32/float64 only, got {ref.dtype}")
    for t, shape in zip(tensors, shapes):
        if (t.device != ref.device or t.dtype != ref.dtype
                or tuple(t.shape) != (shape,) or not t.is_contiguous()):
            raise ValueError(f"{what}: expected contiguous {ref.dtype} "
                             f"[{shape}] on {ref.device}, got "
                             f"{tuple(t.shape)} {t.dtype} {t.device}")


def _geometry_args(weights, fine_plan, coarse_plan):
    k = fine_plan.width
    if len(fine_plan.store_grid) != 3 or len(weights) != k:
        raise ValueError("fused transfers are 3D, with one weight per offset")
    ints = ctypes.c_int * 3
    steps = [int(v) for off in fine_plan.offsets_grid for v in off]
    return (ints(*fine_plan.store_grid), ints(*coarse_plan.store_grid),
            ints(*coarse_plan.info.node_grid),
            (ctypes.c_int * (3 * k))(*steps),
            (ctypes.c_double * k)(*(float(w) for w in weights)), k)


def _tiling(kernel, r, fine_plan, coarse_plan):
    return transfer_tiling(kernel, r.element_size(),
                           tuple(fine_plan.store_grid),
                           tuple(coarse_plan.store_grid),
                           tuple(coarse_plan.info.node_grid))


def const_residual_restrict_embedded(weights, code_f, code_c, r, e,
                                     fine_plan, coarse_plan):
    """rc = mask_c(restrict(r - A_const e)) in one fused pass (3D)."""
    if r.device.type == "cpu":
        return const_residual_restrict_plain(weights, code_f, code_c, r, e,
                                             fine_plan, coarse_plan)
    nf, nc = fine_plan.num_store_rows, coarse_plan.num_store_rows
    _check([r, e, code_f, code_c], [nf, nf, nf, nc], "residual_restrict")
    geo = _geometry_args(weights, fine_plan, coarse_plan)
    ty, tz = _tiling("K3", r, fine_plan, coarse_plan)[:2]
    lib = _lib()
    with torch.cuda.device(r.device):
        rc = _new_output(nc, dtype=r.dtype, device=r.device)
        status = getattr(lib, "tpufem_residual_restrict_" + _SUFFIX[r.dtype])(
            code_f.data_ptr(), code_c.data_ptr(), r.data_ptr(), e.data_ptr(),
            rc.data_ptr(), *geo, ty, tz, stream_handle())
    check_launch(status, "residual_restrict")
    const_residual_restrict_embedded.launches += 1
    return rc


const_residual_restrict_embedded.launches = 0


def const_prolong_add_smooth_embedded(weights, code_f, ec, r, e, fine_plan,
                                      coarse_plan, *, omega: float = 0.8,
                                      with_dot: bool = False):
    """e_new = const-smooth(r, e + prolong(ec)) in one fused pass (3D);
    ``with_dot=True`` also returns <r, e_new> as a 0-d tensor."""
    if r.device.type == "cpu":
        return const_prolong_add_smooth_plain(
            weights, code_f, ec, r, e, fine_plan, coarse_plan, omega=omega,
            with_dot=with_dot)
    nf, nc = fine_plan.num_store_rows, coarse_plan.num_store_rows
    _check([r, e, code_f, ec], [nf, nf, nf, nc], "prolong_add_smooth")
    geo = _geometry_args(weights, fine_plan, coarse_plan)
    inv_w0 = 1.0 / float(weights[fine_plan.offsets.index(0)])
    ty, tz, _, grid = _tiling("K4", r, fine_plan, coarse_plan)
    lib = _lib()
    with torch.cuda.device(r.device):
        y = torch.empty_like(r)
        dot = partials = None
        if with_dot:
            dot = torch.empty((), dtype=r.dtype, device=r.device)
            partials = torch.empty(grid[0] * grid[1] * grid[2],
                                   dtype=torch.float64, device=r.device)
        status = getattr(lib,
                         "tpufem_prolong_add_smooth_" + _SUFFIX[r.dtype])(
            code_f.data_ptr(), ec.data_ptr(), r.data_ptr(), e.data_ptr(),
            y.data_ptr(), None if partials is None else partials.data_ptr(),
            None if dot is None else dot.data_ptr(), *geo, inv_w0,
            float(omega), ty, tz, stream_handle())
    check_launch(status, "prolong_add_smooth")
    const_prolong_add_smooth_embedded.launches += 1
    return (y, dot) if with_dot else y


const_prolong_add_smooth_embedded.launches = 0
