"""Stencil kernels on the embedded layout: K2, B4 (csrc/stencil.cu), B5
(csrc/const_stencil.cu) and their blocked twins B3, B5b
(csrc/stencil_blocked.cu).

K2 ``stencil_apply`` replaces tpufem/ops/stencil_pallas.py::_kernel and
::_kernel_matvec_dot: y = A x (optionally <x, A x>).
B4 ``stencil_fused_apply`` replaces ::_kernel_residual, ::_kernel_smooth
and ::_kernel_smooth_dot: b - A x and the weighted-Jacobi sweep
x + omega D^-1 (r - A x) (optionally <r, y>) of the general-coefficient
operator, whose data may be bf16 under fp32 vectors.
B5 ``const_stencil_apply`` replaces ::_kernel_const_matvec,
::_kernel_const_residual, ::_kernel_const_smooth and
::_kernel_const_smooth_dot: the same epilogues on the uniform-grid operator
(K = 7 or 15 weights + row-type code plane).
B3 ``stencil_blocked_apply`` replaces ::_kernel2* (K2's and B4's
functions, tiled for large 3D grids) and B5b ``const_stencil_blocked_apply``
replaces ::_kernel2_const_*: B5's function, which it computes with B5's
kernel on the same store grid.  That kernel stages tiles of 128 store
columns through shared memory and marches over ranges of planes;
``const_tiling`` picks each launch's tile, and ``const_store_grid`` derives
the store grid from a level's flat offsets where a caller gives none.

Routing: given the store grid (the ``*_embedded`` functions pass their
plan's), ``stencil_apply``, ``stencil_fused_apply`` and
``const_stencil_apply`` hand a call to B3 / B5b exactly where the reference
routes a call to its blocked kernels (``_needs_2d``, a copy of the reference's
rule with the same threshold), and launch the flat kernel elsewhere.  On
the card that threshold is a routing rule carried over from the reference,
not a memory limit of the card.

Each wrapper launches its CUDA kernel for a CUDA tensor and runs its plain
PyTorch version (the ``*_plain`` functions here; the blocked kernels share
the flat ones') for a CPU tensor; each counts its launches.  What bounds
the kernels and how their design answers that is noted in the CUDA sources.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from tpufem_torch.ops._build import check_launch, load_library, stream_handle
from tpufem_torch.sparse.stencil import stencil_matvec

__all__ = ["stencil_apply", "stencil_apply_plain",
           "stencil_fused_apply", "stencil_fused_apply_plain",
           "const_stencil_apply", "const_stencil_apply_plain",
           "stencil_blocked_apply", "const_stencil_blocked_apply",
           "const_matvec_plain", "omega_inv_diag",
           "const_store_grid", "const_tiling", "const_smem",
           "CONST_TILE_ROWS",
           "stencil_matvec_embedded", "stencil_matvec_dot_embedded",
           "stencil_residual_embedded", "stencil_smooth_embedded",
           "stencil_smooth_dot_embedded",
           "const_matvec_embedded", "const_residual_embedded",
           "const_smooth_embedded", "const_smooth_dot_embedded"]

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_D = ctypes.c_double
_STENCIL_ARGS = (_I, _P, _P, _P, _P, _P, _P, _P, _LL, _P, _I, _D, _P)
_CONST_ARGS = (_I,) + (_P,) * 9 + (_I, _D, _D, _I, _I, _P)
_STENCIL_ENTRY = {(torch.float32, torch.float32): "tpufem_stencil_f32",
                  (torch.bfloat16, torch.float32): "tpufem_stencil_bf16_f32",
                  (torch.float64, torch.float64): "tpufem_stencil_f64"}
_CONST_ENTRY = {
    (torch.float32, torch.float32): "tpufem_const_stencil_f32",
    (torch.bfloat16, torch.float32): "tpufem_const_stencil_bf16_f32",
    (torch.float64, torch.float64): "tpufem_const_stencil_f64"}
_EPILOGUE = {"matvec": 0, "residual": 1, "smooth": 2}
_STENCIL_SIGNATURES = dict(
    {e: _STENCIL_ARGS for e in _STENCIL_ENTRY.values()},
    tpufem_num_blocks=(_LL,))
_CONST_SIGNATURES = dict({e: _CONST_ARGS for e in _CONST_ENTRY.values()},
                         tpufem_const_smem=(_I, _I, _I, _I))
_BLOCKED_ARGS = (_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _D, _P)
_BLOCKED_SIGNATURES = dict(
    {e.replace("stencil", "stencil_blocked"): _BLOCKED_ARGS
     for e in _STENCIL_ENTRY.values()},
    tpufem_blocked_num_blocks=(_I, _I, _I, _I))


def _stencil_lib():
    return load_library("stencil.cu", _STENCIL_SIGNATURES)


def _const_lib():
    return load_library("const_stencil.cu", _CONST_SIGNATURES)


def _blocked_lib():
    return load_library("stencil_blocked.cu", _BLOCKED_SIGNATURES)


# -- the route to the blocked kernels ------------------------------------------

# The reference's threshold (tpufem/ops/stencil_pallas.py::_VMEM_1D_LIMIT):
# there it is where the 1D layout's live set outgrows VMEM; here it only
# routes, so that the port runs the blocked kernels where the reference
# does.  A module constant: tests set it to 0 to route every 3D grid.
_VMEM_1D_LIMIT = 10 << 20


def _needs_2d(sg, width, n_extras, dtype_bytes):
    """The reference's rule: a 3D store grid ``sg`` goes to the blocked
    kernels when 2 (width + 4 + n_extras) S1 S2 dtype_bytes exceeds the
    threshold.  ``width``: K for the general kernels, 3 for the const ones;
    ``n_extras``: the epilogue's vectors besides x; ``dtype_bytes``: the
    vectors' item size."""
    if len(sg) < 3:
        return False
    rest = math.prod(int(v) for v in sg[1:])
    return 2 * (width + 4 + n_extras) * rest * dtype_bytes > _VMEM_1D_LIMIT


def _routed(store_grid, width, n_extras, x):
    return store_grid is not None and _needs_2d(
        tuple(store_grid), width, n_extras, x.element_size())


@functools.lru_cache(maxsize=None)
def _grid_steps(offsets: tuple, store_grid: tuple) -> tuple:
    """Each flat offset as its (dz, dy, dx) on the store grid, flattened;
    the blocked kernels take offsets in {-1, 0, 1}^3."""
    if len(store_grid) != 3:
        raise ValueError(f"the blocked kernels take 3D store grids, got "
                         f"{store_grid}")
    plane, row = store_grid[1] * store_grid[2], store_grid[2]
    steps = []
    for off in offsets:
        dz = round(off / plane)
        dy = round((off - dz * plane) / row)
        dx = off - dz * plane - dy * row
        if max(abs(dz), abs(dy), abs(dx)) > 1:
            raise ValueError(f"offset {off} leaves the 27-point neighbourhood "
                             f"on store grid {store_grid}")
        steps += [dz, dy, dx]
    return tuple(steps)


def _blocked_args(what, x, offsets, store_grid, with_dot):
    """(lib, store grid, steps array, dot, partials) of a blocked launch."""
    sg = tuple(int(v) for v in store_grid)
    if math.prod(sg) != x.shape[0]:
        raise ValueError(f"{what}: store grid {sg} has {math.prod(sg)} rows, "
                         f"x {x.shape[0]}")
    steps = _grid_steps(offsets, sg)
    lib = _blocked_lib()
    nblocks = lib.tpufem_blocked_num_blocks(*sg, x.element_size())
    if nblocks == 0:
        raise ValueError(f"{what}: store grid {sg} does not tile (axes must "
                         "be multiples of 8, 8 and 128)")
    dot, partials = _dot_buffers(x, with_dot, nblocks)
    return lib, sg, (ctypes.c_int * len(steps))(*steps), dot, partials


def _epilogue(name, allowed):
    if name not in allowed:
        raise ValueError(f"epilogue {name!r}: one of {allowed}")
    return _EPILOGUE[name]


def _check_vectors(what, x, vectors):
    """x and the epilogue's other vectors: contiguous 1-D of one type on
    one device."""
    for v in (x, *vectors):
        if (v.dim() != 1 or v.shape != x.shape or v.dtype != x.dtype
                or v.device != x.device or not v.is_contiguous()):
            raise ValueError(f"{what}: expected contiguous {x.dtype} "
                             f"[{x.shape[0]}] on {x.device}, got "
                             f"{tuple(v.shape)} {v.dtype} {v.device}")


def _dot_buffers(x, with_dot, nblocks):
    """(dot, fp64 partials of ``nblocks`` slots) of a launch with a dot,
    else (None, None)."""
    if not with_dot:
        return None, None
    return (torch.empty((), dtype=x.dtype, device=x.device),
            torch.empty(nblocks, dtype=torch.float64, device=x.device))


def _ptr(t):
    return None if t is None else t.data_ptr()


# -- general-coefficient stencil: K2 (matvec) and B4 (residual, sweep) -------

@functools.lru_cache(maxsize=None)
def _rounded(omega: float, dtype: torch.dtype) -> float:
    """omega rounded to ``dtype`` (a Python float; exact for fp32/fp64)."""
    return torch.tensor(omega, dtype=dtype).item()


def omega_inv_diag(omega, inv_diag):
    """omega * inv_diag rounded to inv_diag's type: the reference's weakly
    typed scalar meets a bf16 plane in bf16, and the product widens only
    when it meets the fp32 residual.  (The product of two bf16 values is
    exact in torch's fp32 arithmetic, so rounding omega first and then the
    product equals the bf16 product.)"""
    return inv_diag * _rounded(float(omega), inv_diag.dtype)


def stencil_apply_plain(data, x, offsets, *, with_dot: bool = False):
    """Plain PyTorch version of K2 (any device)."""
    y = stencil_matvec(data, offsets, x)
    return (y, torch.dot(x, y)) if with_dot else y


def stencil_fused_apply_plain(epilogue: str, data, x, offsets, *, b,
                              inv_diag=None, omega: float = 0.8,
                              with_dot: bool = False):
    """Plain PyTorch version of B4 (any device): ``"residual"`` b - A x,
    ``"smooth"`` x + (omega inv_diag) (b - A x), with ``with_dot`` also
    <b, y>."""
    _epilogue(epilogue, ("residual", "smooth"))
    resid = b - stencil_matvec(data, offsets, x)
    if epilogue == "residual":
        return resid
    y = x + omega_inv_diag(omega, inv_diag) * resid
    return (y, torch.dot(b, y)) if with_dot else y


def _check_general(what, data, x, offsets, b, inv_diag):
    """The (data, vector) types' entry suffix, after checking every
    operand of a general-coefficient launch."""
    entry = _STENCIL_ENTRY.get((data.dtype, x.dtype))
    if entry is None:
        raise TypeError(f"{what}: takes (data, vector) types "
                        f"{sorted(_STENCIL_ENTRY, key=str)}, got "
                        f"({data.dtype}, {x.dtype})")
    n = x.shape[0]
    _check_vectors(what, x, [] if b is None else [b])
    for t, shape in ((data, (len(offsets), n)), (inv_diag, (n,))):
        if t is not None and (t.device != x.device or t.dtype != data.dtype
                              or tuple(t.shape) != shape
                              or not t.is_contiguous()):
            raise ValueError(f"{what}: expected contiguous {data.dtype} "
                             f"{shape} on {x.device}, got {tuple(t.shape)} "
                             f"{t.dtype} {t.device}")
    return entry


def _launch_stencil(counter, epilogue, data, x, offsets, b, inv_diag, omega,
                    with_dot, what):
    entry = _check_general(what, data, x, offsets, b, inv_diag)
    n = x.shape[0]
    lib = _stencil_lib()
    with torch.cuda.device(x.device):
        y = torch.empty_like(x)
        dot, partials = _dot_buffers(x, with_dot, lib.tpufem_num_blocks(n))
        offs = (ctypes.c_longlong * len(offsets))(*offsets)
        status = getattr(lib, entry)(
            epilogue, data.data_ptr(), x.data_ptr(), _ptr(b), _ptr(inv_diag),
            y.data_ptr(), _ptr(partials), _ptr(dot), n, offs, len(offsets),
            float(omega), stream_handle())
    check_launch(status, what)
    counter.launches += 1
    return (y, dot) if with_dot else y


def stencil_apply(data: torch.Tensor, x: torch.Tensor, offsets, *,
                  with_dot: bool = False, store_grid=None):
    """K2: y = A x for the flat-offset stencil ``data [K, N]``; with
    ``with_dot`` also <x, A x> as a 0-d tensor.  No host sync.

    ``store_grid``: the grid the offsets refer to; where the reference
    would run its blocked kernel on it, the call goes to B3
    (``stencil_blocked_apply``) instead."""
    offsets = tuple(int(o) for o in offsets)
    if _routed(store_grid, len(offsets), 0, x):
        return stencil_blocked_apply("matvec", data, x, offsets, store_grid,
                                     with_dot=with_dot)
    if x.device.type == "cpu":
        return stencil_apply_plain(data, x, offsets, with_dot=with_dot)
    return _launch_stencil(stencil_apply, _EPILOGUE["matvec"], data, x,
                           offsets, None, None, 0.0, with_dot,
                           "stencil_matvec")


stencil_apply.launches = 0


def _check_fused(epilogue, inv_diag, with_dot):
    code = _epilogue(epilogue, ("residual", "smooth"))
    if (epilogue == "smooth") != (inv_diag is not None) or (
            with_dot and epilogue != "smooth"):
        raise ValueError("the sweep (and only it) takes inv_diag and a dot")
    return code


def stencil_fused_apply(epilogue: str, data: torch.Tensor, x: torch.Tensor,
                        offsets, *, b: torch.Tensor, inv_diag=None,
                        omega: float = 0.8, with_dot: bool = False,
                        store_grid=None):
    """B4: ``"residual"`` y = b - A x, or ``"smooth"`` the weighted-Jacobi
    sweep y = x + omega inv_diag (b - A x), with ``with_dot`` also <b, y>.

    ``data`` and ``inv_diag`` may be bf16 under fp32 vectors (they widen on
    load).  ``store_grid`` routes as in ``stencil_apply`` (to B3).  No host
    sync."""
    offsets = tuple(int(o) for o in offsets)
    code = _check_fused(epilogue, inv_diag, with_dot)
    kw = dict(b=b, inv_diag=inv_diag, omega=omega, with_dot=with_dot)
    if _routed(store_grid, len(offsets), 1 + (epilogue == "smooth"), x):
        return stencil_blocked_apply(epilogue, data, x, offsets, store_grid,
                                     **kw)
    if x.device.type == "cpu":
        return stencil_fused_apply_plain(epilogue, data, x, offsets, **kw)
    return _launch_stencil(stencil_fused_apply, code, data, x, offsets, b,
                           inv_diag, omega, with_dot, "stencil_" + epilogue)


stencil_fused_apply.launches = 0


def stencil_blocked_apply(epilogue: str, data: torch.Tensor,
                          x: torch.Tensor, offsets, store_grid, *, b=None,
                          inv_diag=None, omega: float = 0.8,
                          with_dot: bool = False):
    """B3: K2's matvec (``"matvec"``, with ``with_dot`` also <x, y>) and
    B4's residual and sweep, tiled over the 3D ``store_grid`` (the 15
    Kuhn offsets); the same function and types as the flat kernels.  No
    host sync."""
    offsets = tuple(int(o) for o in offsets)
    if epilogue == "matvec":
        if b is not None or inv_diag is not None:
            raise ValueError("matvec takes no b and no inv_diag")
        code = _EPILOGUE["matvec"]
    else:
        code = _check_fused(epilogue, inv_diag, with_dot)
    if x.device.type == "cpu":
        if epilogue == "matvec":
            return stencil_apply_plain(data, x, offsets, with_dot=with_dot)
        return stencil_fused_apply_plain(epilogue, data, x, offsets, b=b,
                                         inv_diag=inv_diag, omega=omega,
                                         with_dot=with_dot)
    what = "stencil_blocked_" + epilogue
    entry = _check_general(what, data, x, offsets, b, inv_diag)
    with torch.cuda.device(x.device):
        lib, sg, steps, dot, partials = _blocked_args(what, x, offsets,
                                                      store_grid, with_dot)
        y = torch.empty_like(x)
        status = getattr(lib, entry.replace("stencil", "stencil_blocked"))(
            code, data.data_ptr(), x.data_ptr(), _ptr(b), _ptr(inv_diag),
            y.data_ptr(), _ptr(partials), _ptr(dot), *sg, steps,
            len(offsets), float(omega), stream_handle())
    check_launch(status, what)
    stencil_blocked_apply.launches += 1
    return (y, dot) if with_dot else y


stencil_blocked_apply.launches = 0


def _flat(data, plan):
    return data.reshape(plan.width, -1)


def stencil_matvec_embedded(data, x, plan):
    """y = A x on the embedded storage layout; data [K, NS] or
    [K, *store_grid], x [NS]."""
    return stencil_apply(_flat(data, plan), x, plan.offsets,
                         store_grid=plan.store_grid)


def stencil_matvec_dot_embedded(data, x, plan):
    """(A x, <x, A x>) in one pass — the PCG alpha-dot fused into the SpMV."""
    return stencil_apply(_flat(data, plan), x, plan.offsets, with_dot=True,
                         store_grid=plan.store_grid)


def stencil_residual_embedded(data, b, x, plan):
    """r = b - A x, fused in one pass."""
    return stencil_fused_apply("residual", _flat(data, plan), x, plan.offsets,
                               b=b, store_grid=plan.store_grid)


def stencil_smooth_embedded(data, r, x, inv_diag, plan, *,
                            omega: float = 0.8):
    """x + omega * inv_diag * (r - A x): one fused weighted-Jacobi sweep."""
    return stencil_fused_apply("smooth", _flat(data, plan), x, plan.offsets,
                               b=r, inv_diag=inv_diag, omega=omega,
                               store_grid=plan.store_grid)


def stencil_smooth_dot_embedded(data, r, x, inv_diag, plan, *,
                                omega: float = 0.8):
    """(y, <r, y>) with y the fused Jacobi sweep — the PCG rz-dot fused into
    the V-cycle's final fine-level smooth."""
    return stencil_fused_apply("smooth", _flat(data, plan), x, plan.offsets,
                               b=r, inv_diag=inv_diag, omega=omega,
                               with_dot=True, store_grid=plan.store_grid)


# -- constant-coefficient (uniform-grid) stencil: B5 and B5b ----------------

def const_matvec_plain(weights, code: torch.Tensor, offsets,
                       x: torch.Tensor) -> torch.Tensor:
    """A_const x: interior rows apply the K weights to the interior-masked
    neighbours, Dirichlet rows are the identity, padding rows are zero."""
    interior = code == 1.0
    xm = torch.where(interior, x, 0.0)
    n = x.shape[0]
    halo = int(max(abs(int(o)) for o in offsets))
    xp = torch.nn.functional.pad(xm, (halo, halo))
    y = torch.zeros_like(x)
    for k, off in enumerate(offsets):
        y = y + float(weights[k]) * xp[halo + int(off): halo + int(off) + n]
    return torch.where(interior, y, 0.0) + torch.where(code == 2.0, x, 0.0)


def _inv_w0(weights, offsets):
    return 1.0 / float(weights[tuple(offsets).index(0)])


def const_stencil_apply_plain(epilogue: str, weights, code, x, offsets, *,
                              b=None, omega: float = 0.8,
                              with_dot: bool = False):
    """Plain PyTorch version of B5 (any device): ``"matvec"`` A x,
    ``"residual"`` b - A x, ``"smooth"`` x + omega invd (b - A x) with
    invd = 1/w0 on interior rows and 1 elsewhere (and ``with_dot`` <b, y>).
    Every product runs in x's type, whatever the code plane's."""
    _epilogue(epilogue, tuple(_EPILOGUE))
    ax = const_matvec_plain(weights, code, offsets, x)
    if epilogue == "matvec":
        return ax
    if epilogue == "residual":
        return b - ax
    inv_d = torch.where(code == 1.0,
                        torch.full_like(x, _inv_w0(weights, offsets)),
                        torch.ones_like(x))
    y = x + omega * inv_d * (b - ax)
    return (y, torch.dot(b, y)) if with_dot else y


def _check_const(epilogue, b, with_dot):
    _epilogue(epilogue, tuple(_EPILOGUE))
    if (epilogue == "matvec") != (b is None) or (
            with_dot and epilogue != "smooth"):
        raise ValueError("matvec takes no b; only the sweep takes a dot")


def _const_operands(what, weights, code, x, offsets, b):
    """The (code, vector) types' entry name, after checking every operand
    of a const launch."""
    entry = _CONST_ENTRY.get((code.dtype, x.dtype))
    if entry is None:
        raise TypeError(f"{what}: takes (code, vector) types "
                        f"{sorted(_CONST_ENTRY, key=str)}, got "
                        f"({code.dtype}, {x.dtype})")
    if len(weights) != len(offsets):
        raise ValueError(f"{what}: {len(weights)} weights for "
                         f"{len(offsets)} offsets")
    _check_vectors(what, x, [] if b is None else [b])
    if (code.shape != x.shape or code.device != x.device
            or not code.is_contiguous()):
        raise ValueError(f"{what}: code {tuple(code.shape)} {code.device} "
                         f"vs x {tuple(x.shape)} {x.device}")
    return entry


# The const stencils' grid steps in the plans' offset order (flat offsets
# ascending): the 3D Kuhn split (K = 15) and the 2D split (K = 7), as
# csrc/common.cuh's tap_step, whose launchers refuse any other stencil.
_CONST_STEPS = {
    15: ((-1, -1, -1), (-1, -1, 0), (-1, 0, -1), (-1, 0, 0), (0, -1, -1),
         (0, -1, 0), (0, 0, -1), (0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
         (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1)),
    7: ((-1, 0), (-1, 1), (0, -1), (0, 0), (0, 1), (1, -1), (1, 0))}
_TILE_X = 128           # store columns of a tile
_SMS = 132              # streaming multiprocessors of the H100 SXM
_SMEM_PER_SM = 233472   # an SM's shared memory, 1 KB of it reserved a block
_MAX_PLANES = 32
# the tile rows the launcher has a kernel for (csrc/const_stencil.cu's
# TPUFEM_CONST_ROWS) and the rows picked per item size (the sweep of
# scripts/kernel_ab.py --tiles)
CONST_TILE_ROWS = (4, 6, 8)
_CONST_ROWS = {4: 8, 8: 6}

# the output allocation of B5 and B5b (a test fills it with NaN first: the
# kernel must write every row)
_new_output = torch.empty


@functools.lru_cache(maxsize=None)
def _derived_grid(offsets: tuple, n: int) -> tuple:
    steps = _CONST_STEPS.get(len(offsets))
    if steps is None:
        raise ValueError(f"{len(offsets)} offsets: the const stencils have "
                         "15 (3D) or 7 (2D)")
    sg = None
    if len(offsets) == 15:
        row, plane = offsets[9], offsets[11]
        if row > 0 and plane > 0 and plane % row == 0 and n % plane == 0:
            sg = (n // plane, plane // row, row)
    elif offsets[6] > 0 and n % offsets[6] == 0:
        sg = (n // offsets[6], offsets[6])
    if sg is not None:
        strides = (sg[1] * sg[2], sg[2], 1) if len(sg) == 3 else (sg[1], 1)
        flat = tuple(sum(d * t for d, t in zip(step, strides))
                     for step in steps)
    if sg is None or flat != offsets:
        raise ValueError(f"offsets {offsets} are not the {len(offsets)}-"
                         f"point const stencil on any store grid of {n} "
                         "rows")
    return sg


def const_store_grid(offsets, n: int, store_grid=None) -> tuple:
    """The store grid that a const level's flat ``offsets`` over ``n`` rows
    refer to: the Kuhn split's 15 give S2 (step (0, 1, 0)) and S1 S2 (step
    (1, 0, 0)), the 2D split's 7 give S1 (step (1, 0)), and n the rest.
    Raises if the offsets are not the stencil's on that grid, or if a given
    ``store_grid`` is another."""
    sg = _derived_grid(tuple(int(o) for o in offsets), int(n))
    if store_grid is not None and tuple(int(v) for v in store_grid) != sg:
        raise ValueError(f"store grid {tuple(store_grid)} is not the "
                         f"offsets' {sg}")
    return sg


def _kernel_grid(store_grid):
    """The kernel's view of a store grid: a 3D one as it is, a 2D one
    (S0, S1) as (1, S0, S1)."""
    sg = tuple(int(v) for v in store_grid)
    return sg if len(sg) == 3 else (1, *sg)


def _const_grid(k, store_grid, ty, tz):
    """The launch grid of tile (ty, tz): (columns, rows, planes) of tiles
    in 3D, (columns, 1, bands of ty rows) in 2D."""
    s0, s1, s2 = _kernel_grid(store_grid)
    if k == 15:
        return s2 // _TILE_X, -(-s1 // ty), -(-s0 // tz)
    bands = -(-s1 // ty)
    return s2 // _TILE_X, 1, -(-bands // tz)


def const_smem(k: int, itemsize: int, ty: int, code_itemsize=None) -> int:
    """Dynamic shared memory (bytes) of a B5 block with ``ty`` tile rows
    (csrc/const_stencil.cu's const_smem): x and code, four planes (3D;
    three bands in 2D) each of ty + 2 rows by 128 columns and a 16-byte
    chunk either side, the code in its own type, four such planes of the
    masked x (two in 2D), and two ty x 128 tiles of b."""
    ci = itemsize if code_itemsize is None else code_itemsize
    nr, nm = (4, 4) if k == 15 else (3, 2)
    ry = ty + 2
    return (((nr + nm) * ry * (_TILE_X + 32 // itemsize)
             + 2 * ty * _TILE_X) * itemsize
            + nr * ry * (_TILE_X + 32 // ci) * ci)


def const_blocks_per_sm(k: int, itemsize: int, ty: int,
                        code_itemsize=None) -> int:
    """Blocks of a tile an SM holds at most, by shared memory and threads
    (256 a block)."""
    smem = const_smem(k, itemsize, ty, code_itemsize)
    return min(2048 // 256, _SMEM_PER_SM // (smem + 1024))


@functools.lru_cache(maxsize=None)
def const_tiling(k: int, itemsize: int, store_grid: tuple,
                 code_itemsize=None):
    """(ty, tz, shared memory bytes, grid) of one B5 / B5b launch.

    A block owns 128 store columns and ``ty`` rows of each plane it
    marches over: in 3D ``tz`` planes of the store grid, in 2D ``tz``
    bands of ``ty`` rows (every tap of the 2D stencil lies in its band
    and the halo row either side).  ``ty`` is fixed per item size; ``tz``
    is the fewest planes (bands) up to 32 whose blocks fit in one wave,
    the blocks the card holds at once (132 SMs x
    ``const_blocks_per_sm``), and 32 where none does.  (In the tile sweep
    a second, part-filled wave cost more than the halo planes of the
    longer march.)  The grid is (columns, rows, planes) of tiles in 3D,
    (columns, 1, bands) in 2D."""
    if _kernel_grid(store_grid)[2] % _TILE_X:
        raise ValueError(f"store grid {tuple(store_grid)}: rows of "
                         f"{_TILE_X} columns")
    ty = _CONST_ROWS[itemsize]
    cap = _SMS * const_blocks_per_sm(k, itemsize, ty, code_itemsize)
    tz = next((t for t in range(1, _MAX_PLANES + 1)
               if math.prod(_const_grid(k, store_grid, ty, t)) <= cap),
              _MAX_PLANES)
    return (ty, tz, const_smem(k, itemsize, ty, code_itemsize),
            _const_grid(k, store_grid, ty, tz))


def _launch_const(counter, what, epilogue, weights, code, x, offsets, b,
                  omega, with_dot, store_grid):
    """Launch the staged const kernel (B5's, also B5b's) and count it on
    ``counter``."""
    entry = _const_operands(what, weights, code, x, offsets, b)
    k, n = len(offsets), x.shape[0]
    sg = const_store_grid(offsets, n, store_grid)
    ty, tz, _, grid = const_tiling(k, x.element_size(), sg,
                                   code.element_size())
    steps = [v for step in _CONST_STEPS[k]
             for v in (step if k == 15 else (0, *step))]
    lib = _const_lib()
    with torch.cuda.device(x.device):
        y = _new_output(n, dtype=x.dtype, device=x.device)
        dot, partials = _dot_buffers(x, with_dot, math.prod(grid))
        status = getattr(lib, entry)(
            _EPILOGUE[epilogue], code.data_ptr(), x.data_ptr(), _ptr(b),
            y.data_ptr(), _ptr(partials), _ptr(dot),
            (ctypes.c_int * 3)(*_kernel_grid(sg)),
            (ctypes.c_int * (3 * k))(*steps),
            (ctypes.c_double * k)(*(float(w) for w in weights)), k,
            _inv_w0(weights, offsets), float(omega), ty, tz,
            stream_handle())
    check_launch(status, what)
    counter.launches += 1
    return (y, dot) if with_dot else y


def const_stencil_apply(epilogue: str, weights, code: torch.Tensor,
                        x: torch.Tensor, offsets, *, b=None,
                        omega: float = 0.8, with_dot: bool = False,
                        store_grid=None):
    """B5: ``"matvec"`` y = A x, ``"residual"`` y = b - A x or ``"smooth"``
    y = x + omega invd (b - A x) of the uniform-grid operator (``weights``
    K floats, K = 7 or 15, ``code`` the row-type plane, which may be bf16);
    with ``with_dot`` (sweep only) also <b, y>.  ``store_grid`` routes as
    in ``stencil_apply`` (to B5b); without one the kernel derives it from
    the offsets (``const_store_grid``).  No host sync."""
    offsets = tuple(int(o) for o in offsets)
    _check_const(epilogue, b, with_dot)
    kw = dict(b=b, omega=omega, with_dot=with_dot)
    if _routed(store_grid, 3, int(b is not None), x):
        return const_stencil_blocked_apply(epilogue, weights, code, x,
                                           offsets, store_grid, **kw)
    if x.device.type == "cpu":
        return const_stencil_apply_plain(epilogue, weights, code, x, offsets,
                                         **kw)
    return _launch_const(const_stencil_apply, "const_" + epilogue, epilogue,
                         weights, code, x, offsets, b, omega, with_dot,
                         store_grid)


const_stencil_apply.launches = 0


def const_stencil_blocked_apply(epilogue: str, weights, code: torch.Tensor,
                                x: torch.Tensor, offsets, store_grid, *,
                                b=None, omega: float = 0.8,
                                with_dot: bool = False):
    """B5b: B5's four epilogues on the 3D ``store_grid`` (15 offsets), the
    route the reference takes past its ``_needs_2d`` rule; the same
    function and types as B5, computed by B5's kernel.  No host sync."""
    offsets = tuple(int(o) for o in offsets)
    _check_const(epilogue, b, with_dot)
    if x.device.type == "cpu":
        return const_stencil_apply_plain(epilogue, weights, code, x, offsets,
                                         b=b, omega=omega, with_dot=with_dot)
    if len(store_grid) != 3:
        raise ValueError(f"the blocked route takes 3D store grids, got "
                         f"{tuple(store_grid)}")
    return _launch_const(const_stencil_blocked_apply,
                         "const_blocked_" + epilogue, epilogue, weights,
                         code, x, offsets, b, omega, with_dot, store_grid)


const_stencil_blocked_apply.launches = 0


def const_matvec_embedded(weights, code, x, plan):
    """y = A x for the uniform-grid operator: ``weights`` K floats (one per
    plan offset), ``code`` the row-type plane."""
    return const_stencil_apply("matvec", weights, code, x, plan.offsets,
                               store_grid=plan.store_grid)


def const_residual_embedded(weights, code, b, x, plan):
    return const_stencil_apply("residual", weights, code, x, plan.offsets,
                               b=b, store_grid=plan.store_grid)


def const_smooth_embedded(weights, code, r, x, plan, *, omega: float = 0.8):
    return const_stencil_apply("smooth", weights, code, x, plan.offsets, b=r,
                               omega=omega, store_grid=plan.store_grid)


def const_smooth_dot_embedded(weights, code, r, x, plan, *,
                              omega: float = 0.8):
    return const_stencil_apply("smooth", weights, code, x, plan.offsets, b=r,
                               omega=omega, with_dot=True,
                               store_grid=plan.store_grid)
