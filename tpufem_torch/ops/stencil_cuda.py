"""Stencil SpMV on the embedded layout: kernel K2 (csrc/stencil.cu).

Replaces tpufem/ops/stencil_pallas.py::_kernel and ::_kernel_matvec_dot.
``stencil_apply`` launches the CUDA kernel for a CUDA tensor (float32 or
float64) and runs the plain version (``sparse.stencil.stencil_matvec``)
for a CPU tensor.  What bounds the kernel and how its design answers that
is noted in the CUDA source.
"""
from __future__ import annotations

import ctypes

import torch

from tpufem_torch.ops._build import check_launch, load_library, stream_handle
from tpufem_torch.sparse.stencil import stencil_matvec

__all__ = ["stencil_apply", "stencil_apply_plain",
           "stencil_matvec_embedded", "stencil_matvec_dot_embedded"]

_P = ctypes.c_void_p
_SIGNATURES = {
    "tpufem_stencil_matvec_f32": (_P, _P, _P, _P, _P, ctypes.c_longlong, _P,
                                  ctypes.c_int, _P),
    "tpufem_stencil_matvec_f64": (_P, _P, _P, _P, _P, ctypes.c_longlong, _P,
                                  ctypes.c_int, _P),
    "tpufem_num_blocks": (ctypes.c_longlong,),
}
_ENTRY = {torch.float32: "tpufem_stencil_matvec_f32",
          torch.float64: "tpufem_stencil_matvec_f64"}


def _lib():
    return load_library("stencil.cu", _SIGNATURES)


def stencil_apply_plain(data, x, offsets, *, with_dot: bool = False):
    """Plain PyTorch version of K2 (any device)."""
    y = stencil_matvec(data, offsets, x)
    return (y, torch.dot(x, y)) if with_dot else y


def stencil_apply(data: torch.Tensor, x: torch.Tensor, offsets, *,
                  with_dot: bool = False):
    """y = A x for the flat-offset stencil ``data [K, N]``; with
    ``with_dot`` also <x, A x> as a 0-d tensor.  No host sync."""
    offsets = tuple(int(o) for o in offsets)
    if x.device.type == "cpu":
        return stencil_apply_plain(data, x, offsets, with_dot=with_dot)
    n = x.shape[0]
    if x.dtype not in _ENTRY:
        raise TypeError(f"stencil kernel takes float32/float64, got {x.dtype}")
    if (data.device != x.device or data.dtype != x.dtype
            or tuple(data.shape) != (len(offsets), n) or x.dim() != 1):
        raise ValueError(f"stencil kernel: data {tuple(data.shape)} "
                         f"{data.dtype} {data.device} vs x {tuple(x.shape)} "
                         f"{x.dtype} {x.device}, {len(offsets)} offsets")
    if not (data.is_contiguous() and x.is_contiguous()):
        raise ValueError("stencil kernel needs contiguous data and x")
    lib = _lib()
    with torch.cuda.device(x.device):
        y = torch.empty_like(x)
        dot = partials = None
        if with_dot:
            dot = torch.empty((), dtype=x.dtype, device=x.device)
            partials = torch.empty(lib.tpufem_num_blocks(n),
                                   dtype=torch.float64, device=x.device)
        offs = (ctypes.c_longlong * len(offsets))(*offsets)
        status = getattr(lib, _ENTRY[x.dtype])(
            data.data_ptr(), x.data_ptr(), y.data_ptr(),
            None if partials is None else partials.data_ptr(),
            None if dot is None else dot.data_ptr(),
            n, offs, len(offsets), stream_handle())
    check_launch(status, "stencil_matvec")
    stencil_apply.launches += 1
    return (y, dot) if with_dot else y


stencil_apply.launches = 0


def stencil_matvec_embedded(data, x, plan):
    """y = A x on the embedded storage layout; data [K, NS] or
    [K, *store_grid], x [NS]."""
    return stencil_apply(data.reshape(plan.width, -1), x, plan.offsets)


def stencil_matvec_dot_embedded(data, x, plan):
    """(A x, <x, A x>) in one pass — the PCG alpha-dot fused into the SpMV."""
    return stencil_apply(data.reshape(plan.width, -1), x, plan.offsets,
                         with_dot=True)
