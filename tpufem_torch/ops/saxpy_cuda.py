"""SAXPY, out = a x + y: kernel B15 (csrc/saxpy.cu), the counterpart of
examples/saxpy_pallas.py (the runtime-compiled "author a kernel, launch
it" check).  ``saxpy`` counts its launches in ``saxpy.launches``;
``saxpy_plain`` is its plain version, which it equals bit for bit.  Any n
and any contiguous views are taken (the kernel moves 16-byte vectors past
a scalar head): the reference's reshape to (32, 8, n/256) is TPU tiling.
"""
from __future__ import annotations

import ctypes

import torch

from tpufem_torch.ops._build import check_launch, load_library, stream_handle

__all__ = ["saxpy", "saxpy_plain"]

_P = ctypes.c_void_p
_SUFFIX = {torch.float32: "_f32", torch.float64: "_f64"}
# a, x, y, out, n, stream
_SIGNATURES = {"tpufem_saxpy" + sfx: (_P, _P, _P, _P, ctypes.c_longlong, _P)
               for sfx in _SUFFIX.values()}


def _check(a: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> None:
    if a.numel() != 1 or x.shape != y.shape:
        raise ValueError(f"saxpy: a {tuple(a.shape)} (one element), x "
                         f"{tuple(x.shape)} and y {tuple(y.shape)} alike")
    if not (a.dtype == x.dtype == y.dtype) or not (
            a.device == x.device == y.device):
        raise ValueError("saxpy: a, x and y need one type and one device")


def _lib():
    return load_library("saxpy.cu", _SIGNATURES)


def saxpy_plain(a: torch.Tensor, x: torch.Tensor, y: torch.Tensor
                ) -> torch.Tensor:
    _check(a, x, y)
    return a.reshape(()) * x + y


def _empty_at_phase(x: torch.Tensor) -> torch.Tensor:
    """An uninitialised tensor like contiguous x whose data starts at x's
    offset within 16 bytes, so the kernel moves both as aligned vectors."""
    shift = x.data_ptr() % 16 // x.element_size()
    if not shift:
        return torch.empty_like(x)
    return torch.empty(x.numel() + shift, dtype=x.dtype,
                       device=x.device)[shift:].view(x.shape)


def saxpy(a: torch.Tensor, x: torch.Tensor, y: torch.Tensor
          ) -> torch.Tensor:
    """a (one element) * x + y: B15 on CUDA tensors, the plain version on
    CPU ones."""
    _check(a, x, y)
    if x.device.type == "cpu":
        return saxpy_plain(a, x, y)
    if x.dtype not in _SUFFIX or not (x.is_contiguous()
                                      and y.is_contiguous()):
        raise ValueError(f"B15: {x.dtype}, expected contiguous float32/64")
    lib = _lib()
    with torch.cuda.device(x.device):
        out = _empty_at_phase(x)
        status = getattr(lib, "tpufem_saxpy" + _SUFFIX[x.dtype])(
            a.data_ptr(), x.data_ptr(), y.data_ptr(), out.data_ptr(),
            x.numel(), stream_handle())
    check_launch(status, "saxpy")
    saxpy.launches += 1
    return out


saxpy.launches = 0
