"""Reductions, as in tpufem.ops.reduction: kernel B14 (csrc/reduction.cu)
and the library reductions beside it.

  * ``reduce_sum``      -- one ``torch.sum`` (the reference's ``jnp.sum``);
  * ``segment_reduce``  -- the deterministic many-bins sum that replaces
                           atomic scatter in assembly (sorted
                           ``index_put_``, never ``index_add_``'s atomics);
  * ``block_reduce``    -- the explicit two-stage block sum, kernel B14
                           (alias ``pallas_block_reduce``, the reference's
                           name); its launches count in
                           ``block_reduce.launches``, and
                           ``block_reduce_plain`` is its plain version,
                           which it equals bit for bit;
  * ``reduction_check`` -- the float64 host golden comparison.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from tpufem_torch.assemble.dense import accumulate
from tpufem_torch.ops._build import check_launch, load_library, stream_handle

__all__ = ["reduce_sum", "segment_reduce", "block_reduce",
           "block_reduce_plain", "pallas_block_reduce", "reduction_check"]

# the kernel's shape (csrc/reduction.cu): 256 threads of 16 values per
# slice, 1024 threads in the second pass
_THREADS, _ITEMS, _FINISH = 256, 16, 1024
_CHUNK = _THREADS * _ITEMS
_MAX_SLICES = 65535            # gridDim.y

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SUFFIX = {torch.float32: "_f32", torch.float64: "_f64"}
# x, n, block, nblk, slices, partials, out, stream
_SIGNATURES = {"tpufem_block_reduce" + sfx: (_P, _L, _L, _I, _I, _P, _P, _P)
               for sfx in _SUFFIX.values()}


def reduce_sum(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x)


def segment_reduce(values: torch.Tensor, segment_ids, num_segments: int,
                   indices_are_sorted: bool = False) -> torch.Tensor:
    """out[s] = sum of values[i] over segment_ids[i] == s; deterministic on
    every device (``indices_are_sorted`` is accepted for the reference's
    call shape)."""
    ids = torch.as_tensor(segment_ids, device=values.device).long()
    return accumulate(num_segments, ids, values)


def _lib():
    return load_library("reduction.cu", _SIGNATURES)


def _shape(n: int, block: int):
    """(blocks, slices per block) of an n-vector cut into ``block``s."""
    if block < 1:
        raise ValueError(f"block {block} must be positive")
    slices = -(-block // _CHUNK)
    if slices > _MAX_SLICES:
        raise ValueError(f"block {block} > {_MAX_SLICES * _CHUNK}")
    return max(1, -(-n // block)), slices


def _tree(v: torch.Tensor) -> torch.Tensor:
    """v [..., W] -> [...]: the kernel's shuffle tree within each warp of
    32, then the same tree over the W/32 warp sums (zero-padded to 32)."""
    w = v.shape[-1]
    v = v.reshape(*v.shape[:-1], w // 32, 32)
    for o in (16, 8, 4, 2, 1):
        v = v[..., :o] + v[..., o:2 * o]
    v = F.pad(v[..., 0], (0, 32 - w // 32))
    for o in (16, 8, 4, 2, 1):
        v = v[..., :o] + v[..., o:2 * o]
    return v[..., 0]


def _strided_sums(v: torch.Tensor) -> torch.Tensor:
    """v [rows, m, W] -> [rows, W]: each of W threads adds its m values in
    order, from zero."""
    acc = v.new_zeros((v.shape[0], v.shape[2]))
    for j in range(v.shape[1]):
        acc = acc + v[:, j]
    return acc


def block_reduce_plain(x: torch.Tensor, block: int = 128 * 1024
                       ) -> torch.Tensor:
    """Plain PyTorch version of B14: the same sums in the kernel's order."""
    flat = x.reshape(-1)
    nblk, slices = _shape(flat.numel(), block)
    v = F.pad(flat, (0, nblk * block - flat.numel())).reshape(nblk, block)
    v = F.pad(v, (0, slices * _CHUNK - block))
    partials = _tree(_strided_sums(v.reshape(nblk * slices, _ITEMS,
                                             _THREADS)))
    m = -(-partials.numel() // _FINISH)
    p = F.pad(partials, (0, m * _FINISH - partials.numel()))
    return _tree(_strided_sums(p.reshape(1, m, _FINISH)))[0]


def block_reduce(x: torch.Tensor, block: int = 128 * 1024) -> torch.Tensor:
    """Two-stage sum of x (flattened, zero-padded to a block multiple): a
    0-d tensor of x's type.  B14 on a CUDA tensor, the plain version on a
    CPU one."""
    if x.device.type == "cpu":
        return block_reduce_plain(x, block)
    if x.dtype not in _SUFFIX:
        raise ValueError(f"B14: {x.dtype}, expected float32/64")
    flat = x.reshape(-1)
    if not flat.is_contiguous():
        raise ValueError("B14: x must be contiguous")
    nblk, slices = _shape(flat.numel(), block)
    lib = _lib()
    with torch.cuda.device(x.device):
        partials = torch.empty(nblk * slices, dtype=x.dtype, device=x.device)
        out = torch.empty((), dtype=x.dtype, device=x.device)
        status = getattr(lib, "tpufem_block_reduce" + _SUFFIX[x.dtype])(
            flat.data_ptr(), flat.numel(), block, nblk, slices,
            partials.data_ptr(), out.data_ptr(), stream_handle())
    check_launch(status, "block_reduce")
    block_reduce.launches += 1
    return out


block_reduce.launches = 0
pallas_block_reduce = block_reduce


def reduction_check(x, device_result) -> dict:
    """Float64 host golden comparison of a device sum."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    cpu = float(np.sum(np.asarray(x, np.float64)))
    dev = float(device_result)
    diff = abs(cpu - dev)
    rel = diff / max(abs(cpu), 1e-300)
    return {"cpu": cpu, "device": dev, "abs_diff": diff, "rel_diff": rel,
            "match": rel < 1e-5}
