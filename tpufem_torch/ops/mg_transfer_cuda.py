"""Fused V-cycle transfers: kernels K3 and K4 (csrc/mg_transfer.cu).

K3 ``const_residual_restrict_embedded`` replaces
tpufem/ops/mg_transfer_pallas.py::_kern_rr:  rc = mask_c(R (r - A e)).
K4 ``const_prolong_add_smooth_embedded`` replaces ::_kern_pas:
e' = S_omega(r, e + P ec), optionally with <r, e'>.

R/P structure (solve/multigrid.py): P = W . inject2, R = sample2 . W with
W = I + 0.5 * (Kuhn adjacency stencil); A is the constant-coefficient
operator of the level (weights + row-type code plane).  Each wrapper
launches its kernel for a CUDA tensor and runs its plain version — the
unfused composition of ``solve.multigrid`` — for a CPU tensor.
"""
from __future__ import annotations

import ctypes

import torch

from tpufem_torch.ops._build import check_launch, load_library, stream_handle
from tpufem_torch.solve.multigrid import (const_matvec_plain, prolong,
                                          restrict)

__all__ = ["const_residual_restrict_embedded",
           "const_prolong_add_smooth_embedded",
           "const_residual_restrict_plain", "const_prolong_add_smooth_plain"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_RR_ARGS = (_P,) * 11 + (_I, _P)
_PAS_ARGS = (_P,) * 13 + (_I, _D, _D, _P)
_SIGNATURES = {
    "tpufem_residual_restrict_f32": _RR_ARGS,
    "tpufem_residual_restrict_f64": _RR_ARGS,
    "tpufem_prolong_add_smooth_f32": _PAS_ARGS,
    "tpufem_prolong_add_smooth_f64": _PAS_ARGS,
    "tpufem_num_blocks": (ctypes.c_longlong,),
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _lib():
    return load_library("mg_transfer.cu", _SIGNATURES)


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
    k0 = fine_plan.offsets.index(0)
    ep = e + fine_plan.embed_field(prolong(_node_grid(coarse_plan, ec), 3))
    inv_d = torch.where(code_f == 1.0,
                        torch.full_like(code_f, 1.0 / float(weights[k0])),
                        torch.ones_like(code_f))
    y = ep + omega * inv_d * (
        r - const_matvec_plain(weights, code_f, fine_plan.offsets, ep))
    return (y, torch.dot(r, y)) if with_dot else y


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
            (ctypes.c_longlong * k)(*fine_plan.offsets),
            (ctypes.c_int * (3 * k))(*steps),
            (ctypes.c_double * k)(*(float(w) for w in weights)), k)


def const_residual_restrict_embedded(weights, code_f, code_c, r, e,
                                     fine_plan, coarse_plan):
    """rc = mask_c(restrict(r - A_const e)) in one fused pass (3D)."""
    if r.device.type == "cpu":
        return const_residual_restrict_plain(weights, code_f, code_c, r, e,
                                             fine_plan, coarse_plan)
    nf, nc = fine_plan.num_store_rows, coarse_plan.num_store_rows
    _check([r, e, code_f, code_c], [nf, nf, nf, nc], "residual_restrict")
    geo = _geometry_args(weights, fine_plan, coarse_plan)
    lib = _lib()
    with torch.cuda.device(r.device):
        rc = torch.empty(nc, dtype=r.dtype, device=r.device)
        status = getattr(lib, "tpufem_residual_restrict_" + _SUFFIX[r.dtype])(
            code_f.data_ptr(), code_c.data_ptr(), r.data_ptr(), e.data_ptr(),
            rc.data_ptr(), *geo, stream_handle())
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
    lib = _lib()
    with torch.cuda.device(r.device):
        y = torch.empty_like(r)
        dot = partials = None
        if with_dot:
            dot = torch.empty((), dtype=r.dtype, device=r.device)
            partials = torch.empty(lib.tpufem_num_blocks(nf),
                                   dtype=torch.float64, device=r.device)
        status = getattr(lib,
                         "tpufem_prolong_add_smooth_" + _SUFFIX[r.dtype])(
            code_f.data_ptr(), ec.data_ptr(), r.data_ptr(), e.data_ptr(),
            y.data_ptr(), None if partials is None else partials.data_ptr(),
            None if dot is None else dot.data_ptr(), *geo, inv_w0,
            float(omega), stream_handle())
    check_launch(status, "prolong_add_smooth")
    const_prolong_add_smooth_embedded.launches += 1
    return (y, dot) if with_dot else y


const_prolong_add_smooth_embedded.launches = 0
