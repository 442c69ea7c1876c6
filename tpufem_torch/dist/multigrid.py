"""Distributed geometric multigrid: z-plane-sharded V-cycle on the device
mesh, as in tpufem.dist.multigrid.

The whole MG-PCG solve (smoothing, residuals, restriction, prolongation
and the CG reductions) runs on the shards, with

  * vectors and stencil data sharded by z-plane stripes of the node grid
    (2D: y-row stripes), whose halos are single planes;
  * one plane exchange with the ring neighbours per stencil application
    (matvec, Jacobi sweep, residual, the transfer stencil W);
  * grid transfers in place on the shards: even-plane z-sampling is local
    because every distributed level keeps an even number of local planes;
    y/x sampling and injection are stride-2 slices (the reference's 0/1
    selection matmuls stood in for them on the TPU);
  * coarse levels below ``min_local_planes`` gathered to one replicated
    grid (one ``all_gather`` of the restricted residual) and solved with
    the same operations minus the exchanges, down to the dense inverse of
    the coarsest level; each shard then takes its planes of the
    correction;
  * CG dot products: local dot + ``psum`` in shard order.

Levels use plain node grids (z-padded to shards x local planes); the z-pad
planes are identity rows, like the Dirichlet rows, so they stay decoupled.
Operators are assembled analytically per level (uniform boxes), so a
hierarchy never materialises element arrays.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from tpufem_torch.assemble.structured import structured_plan
from tpufem_torch.dist.cg import sharded_pcg_loop
from tpufem_torch.dist.mesh import (Mesh, P, Sharded, all_gather, axis_index,
                                    axis_size, ring_halos, shard, smap,
                                    unshard)
from tpufem_torch.solve.cg import CGResult, cg
from tpufem_torch.solve.multigrid import (_light_grid, _stencil_offsets,
                                          _uniform_cell_stiffness,
                                          _uniform_stencil_data)

__all__ = ["DistMGLevel", "build_dist_hierarchy", "shard_specs",
           "put_hierarchy", "grid_stencil_matvec", "mgpcg_dist",
           "solve_poisson_dist"]


def _each(fn, x):
    """``fn`` on every shard of a Sharded value, or on a replicated one."""
    return smap(fn, x) if isinstance(x, Sharded) else fn(x)


def _local_shape(x) -> tuple:
    return x.local_shape if isinstance(x, Sharded) else tuple(x.shape)


# -- sharded grid primitives -------------------------------------------------

def _z_halo(x, axis_name: Optional[str]):
    """(left, right) single-plane halos of a [Z, ...] local block.

    axis_name=None (replicated level): zeros — the grid is whole.
    Global-boundary shards also receive zeros (grid edge)."""
    if axis_name is None:
        zero = torch.zeros_like(x[:1])
        return zero, zero
    return ring_halos(x[:1], x[-1:], axis_name)


def _stencil_local(x, left, right, weights, offsets_grid):
    dim = x.dim()
    xp = torch.cat([left, x, right], dim=0)
    xp = torch.nn.functional.pad(xp, (1, 1) * (dim - 1))
    y = None
    for w, off in zip(weights, offsets_grid):
        if w is None:
            continue
        sl = tuple(slice(1 + off[d], 1 + off[d] + x.shape[d])
                   for d in range(dim))
        y = w * xp[sl] if y is None else y + w * xp[sl]
    return y


def _apply_grid_stencil(weights_of, x, offsets_grid, axis_name):
    """y = sum_k w_k * shift(x, offset_k) with plane halo exchange.

    weights_of(k) -> scalar, [Z, ...] array or None (skip); offsets are
    (dz, dy, dx) (3D) or (dy, dx) (2D) grid tuples with |d| <= 1."""
    left, right = _z_halo(x, axis_name)
    ws = [weights_of(k) for k in range(len(offsets_grid))]
    fn = lambda xl, lo, hi, *w: _stencil_local(xl, lo, hi, w, offsets_grid)
    if isinstance(x, Sharded):
        return smap(fn, x, left, right, *ws)
    return fn(x, left, right, *ws)


def grid_stencil_matvec(data, x, offsets_grid, axis_name):
    """Sharded y = A x. data [K, Z, ...] local, x [Z, ...] local (or the
    whole grids, with axis_name None)."""
    return _apply_grid_stencil(lambda k: data[k], x, offsets_grid, axis_name)


def _transfer_w(x, axis_name):
    """W = I + 0.5 * adjacency stencil (P1 transfer weights), sharded."""
    dim = len(_local_shape(x))
    offs = [(0,) * dim] + list(_stencil_offsets(dim))
    return _apply_grid_stencil(lambda k: 1.0 if k == 0 else 0.5,
                               x, offs, axis_name)


def _sample_minor(x):
    """Even-position sampling along every non-leading axis (y, x)."""
    return x[(slice(None),) + (slice(None, None, 2),) * (x.dim() - 1)]


def _inject_minor(x, fine_sizes):
    """Zero-injection (adjoint of _sample_minor) along non-leading axes."""
    out = x.new_zeros((x.shape[0],) + tuple(fine_sizes))
    out[(slice(None),) + (slice(None, None, 2),) * (x.dim() - 1)] = x
    return out


def _sample_z_local(x):
    """Even-plane decimation of the local z-block (local planes are even and
    shard offsets are even multiples, so global parity == local parity)."""
    return x[0::2]


def _inject_z_local(x, out_planes: int):
    """Zero-interleave along z: coarse local [mc, ...] -> fine [2*mc, ...]."""
    out = x.new_zeros((2 * x.shape[0],) + tuple(x.shape[1:]))
    out[0::2] = x
    return out[:out_planes]


# -- hierarchy ---------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DistMGLevel:
    """One level; arrays are GLOBAL numpy (shard with ``put_hierarchy``).

    data [K, Zp, ...]: stencil values on the z-padded plain node grid,
    Dirichlet + z-pad rows eliminated to identity.
    """
    data: np.ndarray
    inv_diag: np.ndarray
    bc_mask: np.ndarray            # True on Dirichlet AND z-pad rows
    offsets_grid: tuple
    node_grid: tuple               # valid (nz, ny, nx)
    local_planes: int              # Zp // n_shards (distributed levels)
    distributed: bool
    coarse_inverse: Optional[np.ndarray] = None   # replicated coarsest


def _np_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def _analytic_level(domain, s: int, dim: int, dtype):
    """(data [K, *ng], mask [*ng], offsets_grid) plain-grid, BC-eliminated."""
    info, _, bc_grid = _light_grid(domain, s, dim, with_coords=False)
    plan = structured_plan(info, embed=False)
    Ke = _uniform_cell_stiffness(domain, s, dim)
    raw = _uniform_stencil_data(plan, Ke, _np_dtype(dtype).type)
    ng = tuple(info.node_grid)
    data = raw.reshape((plan.width,) + ng)
    mask = bc_grid
    # grid-aware symmetric elimination: zero bc rows/cols, identity diag
    keep = ~mask
    mp = np.pad(mask, [(1, 1)] * dim)
    for k, off in enumerate(plan.offsets_grid):
        sl = tuple(slice(1 + off[d], 1 + off[d] + ng[d]) for d in range(dim))
        col_bc = mp[sl]
        data[k] = np.where(keep & ~col_bc, data[k], 0)
        if all(o == 0 for o in off):
            data[k] = np.where(mask, 1.0, data[k])
    return data, mask, plan.offsets_grid


def build_dist_hierarchy(domain, n_cells: int, dim: int, n_shards: int, *,
                         dtype=np.float32, coarse_max: int = 8,
                         min_local_planes: int = 4) -> List[DistMGLevel]:
    """Analytic z-sharded hierarchy on (domain)^dim with n_cells^dim cells.

    Distributed levels keep an EVEN number of local planes (>= 2) so that
    even-plane sampling stays local; once a level would drop below
    ``min_local_planes`` it becomes replicated (gathered V-cycle tail).
    """
    sizes = [n_cells]
    while sizes[-1] % 2 == 0 and sizes[-1] > coarse_max:
        sizes.append(sizes[-1] // 2)

    # Distributed levels 0..n_dist-1 get local_planes = m0 / 2^i; keeping
    # every distributed level's plane count even makes z-sampling local.
    # The last level is always replicated (it may carry the dense inverse).
    base = -(-(sizes[0] + 2) // n_shards)      # >= nz planes incl. boundary
    n_dist, m0 = 0, base
    for nd in range(1, len(sizes)):
        q = 1 << nd
        m = -(-base // q) * q                  # round up to multiple of 2^nd
        if m >> (nd - 1) >= max(2, min_local_planes):
            n_dist, m0 = nd, m
        else:
            break

    out: List[DistMGLevel] = []
    for li, s in enumerate(sizes):
        data, mask, offsets_grid = _analytic_level(domain, s, dim, dtype)
        ng = data.shape[1:]
        distributed = li < n_dist
        if distributed:
            m = m0 >> li
            zp = n_shards * m
        else:
            m = 0
            zp = ng[0]
        if zp < ng[0]:
            raise ValueError(
                f"level {li}: padded z {zp} < grid z {ng[0]}; "
                "increase min_local_planes or reduce shards")
        pad = zp - ng[0]
        diag_k = next(i for i, o in enumerate(offsets_grid)
                      if all(v == 0 for v in o))
        if pad:
            data = np.pad(data, [(0, 0), (0, pad)] + [(0, 0)] * (dim - 1))
            mask = np.pad(mask, [(0, pad)] + [(0, 0)] * (dim - 1),
                          constant_values=True)
            data[diag_k, ng[0]:] = 1.0     # z-pad rows: identity, like bc
        d = data[diag_k]
        with np.errstate(divide="ignore"):
            inv_d = np.where(d != 0, 1.0 / d, 1.0).astype(data.dtype)
        out.append(DistMGLevel(data=data, inv_diag=inv_d, bc_mask=mask,
                               offsets_grid=tuple(offsets_grid),
                               node_grid=tuple(ng), local_planes=m,
                               distributed=distributed))

    # dense inverse on the (replicated) coarsest level
    last = out[-1]
    nnp = int(np.prod(last.data.shape[1:]))
    if nnp <= 20_000:
        dense = np.zeros((nnp, nnp), np.float64)
        ngp = last.data.shape[1:]
        strides = np.array([int(np.prod(ngp[d + 1:])) for d in range(dim)])
        idx = np.arange(nnp)
        pos = np.stack([(idx // strides[d]) % ngp[d] for d in range(dim)])
        for k, off in enumerate(last.offsets_grid):
            cpos = pos + np.asarray(off)[:, None]
            valid = np.all((cpos >= 0) & (cpos < np.asarray(ngp)[:, None]),
                           axis=0)
            ci = (cpos * strides[:, None]).sum(0)
            vals = last.data[k].reshape(-1)
            mrow = valid & (vals != 0)
            np.add.at(dense, (idx[mrow], np.clip(ci, 0, nnp - 1)[mrow]),
                      vals[mrow].astype(np.float64))
        inv = np.linalg.inv(dense).astype(last.data.dtype)
        out[-1] = dataclasses.replace(last, coarse_inverse=inv)
    return out


def shard_specs(levels: List[DistMGLevel], axis_name: str = "z"):
    """PartitionSpecs of each level's (data, inv_diag, bc_mask,
    coarse_inverse), as ``put_hierarchy`` places them."""
    specs = []
    for lv in levels:
        if lv.distributed:
            sd, sv = P(None, axis_name), P(axis_name)
        else:
            sd, sv = P(), P()
        ci = P() if lv.coarse_inverse is not None else None
        specs.append((sd, sv, sv, ci))
    return specs


def put_hierarchy(levels: List[DistMGLevel], mesh: Mesh,
                  axis_name: str = "z"):
    """Place every level's arrays on the mesh by ``shard_specs``: the
    distributed levels' as Sharded stripes, the replicated ones' on the
    mesh's first device.  Returns what :func:`mgpcg_dist` takes."""
    out = []
    for lv, specs in zip(levels, shard_specs(levels, axis_name)):
        arrays = (lv.data, lv.inv_diag, lv.bc_mask, lv.coarse_inverse)
        out.append(tuple(None if a is None else shard(np.asarray(a), mesh, sp)
                         for a, sp in zip(arrays, specs)))
    return out


# -- sharded V-cycle ----------------------------------------------------------

def _fit(x, size: int, axis: int):
    """Cut or zero-pad ``x`` along ``axis`` to ``size``."""
    have = x.shape[axis]
    if have > size:
        return x.narrow(axis, 0, size)
    if have < size:
        pad = [0, 0] * (x.dim() - 1 - axis) + [0, size - have]
        return torch.nn.functional.pad(x, pad)
    return x


def _v_cycle_local(levels: List[DistMGLevel], arrs, r, li: int,
                   axis_name: str, nu1: int, nu2: int, omega: float):
    """V-cycle on local blocks. r: Sharded [m, ny, nx] (distributed level)
    or the whole grid (replicated).  Returns e with the same layout."""
    lv = levels[li]
    data, inv_d, mask, cinv = arrs[li]
    ax = axis_name if lv.distributed else None
    dim = len(_local_shape(r))

    def matvec(v):
        return grid_stencil_matvec(data, v, lv.offsets_grid, ax)

    def smooth(rr, e):
        return e + omega * inv_d * (rr - matvec(e))

    if li == len(levels) - 1:
        if cinv is not None:
            return (cinv @ r.reshape(-1)).reshape(r.shape)
        e = omega * inv_d * r
        for _ in range(20):
            e = smooth(r, e)
        return e

    e = omega * inv_d * r
    for _ in range(nu1 - 1):
        e = smooth(r, e)

    resid = r - matvec(e)
    # restrict: W (halo'd stencil), then sample even z / even y,x
    wr = _transfer_w(resid, ax)
    rc = _each(lambda w: _sample_minor(_sample_z_local(w)), wr)

    nxt = levels[li + 1]
    if lv.distributed and not nxt.distributed:
        # transition: gather the restricted residual to replicated
        rc = all_gather(rc, axis_name, axis=0)
    # reconcile z extent with the next level's padded z size, and y/x
    # (even-sampling of size s gives ceil(s/2)) with its grid
    zc_target = (nxt.local_planes if nxt.distributed
                 else nxt.data.shape[1])
    tgt = (zc_target,) + tuple(nxt.data.shape[2:])

    def fit(x):
        for d in range(dim):
            x = _fit(x, tgt[d], d)
        return x

    rc = _each(fit, rc)
    mask_c = arrs[li + 1][2]
    if isinstance(rc, Sharded):
        rc = smap(lambda m, x: torch.where(m, 0.0, x), mask_c, rc)
    else:
        rc = torch.where(mask_c, 0.0, rc)

    ec = _v_cycle_local(levels, arrs, rc, li + 1, axis_name, nu1, nu2, omega)

    # prolong: inject z / y,x then W on THIS level
    if lv.distributed and not nxt.distributed:
        # take my stripe of the replicated coarse correction (padded first:
        # the correction is zero beyond the valid grid)
        mc = lv.local_planes // 2
        zfull = axis_size(r.mesh, axis_name) * mc
        ec = _fit(ec, max(zfull, ec.shape[0]), 0)
        ec = Sharded(r.mesh, [ec[j * mc:(j + 1) * mc].to(dev) for j, dev in
                              zip(axis_index(r.mesh, axis_name),
                                  r.mesh.device_list)], r.spec)
    fine = _local_shape(r)
    ef = _each(lambda c: _inject_z_local(_inject_minor(c, fine[1:]),
                                         fine[0]), ec)
    e = e + _transfer_w(ef, ax)

    for _ in range(nu2):
        e = smooth(r, e)
    return e


def mgpcg_dist(levels: List[DistMGLevel], arrs, b, mesh: Mesh, *,
               axis_name: str = "z", tol: float = 1e-8, maxiter: int = 200,
               nu1: int = 1, nu2: int = 1, omega: float = 0.8) -> CGResult:
    """MG-preconditioned CG on the mesh's shards.

    b: GLOBAL [Zp, ny, nx] grid array (z-padded; pad planes zero), or
    already Sharded over ``mesh``.  arrs: from :func:`put_hierarchy`.
    Returns a CGResult whose x is the Sharded grid (the whole grid when
    no level is distributed).
    """
    fine = levels[0]
    tol = float(tol)
    if not fine.distributed:
        # degenerate hierarchy (odd n_cells or too few planes per shard):
        # every level is replicated — solve on one device, same math
        data0 = arrs[0][0]
        b = unshard(b) if isinstance(b, Sharded) else torch.as_tensor(
            b).to(mesh.home)
        return cg(lambda v: grid_stencil_matvec(data0, v, fine.offsets_grid,
                                                None),
                  b, tol=tol, maxiter=maxiter,
                  M=lambda r: _v_cycle_local(levels, arrs, r, 0, None, nu1,
                                             nu2, omega))

    data0 = arrs[0][0]
    b_l = shard(b, mesh, P(axis_name))

    def matvec(v):
        return grid_stencil_matvec(data0, v, fine.offsets_grid, axis_name)

    def precond(r):
        return _v_cycle_local(levels, arrs, r, 0, axis_name, nu1, nu2, omega)

    return CGResult(*sharded_pcg_loop(matvec, precond, b_l, axis_name, tol,
                                      int(maxiter)))


def solve_poisson_dist(domain, n_cells: int, dim: int, mesh: Mesh,
                       b_nodes, *, axis_name: str = "z", dtype=np.float32,
                       tol: float = 1e-8, maxiter: int = 200,
                       coarse_max: int = 8, min_local_planes: int = 4
                       ) -> Tuple[np.ndarray, CGResult]:
    """End-to-end distributed MG-PCG Poisson solve on (domain)^dim.

    b_nodes: RHS on the valid node grid (flat [NN] or [*node_grid]); BC rows
    must already carry their (zero-Dirichlet) values.  Returns (u [NN],
    CGResult); u is the node-ordered solution on the host.
    """
    n_shards = mesh.shape[axis_name]
    levels = build_dist_hierarchy(domain, n_cells, dim, n_shards,
                                  dtype=dtype, coarse_max=coarse_max,
                                  min_local_planes=min_local_planes)
    fine = levels[0]
    ng = fine.node_grid
    zp = fine.data.shape[1]
    b = np.asarray(b_nodes, _np_dtype(dtype)).reshape(ng)
    b = np.where(fine.bc_mask[:ng[0]], 0, b)
    if zp > ng[0]:
        b = np.pad(b, [(0, zp - ng[0])] + [(0, 0)] * (len(ng) - 1))
    arrs = put_hierarchy(levels, mesh, axis_name)
    res = mgpcg_dist(levels, arrs, b, mesh, axis_name=axis_name, tol=tol,
                     maxiter=maxiter)
    u = unshard(res.x).cpu().numpy()[:ng[0]].reshape(-1)
    return u, res
