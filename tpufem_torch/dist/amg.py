"""Distributed smoothed-aggregation AMG for unstructured ELL systems, as in
tpufem.dist.amg.

The interval aggregation of solve.amg makes the distribution local:
aggregates are fixed stride-s windows along the RCM line, and the rows are
split into contiguous stripes whose height is a multiple of
s**num_levels, so

  * an aggregate never straddles a shard boundary: restriction's window
    sum and prolongation's upsample are shard-local;
  * the only communication of the cycle is the halo exchange of the
    sharded ELL matvec (dist.ell.sharded_ell_matvec, one ``ppermute`` per
    direction) inside the smoothers and P = (I - omega D^-1 A) T;
  * the coarsest solve is a replicated dense inverse applied to an
    ``all_gather`` of the (tiny) coarse residual.

The setup runs once on the host (solve.amg.build_amg on a CPU copy of the
system, pre-padded with identity rows so every level's row count divides
num_shards * s**remaining_levels); each level is partitioned with
dist.ell.ell_partition and kept as host numpy, and the solve places each
stripe on its shard's device.  The in-shard matvec is plain PyTorch, as
the reference's is XLA: this path launches no hand-written kernel.

The cycle defaults to W (``cycle="W"``), where solve.amg defaults to V:
the reference's choice, kept so the two packages give the same counts.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpufem_torch.dist.ell import (ell_partition, pad_identity_rows,
                                   sharded_ell_matvec, sharded_pcg_loop)
from tpufem_torch.dist.mesh import (Mesh, P, Sharded, all_gather,
                                    axis_index, shard, smap, unshard)
from tpufem_torch.solve.amg import _cheb_smooth, build_amg
from tpufem_torch.solve.cg import CGResult
from tpufem_torch.sparse.ell import ELLMatrix

__all__ = ["DistAMGHierarchy", "build_dist_amg", "dist_amg_apply",
           "dist_amg_pcg"]


class _LevelStatic(NamedTuple):
    halo: int               # matvec halo rows per side at this level
    s: int                  # aggregate stride
    lmax: float             # Gershgorin bound on spec(D^-1 A)
    omega: float            # prolongator smoothing weight
    local_rows: int         # stripe height at this level


class DistAMGHierarchy(NamedTuple):
    # per-level HOST arrays (data [NP,K], rel [NP,K], inv_diag [NP],
    # tv [NP]); the solve places each stripe on its shard's device
    level_arrays: tuple
    static: tuple           # tuple[_LevelStatic], parallel to level_arrays
    # the fine operator's partition for the outer CG matvec (aliases
    # level_arrays[0] when levels exist; the only partition otherwise)
    fine_arrays: tuple      # (data [NP,K], rel [NP,K], inv_diag [NP]) host
    fine_halo: int
    coarse_inv: np.ndarray  # [NC, NC] dense inverse (replicated at solve)
    smoother_degree: int
    smoother_ratio: float
    gamma: int              # 1 = V-cycle, 2 = W-cycle
    n: int                  # original (unpadded) fine rows
    np_rows: int            # padded fine rows (= num_shards * stripe)
    num_shards: int
    base: object = None     # single-device AMGHierarchy (on the CPU) of
                            # the padded system; kept with keep_base=True


def build_dist_amg(data, cols, num_shards: int, *, coarse_n: int = 1200,
                   max_levels: int = 12, interval_size: int = 6,
                   cycle: str = "W", omega_scale: float = 4.0 / 3.0,
                   smoother_degree: int = 2, smoother_ratio: float = 8.0,
                   keep_base: bool = False,
                   chunk: int = 1 << 21) -> DistAMGHierarchy:
    """Build a sharded interval-aggregation hierarchy from host ELL arrays.

    ``data``/``cols``: the assembled, BC-applied, RCM-ordered system
    (numpy or tensors [N, K]).  The system is padded so that every level's
    rows divide ``num_shards`` with stripe heights that are multiples of
    the aggregate stride, the invariant that keeps all transfers
    shard-local.  ``keep_base`` keeps the single-device hierarchy (built
    on the CPU) for parity tests.
    """
    data = _host(data)
    cols = _host(cols)
    n = data.shape[0]
    s = int(interval_size)

    # number of coarsening steps the hierarchy will take: a fixed point on
    # the PADDED size (the loop is monotone and bounded by max_levels)
    nlev = 0
    while True:
        unit = num_shards * s ** nlev
        np_rows = -(-n // unit) * unit
        m, steps = np_rows, 0
        while m > coarse_n and steps < max_levels:
            m = -(-m // s)
            steps += 1
        if steps == nlev:
            break
        nlev = steps
    data_p, cols_p = pad_identity_rows(data, cols, np_rows)

    A = ELLMatrix(torch.as_tensor(data_p), torch.as_tensor(cols_p))
    base = build_amg(A, coarse_n=coarse_n, max_levels=max_levels,
                     omega_scale=omega_scale,
                     smoother_degree=smoother_degree,
                     smoother_ratio=smoother_ratio,
                     aggregation="interval", interval_size=s, cycle=cycle,
                     chunk=chunk)
    assert len(base.levels) == nlev, (len(base.levels), nlev)

    level_arrays = []
    static = []
    for lv in base.levels:
        d = lv.A.data.numpy()
        c = lv.A.cols.numpy()
        part = ell_partition(d, c, num_shards)
        assert part.data.shape[0] == d.shape[0], \
            "level rows must already divide num_shards (padding invariant)"
        level_arrays.append((part.data, part.rel, part.inv_diag,
                             lv.tv.numpy()))
        static.append(_LevelStatic(halo=part.halo, s=lv.s, lmax=lv.lmax,
                                   omega=lv.omega,
                                   local_rows=part.local_rows))

    if level_arrays:
        fine_arrays = level_arrays[0][:3]
        fine_halo = static[0].halo
    else:
        # whole system at/below coarse_n: the "cycle" is the dense solve,
        # but the CG still needs the fine operator's partition
        part = ell_partition(data_p, cols_p, num_shards)
        fine_arrays = (part.data, part.rel, part.inv_diag)
        fine_halo = part.halo

    return DistAMGHierarchy(level_arrays=tuple(level_arrays),
                            static=tuple(static),
                            fine_arrays=fine_arrays, fine_halo=fine_halo,
                            coarse_inv=base.coarse_inv.numpy(),
                            smoother_degree=int(smoother_degree),
                            smoother_ratio=float(smoother_ratio),
                            gamma=base.gamma, n=n, np_rows=np_rows,
                            num_shards=num_shards,
                            base=base if keep_base else None)


def _device_arrays(h: DistAMGHierarchy, mesh: Mesh, axis_name: str):
    """Place the host hierarchy on the mesh: each shard holds its own row
    stripe of every level, the coarse inverse is replicated."""
    def rows2(a):
        return shard(torch.as_tensor(a), mesh, P(axis_name, None))

    def rows1(a):
        return shard(torch.as_tensor(a), mesh, P(axis_name))

    levels = tuple((rows2(d), rows2(r), rows1(i), rows1(t))
                   for (d, r, i, t) in h.level_arrays)
    if levels:
        fine = levels[0][:3]
    else:
        fd, fr, fi = h.fine_arrays
        fine = (rows2(fd), rows2(fr), rows1(fi))
    cinv = shard(torch.as_tensor(h.coarse_inv), mesh, P())
    return levels, fine, cinv


def _mk_cycle(h: DistAMGHierarchy, axis_name: str):
    """cycle(l, levels, coarse_inv, r) on Sharded vectors: solve.amg's
    _vcycle level by level, the transfers shard-local by the stripe-height
    invariant."""
    nlev = len(h.static)
    deg, ratio = h.smoother_degree, h.smoother_ratio
    coarse_rows = h.coarse_inv.shape[0] // h.num_shards

    def cycle(l, levels, coarse_inv, r: Sharded):
        if l == nlev:
            zg = coarse_inv @ all_gather(r, axis_name)
            mesh = r.mesh
            return Sharded(mesh, [
                zg[i * coarse_rows:(i + 1) * coarse_rows].to(dev)
                for i, dev in zip(axis_index(mesh, axis_name),
                                  mesh.device_list)], r.spec)
        data_l, rel_l, invd_l, tv_l = levels[l]
        st = h.static[l]

        def mv(v):
            return sharded_ell_matvec(data_l, rel_l, v, st.halo, axis_name)

        def restrict(res):
            # rc = T^T (I - omega A D^-1) res: shard-local window sum
            w = tv_l * (res - st.omega * mv(invd_l * res))
            return w.map(lambda u: u.reshape(st.local_rows // st.s,
                                             st.s).sum(1))

        def prolong(xc):
            # x = (I - omega D^-1 A) T xc: shard-local upsample
            t = tv_l * xc.map(lambda u: torch.repeat_interleave(u, st.s))
            return t - st.omega * (invd_l * mv(t))

        x = _cheb_smooth(mv, invd_l, st.lmax, deg, ratio, r)
        res = r - mv(x)
        rc = restrict(res)
        xc = cycle(l + 1, levels, coarse_inv, rc)
        if h.gamma >= 2 and l + 1 < nlev:
            d1, r1, _, _ = levels[l + 1]
            st1 = h.static[l + 1]
            rc2 = rc - sharded_ell_matvec(d1, r1, xc, st1.halo, axis_name)
            xc = xc + cycle(l + 1, levels, coarse_inv, rc2)
        x = x + prolong(xc)
        x = x + _cheb_smooth(mv, invd_l, st.lmax, deg, ratio, r - mv(x))
        return x

    return cycle


def dist_amg_apply(h: DistAMGHierarchy, r, mesh: Mesh, *,
                   axis_name: str = "rows"):
    """z = cycle(r) as a standalone sharded preconditioner application
    (``r`` [np_rows], padded); returns the global z on the mesh's first
    device.  Mainly for verification: the solver below runs the cycle
    inside its sharded CG."""
    cycle = _mk_cycle(h, axis_name)
    levels, _, cinv = _device_arrays(h, mesh, axis_name)
    r_l = shard(torch.as_tensor(r), mesh, P(axis_name))
    return unshard(cycle(0, levels, cinv, r_l))


def dist_amg_pcg(h: DistAMGHierarchy, b, mesh: Mesh, *,
                 axis_name: str = "rows", tol: float = 1e-8,
                 maxiter: int = 500):
    """AMG-preconditioned CG on the sharded system.

    ``b``: [n] (original rows) or [np_rows], numpy or tensor; padded and
    sharded here.  Returns (x [n], CGResult), the contract of
    dist.ell.distributed_ell_solve.
    """
    cycle = _mk_cycle(h, axis_name)
    levels, fine, cinv = _device_arrays(h, mesh, axis_name)
    data_l, rel_l, _ = fine
    b = _host(b)
    if b.shape[0] == h.n and h.np_rows != h.n:
        b = np.pad(b, (0, h.np_rows - h.n))
    b_l = shard(torch.as_tensor(b), mesh, P(axis_name))

    def matvec(v):
        return sharded_ell_matvec(data_l, rel_l, v, h.fine_halo, axis_name)

    def prec(r):
        return cycle(0, levels, cinv, r)

    res = CGResult(*sharded_pcg_loop(matvec, prec, b_l, axis_name,
                                     float(tol), int(maxiter)))
    return unshard(res.x)[:h.n], res


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
