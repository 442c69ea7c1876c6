"""Distributed ELL and BCSR CG: unstructured meshes sharded across the
device mesh, as in tpufem.dist.ell.

Partitioning: contiguous row stripes (after RCM the stripes are physical
mesh bands).  A matvec needs x values at most ``halo`` rows beyond the
stripe on each side, the furthest any column reaches past its row's
stripe, so one ``ppermute`` per direction per matvec is the whole
communication.  Column indices are rewritten shard-locally at partition
time; the in-shard matvec is the plain gather-multiply (XLA in the
reference).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpufem_torch.dist.cg import sharded_pcg_loop
from tpufem_torch.dist.mesh import Mesh, P, Sharded, shard, smap, unshard
from tpufem_torch.dist.stencil import halo_exchange
from tpufem_torch.solve.cg import CGResult

__all__ = ["pad_identity_rows", "sharded_pcg_loop", "ELLPartition",
           "ell_partition", "sharded_ell_matvec", "ell_cg_sharded",
           "distributed_ell_solve", "BCSRPartition", "bcsr_partition",
           "sharded_bcsr_matvec", "bcsr_cg_sharded", "distributed_bcsr_solve"]


def pad_identity_rows(data, cols, np_rows):
    """Pad ELL arrays with decoupled identity rows (diag 1 in slot 0,
    remaining slots self-pointing with value 0) up to ``np_rows``.  The CG
    trajectory of the original system is preserved exactly."""
    n, K = data.shape
    if np_rows == n:
        return data, cols
    pad = np_rows - n
    data = np.concatenate([data, np.zeros((pad, K), data.dtype)])
    data[n:, 0] = 1.0
    self_cols = np.arange(n, np_rows, dtype=cols.dtype)[:, None]
    cols = np.concatenate(
        [cols, np.broadcast_to(self_cols, (pad, K)).astype(cols.dtype)])
    return data, cols


def _halo_and_rel(cols, L, np_rows, min_halo, hint):
    rows = np.arange(np_rows)
    stripe_start = (rows // L) * L
    reach_left = np.maximum(stripe_start[:, None] - cols, 0).max()
    reach_right = np.maximum(cols - (stripe_start[:, None] + L - 1), 0).max()
    halo = max(int(max(reach_left, reach_right)), int(min_halo))
    if halo > L:
        raise ValueError(
            f"halo {halo} exceeds stripe height {L}: {hint}")
    rel = (cols - (stripe_start[:, None] - halo)).astype(np.int32)
    return halo, rel, rows


class ELLPartition(NamedTuple):
    """Row-stripe partition of an ELL matrix for ``num_shards`` devices."""
    data: np.ndarray        # [NP, K] values (identity padding rows)
    rel: np.ndarray         # [NP, K] int32 halo-local column indices
    inv_diag: np.ndarray    # [NP] 1/diag (1.0 on padding rows)
    halo: int               # rows exchanged per side per matvec
    n: int                  # original rows
    local_rows: int         # NP / num_shards
    num_shards: int


def ell_partition(data, cols, num_shards: int, *,
                  min_halo: int = 1) -> ELLPartition:
    """Partition an ELL matrix (data [N, K], cols [N, K]) into row stripes.

    Pads to a multiple of ``num_shards`` with identity rows, computes the
    halo each stripe needs, and rewrites every column index relative to
    (stripe_start - halo), i.e. into the local haloed vector.  Raises if
    the halo exceeds the stripe height (renumber the mesh with
    ``mesh.adjacency.reverse_cuthill_mckee`` or use fewer shards).
    """
    data = np.asarray(data)
    cols = np.asarray(cols, np.int64)
    n, K = data.shape
    L = -(-n // num_shards)
    np_rows = L * num_shards
    data, cols = pad_identity_rows(data, cols, np_rows)
    halo, rel, rows = _halo_and_rel(
        cols, L, np_rows, min_halo,
        "single-hop neighbor exchange cannot cover the coupling — renumber "
        "the mesh (reverse_cuthill_mckee) or use fewer shards")
    diag = np.where(cols == rows[:, None], data, 0.0).sum(1)
    with np.errstate(divide="ignore"):
        inv_diag = np.where(diag != 0, 1.0 / diag, 1.0).astype(data.dtype)
    return ELLPartition(data=data, rel=rel, inv_diag=inv_diag, halo=halo,
                        n=n, local_rows=L, num_shards=num_shards)


def _sum_slots(prod, dims):
    """Sum ``prod`` over ``dims`` one slot at a time, in row-major order
    (as XLA's reduction does: the fp64 CG counts then match the JAX
    package's, where a tree-shaped sum moved them)."""
    keep = [d for d in range(prod.dim()) if d not in dims]
    flat = prod.permute(keep + list(dims)).flatten(len(keep))
    acc = flat[..., 0]
    for s in range(1, flat.shape[-1]):
        acc = acc + flat[..., s]
    return acc


def sharded_ell_matvec(data_l: Sharded, rel_l: Sharded, x_local: Sharded,
                       halo: int, axis_name: str) -> Sharded:
    """Local stripe of y = A x.  data_l/rel_l [L, K], x_local [L]."""
    left, right = halo_exchange(x_local, halo, axis_name)
    return smap(lambda d, r, x, lo, hi: _sum_slots(
        d * torch.cat([lo, x, hi])[r.long()], (1,)), data_l, rel_l, x_local,
        left, right, spec=x_local.spec)


def ell_cg_sharded(part: ELLPartition, b, mesh: Mesh, *,
                   axis_name: str = "rows", tol: float = 1e-8,
                   maxiter: int = 1000,
                   diag_precondition: bool = True) -> CGResult:
    """Jacobi-PCG on the partitioned ELL system over the mesh's shards.

    ``b`` [NP] (padded; a global tensor or already Sharded).  Every inner
    product is a local dot + psum; state stays sharded for the whole solve.
    """
    data_l = shard(torch.as_tensor(part.data), mesh, P(axis_name, None))
    rel_l = shard(torch.as_tensor(part.rel), mesh, P(axis_name, None))
    invd_l = shard(torch.as_tensor(part.inv_diag), mesh, P(axis_name))

    def matvec(v):
        return sharded_ell_matvec(data_l, rel_l, v, part.halo, axis_name)

    prec = (lambda r: r * invd_l) if diag_precondition else (lambda r: r)
    return CGResult(*sharded_pcg_loop(matvec, prec,
                                      shard(b, mesh, P(axis_name)),
                                      axis_name, float(tol), int(maxiter)))


def distributed_ell_solve(data, cols, b, mesh: Mesh, *,
                          axis_name: str = "rows", tol: float = 1e-8,
                          maxiter: int = 1000):
    """Convenience wrapper: partition an (assembled, BC-applied) ELL system
    over ``mesh``, shard it, CG-solve.  Returns (x [original rows], result).
    """
    num = mesh.shape[axis_name]
    part = ell_partition(_host(data), _host(cols), num)
    b_p = np.pad(_host(b), (0, part.data.shape[0] - part.n))
    res = ell_cg_sharded(part, b_p, mesh, axis_name=axis_name, tol=tol,
                         maxiter=maxiter)
    return unshard(res.x)[:part.n], res


# -- BCSR (vector-block) variant ----------------------------------------------

class BCSRPartition(NamedTuple):
    """Node-row-stripe partition of a BCSR matrix (elasticity etc.)."""
    data: np.ndarray          # [NP, K, b, b] (identity-block padding rows)
    rel: np.ndarray           # [NP, K] int32 halo-local node indices
    inv_diag: np.ndarray      # [NP, b, b] inverted diagonal blocks
    halo: int
    n: int                    # original node rows
    local_rows: int
    num_shards: int
    block_size: int


def bcsr_partition(data, cols, num_shards: int, *,
                   min_halo: int = 1) -> BCSRPartition:
    """Partition a BCSR matrix (data [N, K, b, b], cols [N, K]) into node
    -row stripes; see :func:`ell_partition` — same halo/column rewrite on
    the node pattern, block-Jacobi diagonal inverted at partition time."""
    data = np.asarray(data)
    cols = np.asarray(cols, np.int64)
    n, K, bs, _ = data.shape
    L = -(-n // num_shards)
    np_rows = L * num_shards
    if np_rows != n:
        pad = np_rows - n
        data = np.pad(data, ((0, pad), (0, 0), (0, 0), (0, 0)))
        data[n:, 0] = np.eye(bs, dtype=data.dtype)
        self_cols = np.arange(n, np_rows, dtype=cols.dtype)[:, None]
        cols = np.concatenate(
            [cols, np.broadcast_to(self_cols, (pad, K)).copy()])
    halo, rel, rows = _halo_and_rel(
        cols, L, np_rows, min_halo,
        "renumber the mesh (reverse_cuthill_mckee) or use fewer shards")
    diag = np.where((cols == rows[:, None])[:, :, None, None],
                    data, 0.0).sum(1)                       # [NP, b, b]
    # guard all-zero diagonals (shouldn't occur after BC application)
    sing = np.abs(np.linalg.det(diag)) < 1e-300
    diag[sing] = np.eye(bs, dtype=data.dtype)
    inv_diag = np.linalg.inv(diag).astype(data.dtype)
    return BCSRPartition(data=data, rel=rel, inv_diag=inv_diag, halo=halo,
                         n=n, local_rows=L, num_shards=num_shards,
                         block_size=bs)


def _bcsr_local(d, r, xb, lo, hi):
    L, _, bs, _ = d.shape
    gathered = torch.cat([lo, xb, hi], dim=0)[r.long()]      # [L, K, b]
    return _sum_slots(d * gathered[:, :, None, :], (1, 3)).reshape(-1)


def sharded_bcsr_matvec(data_l: Sharded, rel_l: Sharded, x_local: Sharded,
                        halo: int, axis_name: str) -> Sharded:
    """Local stripe of y = A x.  data_l [L, K, b, b], x_local [L*b]
    (node-major, component-minor)."""
    bs = data_l.local_shape[2]
    xb = x_local.map(lambda x: x.reshape(-1, bs))
    left, right = halo_exchange(xb, halo, axis_name)
    return smap(_bcsr_local, data_l, rel_l, xb, left, right,
                spec=x_local.spec)


def bcsr_cg_sharded(part: BCSRPartition, b, mesh: Mesh, *,
                    axis_name: str = "rows", tol: float = 1e-8,
                    maxiter: int = 1000) -> CGResult:
    """Block-Jacobi PCG on the partitioned BCSR system over the mesh.

    ``b`` [NP*b] (padded, node-major comp-minor)."""
    bs = part.block_size
    data_l = shard(torch.as_tensor(part.data), mesh,
                   P(axis_name, None, None, None))
    rel_l = shard(torch.as_tensor(part.rel), mesh, P(axis_name, None))
    invd_l = shard(torch.as_tensor(part.inv_diag), mesh,
                   P(axis_name, None, None))

    def matvec(v):
        return sharded_bcsr_matvec(data_l, rel_l, v, part.halo, axis_name)

    def prec(r):
        # the block-Jacobi product, its b terms summed in order
        return smap(lambda iv, v: _sum_slots(iv * v.reshape(-1, 1, bs),
                                             (2,)).reshape(-1),
                    invd_l, r, spec=r.spec)

    return CGResult(*sharded_pcg_loop(matvec, prec,
                                      shard(b, mesh, P(axis_name)),
                                      axis_name, float(tol), int(maxiter)))


def distributed_bcsr_solve(A, b, mesh: Mesh, *, axis_name: str = "rows",
                           tol: float = 1e-8, maxiter: int = 1000):
    """Partition a (BC-applied) BCSRMatrix system over ``mesh`` and solve.

    Returns (x [original dofs], CGResult).  RCM-order the node numbering
    first for narrow halos (mesh.adjacency.reverse_cuthill_mckee).
    """
    num = mesh.shape[axis_name]
    part = bcsr_partition(_host(A.data), _host(A.cols), num)
    bs = part.block_size
    b_p = np.pad(_host(b), (0, (part.data.shape[0] - part.n) * bs))
    res = bcsr_cg_sharded(part, b_p, mesh, axis_name=axis_name, tol=tol,
                          maxiter=maxiter)
    return unshard(res.x)[:part.n * bs], res


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
