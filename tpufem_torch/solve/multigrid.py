"""Geometric multigrid for the uniform 2D and 3D boxes, as in
tpufem.solve.multigrid.

Nesting is exact: the 2D anti-diagonal split and the 3D Kuhn split refine
self-similarly under grid halving, so every non-coarse fine node lies on a
coarse edge or diagonal and P1 interpolation is a 2-point average along
it.  Factorization:

    P   = W . inject2      (zero-inject coarse into even positions, then
                            apply the constant-weight adjacency stencil W)
    P^T = sample2 . W      (W symmetric; sample even positions)

with W = I + 0.5 * (adjacency).  Two kinds of level:

  * ``MGLevel`` (``operator="general"``, the default): the assembled
    stencil planes [K, NS] of the level's operator; the finest level may be
    a given operator (``top=``), e.g. the fused build's.  Its sweeps and
    residuals run kernel B4 (``ops.stencil_cuda``; B3 on grids past the
    blocked-route threshold).
  * ``ConstMGLevel`` (``operator="const"``): on the uniform box every
    interior row carries the same K weights, so a level is K numbers plus a
    row-type ``code`` plane (1 interior, 2 Dirichlet, 0 padding) and the
    V-cycle streams only vectors.  Its sweeps run kernel B5 (B5b past the
    threshold); between two 3D const levels the transfers fuse into
    kernels K3 and K4 (``ops.mg_transfer_cuda``).

The coarsest level gets a dense inverse when it has at most 20,000 nodes,
else 20 damped Jacobi sweeps.  ``restrict``/``prolong`` stay plain PyTorch
(and so does every transfer between 2D levels), as the reference computes
them in XLA outside any Pallas kernel.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Optional

import numpy as np
import torch

from tpufem_torch.assemble.planar import (element_coord_views,
                                          p1_stiffness_views)
from tpufem_torch.assemble.structured import StructuredPlan, structured_plan
from tpufem_torch.mesh.box import _KUHN_TETS
from tpufem_torch.mesh.core import StructuredInfo
from tpufem_torch.ops import stencil_cuda as sc
from tpufem_torch.ops.stencil_cuda import const_matvec_plain
from tpufem_torch.sparse.stencil import stencil_matvec

__all__ = ["prolong", "restrict", "MGLevel", "ConstMGLevel",
           "build_poisson_multigrid", "cast_hierarchy", "v_cycle",
           "mg_preconditioner"]


# -- transfer operators on plain node grids (the plain versions of K3/K4) --

def _stencil_offsets(dim: int):
    if dim == 2:
        # 7-point: axes + the anti-diagonal of the 2D cell split
        return ((-1, 0), (1, 0), (0, -1), (0, 1), (-1, 1), (1, -1))
    if dim == 3:
        # 15-point Kuhn adjacency: axes + face diagonals + main diagonal
        return ((-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
                (0, 0, -1), (0, 0, 1),
                (-1, -1, 0), (1, 1, 0), (-1, 0, -1), (1, 0, 1),
                (0, -1, -1), (0, 1, 1), (-1, -1, -1), (1, 1, 1))
    raise ValueError(f"dim {dim}: the structured grids are 2D or 3D")


def _transfer_stencil(x: torch.Tensor) -> torch.Tensor:
    """y = x + 0.5 * sum of adjacency-shifted x (zero outside the grid)."""
    xp = torch.nn.functional.pad(x, (1, 1) * x.dim())
    acc = x
    for off in _stencil_offsets(x.dim()):
        sl = tuple(slice(1 + o, 1 + o + s) for o, s in zip(off, x.shape))
        acc = acc + 0.5 * xp[sl]
    return acc


def _sample2(x: torch.Tensor) -> torch.Tensor:
    """Even-position decimation along every axis."""
    return x[(slice(None, None, 2),) * x.dim()].contiguous()


def _inject2(x: torch.Tensor) -> torch.Tensor:
    """Zero-injection into even positions (adjoint of _sample2)."""
    out = x.new_zeros(tuple(2 * s - 1 for s in x.shape))
    out[(slice(None, None, 2),) * x.dim()] = x
    return out


def _check_dim(x, dim):
    if x.dim() != dim:
        raise ValueError(f"a {x.dim()}-D grid given for dim={dim}")


def prolong(xc: torch.Tensor, dim: int) -> torch.Tensor:
    """P1-exact prolongation coarse [n+1]^d -> fine [2n+1]^d grids."""
    _check_dim(xc, dim)
    return _transfer_stencil(_inject2(xc))


def restrict(rf: torch.Tensor, dim: int) -> torch.Tensor:
    """R = P^T: adjoint of ``prolong`` (fine [2n+1]^d -> coarse [n+1]^d)."""
    _check_dim(rf, dim)
    return _sample2(_transfer_stencil(rf))


# -- hierarchy ----------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class MGLevel:
    """General level: the embedded stencil planes of the level's operator
    (``data [K, NS]``), its inverse diagonal (1 where the diagonal is 0)
    and its Dirichlet mask."""

    plan: StructuredPlan
    data: torch.Tensor
    inv_diag: torch.Tensor
    bc_mask: torch.Tensor
    coarse_inverse: Optional[torch.Tensor] = None   # dense [NN, NN], coarsest


@dataclasses.dataclass(eq=False)
class ConstMGLevel:
    """Uniform-grid level: K weights replace the [K, NS] coefficient planes
    (one row-type ``code`` plane: 1 = interior, 2 = Dirichlet, 0 = padding).
    Valid as a preconditioner level for any fine operator on the uniform
    box."""

    plan: StructuredPlan
    weights: tuple
    code: torch.Tensor
    coarse_inverse: Optional[torch.Tensor] = None

    @property
    def bc_mask(self) -> torch.Tensor:
        return self.code == 2.0

    @functools.cached_property
    def inv_diag(self) -> torch.Tensor:
        k0 = self.plan.offsets.index(0)
        return torch.where(self.code == 1.0,
                           torch.full_like(self.code, 1.0 / self.weights[k0]),
                           torch.ones_like(self.code))


# the two triangles of the 2D cell split along its anti-diagonal
_ANTI_DIAGONAL_TRIANGLES = ((((0, 0), (0, 1), (1, 0)),
                             ((0, 1), (1, 1), (1, 0))))


def _light_grid(domain, s: int, dim: int = 3, with_coords: bool = True):
    """(StructuredInfo, node coords grid [dim, *ng] or None, bc grid) of the
    uniform box (lo, hi)^dim with s cells per side (dim 2: anti-diagonal
    triangles; dim 3: Kuhn tetrahedra) — no mesh, no connectivity."""
    if dim not in (2, 3):
        raise ValueError(f"dim {dim}: the structured grids are 2D or 3D")
    lo, hi = domain
    offs = _ANTI_DIAGONAL_TRIANGLES if dim == 2 else _KUHN_TETS
    info = StructuredInfo(node_grid=(s + 1,) * dim, cell_grid=(s,) * dim,
                          type_node_offsets=np.asarray(offs, dtype=np.int64))
    coords_grid = None
    if with_coords:
        ax = np.linspace(lo, hi, s + 1)
        grids = np.meshgrid(*([ax] * dim), indexing="ij")
        # coordinate d varies along grid axis (dim-1-d): x fastest
        coords_grid = np.stack([grids[dim - 1 - d] for d in range(dim)])
    bc = np.zeros((s + 1,) * dim, bool)
    for d in range(dim):
        sl0 = [slice(None)] * dim
        sl0[d] = 0
        bc[tuple(sl0)] = True
        sl0[d] = -1
        bc[tuple(sl0)] = True
    return info, coords_grid, bc


def _uniform_cell_stiffness(domain, s: int, dim: int = 3) -> np.ndarray:
    """[T, npe, npe] float64 element stiffness of ONE cell of the uniform
    grid (every cell is split identically)."""
    lo, hi = domain
    h = (hi - lo) / s
    info1, coords_grid1, _ = _light_grid((lo, lo + h), 1, dim)
    Ke = p1_stiffness_views(element_coord_views(coords_grid1, info1),
                            "tetrahedron" if dim == 3 else "triangle")
    return Ke.reshape(Ke.shape[0], Ke.shape[1], Ke.shape[2])


def _uniform_stencil_data(plan: StructuredPlan, Ke_one: np.ndarray,
                          dtype=np.float64) -> np.ndarray:
    """Assembled stencil data [K, NS] of the uniform grid (host numpy)."""
    cell_grid = plan.info.cell_grid
    T, npe = Ke_one.shape[0], Ke_one.shape[1]
    out = np.zeros((plan.width,) + tuple(plan.store_grid), np.float64)
    for t in range(T):
        for a in range(npe):
            for b in range(npe):
                k = int(plan.entry_k[t, a, b])
                sh = plan.entry_shift[t, a, b]
                sl = tuple(slice(int(sh[d]), int(sh[d]) + cell_grid[d])
                           for d in range(len(cell_grid)))
                out[(k,) + sl] += float(Ke_one[t, a, b])
    return out.reshape(plan.width, -1).astype(dtype)


def _embed_grid_numpy(grid: np.ndarray, store_grid, fill=0) -> np.ndarray:
    """numpy twin of StructuredPlan.embed_field for host-side setup."""
    pads = [(1, store_grid[d] - grid.shape[d] - 1) for d in range(grid.ndim)]
    return np.pad(grid, pads, constant_values=fill).reshape(-1)


def _apply_bc_numpy(raw: np.ndarray, offsets, mask_flat: np.ndarray
                    ) -> np.ndarray:
    """Symmetric zero-Dirichlet elimination on stencil data (host)."""
    n = raw.shape[1]
    halo = max(abs(o) for o in offsets) if offsets else 0
    mp = np.pad(mask_flat, (halo, halo))
    keep = ~mask_flat
    for k, off in enumerate(offsets):
        col_bc = mp[halo + off: halo + off + n]
        raw[k] = np.where(keep & ~col_bc, raw[k], 0)
        if off == 0:
            raw[k] = np.where(mask_flat, 1.0, raw[k])
    return raw


def _uniform_weights(plan: StructuredPlan, Ke_one: np.ndarray) -> np.ndarray:
    """[K] interior-row stencil weights of the uniform grid."""
    w = np.zeros(plan.width, np.float64)
    T, npe = Ke_one.shape[0], Ke_one.shape[1]
    for t in range(T):
        for a in range(npe):
            for b in range(npe):
                w[int(plan.entry_k[t, a, b])] += float(Ke_one[t, a, b])
    return w


def _store_to_node_map(plan: StructuredPlan) -> np.ndarray:
    """[num_store_rows] -> node index, -1 on border/padding positions."""
    sg, ng = plan.store_grid, plan.info.node_grid
    coords = np.stack(np.meshgrid(*[np.arange(s) for s in sg],
                                  indexing="ij"), axis=-1)
    pos = coords - 1
    valid = np.ones(sg, bool)
    node = np.zeros(sg, np.int64)
    for d in range(len(sg)):
        p = pos[..., d]
        valid &= (p >= 0) & (p < ng[d])
        node = node * ng[d] + np.clip(p, 0, ng[d] - 1)
    return np.where(valid, node, -1).reshape(-1)


def _dense_inverse_from_raw(plan: StructuredPlan,
                            data_np: np.ndarray) -> np.ndarray:
    """Dense inverse of a (tiny) embedded stencil operator (host)."""
    nn = int(np.prod(plan.info.node_grid))
    dense = np.zeros((nn, nn), np.float64)
    ns = plan.num_store_rows
    node_of = _store_to_node_map(plan)
    store_idx = np.arange(ns)
    for k, off in enumerate(plan.offsets):
        c = store_idx + off
        valid = (c >= 0) & (c < ns)
        ri = node_of[store_idx]
        ci = node_of[np.clip(c, 0, ns - 1)]
        m = valid & (ri >= 0) & (ci >= 0) & (data_np[k] != 0)
        np.add.at(dense, (ri[m], ci[m]), data_np[k][m])
    return np.linalg.inv(dense)


_DENSE_COARSE_MAX = 20_000   # nodes of the coarsest level with a dense inverse
_COARSE_SWEEPS = 20          # Jacobi sweeps on a coarsest level without one


def build_poisson_multigrid(domain, n_cells: int, dim: int = 3, *,
                            levels: Optional[int] = None,
                            dtype: torch.dtype = torch.float32,
                            coarse_max: int = 8,
                            use_pallas: bool = True,
                            operator: str = "general",
                            top: Optional[tuple] = None,
                            device="cuda") -> list:
    """Hierarchy of embedded Poisson operators on (domain)^dim, dim 2 or 3,
    on ``device`` (the card by default; pass ``device="cpu"`` for the plain
    versions on the host).

    Halves n_cells while even and > ``coarse_max`` (at most ``levels``
    levels).  Levels are analytic: the grid is uniform, so each level's
    operator is T*npe^2 constant slice-adds of one cell's stiffness.

    ``operator="general"`` (default) builds ``MGLevel``s with assembled
    planes in ``dtype``; ``top=(data, bc_mask)`` supplies the finest level
    instead (e.g. the fused build's operator), which the level then shares
    with no copy, its inverse diagonal computed on the device.
    ``operator="const"`` builds ``ConstMGLevel``s (``top`` is rejected: the
    fine level is analytic too).  The coarsest level gets a dense inverse
    if it has at most 20,000 nodes; otherwise the V-cycle damps it with
    Jacobi sweeps.  ``use_pallas`` is accepted for call compatibility with
    the reference; the build does not depend on it.
    """
    if operator not in ("general", "const"):
        raise ValueError(f"operator {operator!r}: general | const")
    _stencil_offsets(dim)       # dim 2 or 3, checked before any setup
    if operator == "const" and top is not None:
        raise ValueError("operator='const' is fully analytic; drop top=")
    sizes = [n_cells]
    while (sizes[-1] % 2 == 0 and sizes[-1] > coarse_max
           and (levels is None or len(sizes) < levels)):
        sizes.append(sizes[-1] // 2)

    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    out = []
    for li, s in enumerate(sizes):
        info, _, bc_grid = _light_grid(domain, s, dim, with_coords=False)
        plan = structured_plan(info, embed=True)
        if li == 0 and top is not None:
            data = torch.as_tensor(top[0], device=device)
            bc = torch.as_tensor(top[1], dtype=torch.bool, device=device)
            d = data[plan.offsets.index(0)]
            out.append(MGLevel(plan=plan, data=data,
                               inv_diag=torch.where(d != 0, 1.0 / d, 1.0),
                               bc_mask=bc))
            continue
        Ke_one = _uniform_cell_stiffness(domain, s, dim)
        if operator == "const":
            w = _uniform_weights(plan, Ke_one)
            code_np = _embed_grid_numpy(np.where(bc_grid, 2.0, 1.0),
                                        plan.store_grid, fill=0.0)
            out.append(ConstMGLevel(
                plan=plan, weights=tuple(float(v) for v in w),
                code=torch.as_tensor(code_np.astype(np_dtype),
                                     device=device)))
            continue
        mask_np = _embed_grid_numpy(bc_grid, plan.store_grid, fill=False)
        raw = _apply_bc_numpy(_uniform_stencil_data(plan, Ke_one, np_dtype),
                              plan.offsets, mask_np)
        d_np = raw[plan.offsets.index(0)]
        with np.errstate(divide="ignore"):
            inv_np = np.where(d_np != 0, 1.0 / d_np, 1.0).astype(np_dtype)
        out.append(MGLevel(plan=plan, data=torch.as_tensor(raw, device=device),
                           inv_diag=torch.as_tensor(inv_np, device=device),
                           bc_mask=torch.as_tensor(mask_np, device=device)))

    last = out[-1]
    if int(np.prod(last.plan.info.node_grid)) > _DENSE_COARSE_MAX:
        return out
    if operator == "const":
        _, _, bc_grid = _light_grid(domain, sizes[-1], dim, with_coords=False)
        raw = _apply_bc_numpy(
            _uniform_stencil_data(last.plan, _uniform_cell_stiffness(
                domain, sizes[-1], dim)), last.plan.offsets,
            _embed_grid_numpy(bc_grid, last.plan.store_grid, fill=False))
    else:
        raw = last.data.cpu().double().numpy()
    last.coarse_inverse = torch.as_tensor(
        _dense_inverse_from_raw(last.plan, raw).astype(np_dtype),
        device=device)
    return out


def cast_hierarchy(levels: list, dtype: torch.dtype) -> list:
    """Hierarchy copy with the coefficient planes (data, inv_diag; the code
    plane of a const level) cast to ``dtype``, typically bfloat16.

    The V-cycle is then a fixed linear operator built from the rounded
    (still symmetric) level matrices, so MG-PCG stays valid; products
    against the fp32 vectors widen in-register and only the coefficient
    traffic shrinks.  The coarsest dense inverse keeps its type.  The given
    levels, and a ``top=`` operator they share, are not touched.
    """
    out = []
    for l in levels:
        if isinstance(l, ConstMGLevel):
            out.append(ConstMGLevel(plan=l.plan, weights=l.weights,
                                    code=l.code.to(dtype),
                                    coarse_inverse=l.coarse_inverse))
        else:
            out.append(MGLevel(plan=l.plan, data=l.data.to(dtype),
                               inv_diag=l.inv_diag.to(dtype),
                               bc_mask=l.bc_mask,
                               coarse_inverse=l.coarse_inverse))
    return out


# -- level operators: kernels (use_pallas) or their plain versions -----------

def _matvec_plain(level, x):
    """A x of a level in plain PyTorch (the V-cycle's kernel path fuses
    every product into a residual or a sweep)."""
    if isinstance(level, ConstMGLevel):
        return const_matvec_plain(level.weights, level.code,
                                  level.plan.offsets, x)
    return stencil_matvec(level.data, level.plan.offsets, x)


def _smooth(level, r, e, omega: float, use_pallas: bool, with_dot=False):
    """One weighted-Jacobi sweep e + omega D^-1 (r - A e) (a fused kernel
    with ``use_pallas``); ``with_dot`` also returns <r, e_new>."""
    if use_pallas and isinstance(level, ConstMGLevel):
        fn = (sc.const_smooth_dot_embedded if with_dot
              else sc.const_smooth_embedded)
        return fn(level.weights, level.code, r, e, level.plan, omega=omega)
    if use_pallas:
        fn = (sc.stencil_smooth_dot_embedded if with_dot
              else sc.stencil_smooth_embedded)
        return fn(level.data, r, e, level.inv_diag, level.plan, omega=omega)
    y = e + sc.omega_inv_diag(omega, level.inv_diag) * (
        r - _matvec_plain(level, e))
    return (y, torch.dot(r, y)) if with_dot else y


def _residual(level, r, e, use_pallas: bool):
    if use_pallas and isinstance(level, ConstMGLevel):
        return sc.const_residual_embedded(level.weights, level.code, r, e,
                                          level.plan)
    if use_pallas:
        return sc.stencil_residual_embedded(level.data, r, e, level.plan)
    return r - _matvec_plain(level, e)


def _grid(level, x_store):
    """Embedded field -> plain node grid [ng]."""
    return level.plan.extract_field(x_store).reshape(level.plan.info.node_grid)


def _store(level, x_grid):
    return level.plan.embed_field(x_grid.reshape(-1))


def _can_fuse_transfers(levels, li, nu2, use_pallas, fuse_transfers):
    """The fused transfer kernels (K3, K4) apply between consecutive 3D
    const levels on the kernel path; 2D transfers stay plain, as the
    reference computes them in XLA."""
    return (fuse_transfers and use_pallas and nu2 >= 1
            and isinstance(levels[li], ConstMGLevel)
            and isinstance(levels[li + 1], ConstMGLevel)
            and len(levels[li].plan.info.node_grid) == 3)


def v_cycle(levels: list, r: torch.Tensor, *, li: int = 0, nu1: int = 2,
            nu2: int = 2, omega: float = 0.8, use_pallas: bool = True,
            final_dot: bool = False, fuse_transfers: bool = True):
    """One V-cycle for A e = r on level li (embedded vectors); returns e.

    ``nu1``/``nu2`` pre-/post-smoothing sweeps (the first from e = 0).
    ``final_dot=True`` (top level, nu2 >= 1) returns ``(e, <r, e>)`` with the
    dot fused into the last fine-level sweep.  ``use_pallas=False`` runs the
    plain versions of every level operator.  Between two const levels
    ``fuse_transfers`` runs K3 (residual + restrict) and K4 (prolong + add
    + first post-sweep); otherwise the residual, restrict, prolong and the
    sweeps run one by one.
    """
    level = levels[li]
    dim = len(level.plan.info.node_grid)
    if final_dot and (li != 0 or nu2 < 1 or li == len(levels) - 1):
        raise ValueError("final_dot needs the top level and nu2 >= 1")

    if li == len(levels) - 1:
        if level.coarse_inverse is not None:
            e_nodes = level.coarse_inverse @ level.plan.extract_field(r)
            return level.plan.embed_field(e_nodes)
        # no dense inverse: damp with extra Jacobi sweeps (still linear and
        # symmetric, so PCG stays valid)
        e = sc.omega_inv_diag(omega, level.inv_diag) * r
        for _ in range(_COARSE_SWEEPS):
            e = _smooth(level, r, e, omega, use_pallas)
        return e

    coarse = levels[li + 1]
    kw = dict(nu1=nu1, nu2=nu2, omega=omega, use_pallas=use_pallas,
              fuse_transfers=fuse_transfers)
    e = sc.omega_inv_diag(omega, level.inv_diag) * r   # first sweep, e = 0
    for _ in range(nu1 - 1):
        e = _smooth(level, r, e, omega, use_pallas)

    if _can_fuse_transfers(levels, li, nu2, use_pallas, fuse_transfers):
        from tpufem_torch.ops.mg_transfer_cuda import (
            const_prolong_add_smooth_embedded,
            const_residual_restrict_embedded)

        rc = const_residual_restrict_embedded(level.weights, level.code,
                                              coarse.code, r, e, level.plan,
                                              coarse.plan)
        ec = v_cycle(levels, rc, li=li + 1, **kw)
        if final_dot and nu2 == 1:
            return const_prolong_add_smooth_embedded(
                level.weights, level.code, ec, r, e, level.plan, coarse.plan,
                omega=omega, with_dot=True)
        e = const_prolong_add_smooth_embedded(
            level.weights, level.code, ec, r, e, level.plan, coarse.plan,
            omega=omega)
        for _ in range(nu2 - 1 - int(final_dot)):
            e = _smooth(level, r, e, omega, use_pallas)
        if final_dot:
            return _smooth(level, r, e, omega, use_pallas, with_dot=True)
        return e

    resid = _residual(level, r, e, use_pallas)
    rc = _store(coarse, restrict(_grid(level, resid), dim))
    rc = torch.where(coarse.bc_mask, 0.0, rc)
    ec = v_cycle(levels, rc, li=li + 1, **kw)
    e = e + _store(level, prolong(_grid(coarse, ec), dim))
    for _ in range(nu2 - int(final_dot)):
        e = _smooth(level, r, e, omega, use_pallas)
    if final_dot:
        return _smooth(level, r, e, omega, use_pallas, with_dot=True)
    return e


def mg_preconditioner(levels: list, *, nu1: int = 2, nu2: int = 2,
                      omega: float = 0.8, use_pallas: bool = True,
                      with_dot: bool = False,
                      fuse_transfers: bool = True) -> Callable:
    """M^-1 r = one V-cycle (SPD), for solve.cg.  ``with_dot=True`` returns
    an ``M_dot``: r -> (z, <r, z>) with the dot fused into the last pass."""
    kw = dict(nu1=nu1, nu2=nu2, omega=omega, use_pallas=use_pallas,
              fuse_transfers=fuse_transfers)

    def apply(r):
        if with_dot and len(levels) < 2:
            # a single level is just the coarse solve: no pass to fuse into
            z = v_cycle(levels, r, **kw)
            return z, torch.dot(r, z)
        return v_cycle(levels, r, final_dot=with_dot, **kw)

    return apply
