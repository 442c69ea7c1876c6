"""Geometric multigrid for the uniform 3D box: the constant-coefficient
preconditioner of the slice, as in tpufem.solve.multigrid.

Nesting is exact: the Kuhn split refines self-similarly under grid halving,
so every non-coarse fine node lies on a coarse edge or diagonal and P1
interpolation is a 2-point average along it.  Factorization:

    P   = W . inject2      (zero-inject coarse into even positions, then
                            apply the constant-weight adjacency stencil W)
    P^T = sample2 . W      (W symmetric; sample even positions)

with W = I + 0.5 * (Kuhn adjacency).  On the uniform box every interior row
of every level carries the same K weights, so a level is K numbers plus a
row-type ``code`` plane (1 interior, 2 Dirichlet, 0 padding): the V-cycle
streams only vectors.  The coarsest level gets a dense inverse.

Ported here: the const hierarchy (``operator="const"``), the V-cycle along
its fused-transfer branch with nu1 = nu2 = 1 (kernels K3 and K4 of
``ops.mg_transfer_cuda``), the coarse dense inverse, and the plain
transfer operators behind K3 and K4.
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

__all__ = ["prolong", "restrict", "ConstMGLevel", "const_matvec_plain",
           "build_poisson_multigrid", "v_cycle", "mg_preconditioner"]


# -- transfer operators on plain node grids (the plain versions of K3/K4) --

# 15-point Kuhn adjacency: axes + face diagonals + main diagonal
_STENCIL_OFFSETS_3D = ((-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
                       (0, 0, -1), (0, 0, 1),
                       (-1, -1, 0), (1, 1, 0), (-1, 0, -1), (1, 0, 1),
                       (0, -1, -1), (0, 1, 1), (-1, -1, -1), (1, 1, 1))


def _transfer_stencil(x: torch.Tensor) -> torch.Tensor:
    """y = x + 0.5 * sum of adjacency-shifted x (zero outside the grid)."""
    xp = torch.nn.functional.pad(x, (1, 1, 1, 1, 1, 1))
    acc = x
    for off in _STENCIL_OFFSETS_3D:
        sl = tuple(slice(1 + o, 1 + o + s) for o, s in zip(off, x.shape))
        acc = acc + 0.5 * xp[sl]
    return acc


def _sample2(x: torch.Tensor) -> torch.Tensor:
    """Even-position decimation along every axis."""
    return x[::2, ::2, ::2].contiguous()


def _inject2(x: torch.Tensor) -> torch.Tensor:
    """Zero-injection into even positions (adjoint of _sample2)."""
    out = x.new_zeros(tuple(2 * s - 1 for s in x.shape))
    out[::2, ::2, ::2] = x
    return out


def _check_3d(x, dim):
    if dim != 3 or x.dim() != 3:
        raise NotImplementedError("the port's transfers are 3D")


def prolong(xc: torch.Tensor, dim: int) -> torch.Tensor:
    """P1-exact prolongation coarse [n+1]^3 -> fine [2n+1]^3 grids."""
    _check_3d(xc, dim)
    return _transfer_stencil(_inject2(xc))


def restrict(rf: torch.Tensor, dim: int) -> torch.Tensor:
    """R = P^T: adjoint of ``prolong`` (fine [2n+1]^3 -> coarse [n+1]^3)."""
    _check_3d(rf, dim)
    return _sample2(_transfer_stencil(rf))


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


# -- hierarchy ----------------------------------------------------------------

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

    @functools.cached_property
    def inv_diag(self) -> torch.Tensor:
        k0 = self.plan.offsets.index(0)
        return torch.where(self.code == 1.0,
                           torch.full_like(self.code, 1.0 / self.weights[k0]),
                           torch.ones_like(self.code))


def _light_grid(domain, s: int, dim: int = 3, with_coords: bool = True):
    """(StructuredInfo, node coords grid [dim, *ng] or None, bc grid) of the
    uniform box (lo, hi)^3 with s cells per side — no mesh, no
    connectivity."""
    if dim != 3:
        raise NotImplementedError("the port's structured grids are 3D")
    lo, hi = domain
    info = StructuredInfo(node_grid=(s + 1,) * dim, cell_grid=(s,) * dim,
                          type_node_offsets=np.asarray(_KUHN_TETS,
                                                       dtype=np.int64))
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
    Ke = p1_stiffness_views(element_coord_views(coords_grid1, info1))
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


def build_poisson_multigrid(domain, n_cells: int, dim: int = 3, *,
                            levels: Optional[int] = None,
                            dtype: torch.dtype = torch.float32,
                            coarse_max: int = 8,
                            device="cpu") -> List[ConstMGLevel]:
    """Hierarchy of constant-coefficient Poisson levels on (domain)^3.

    Halves n_cells while even and > ``coarse_max`` (at most ``levels``
    levels); every level is analytic (one cell's stiffness), and the
    coarsest gets a dense inverse.  This is the reference's
    ``operator="const"`` hierarchy, the only one ported.
    """
    sizes = [n_cells]
    while (sizes[-1] % 2 == 0 and sizes[-1] > coarse_max
           and (levels is None or len(sizes) < levels)):
        sizes.append(sizes[-1] // 2)

    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    out = []
    for s in sizes:
        info, _, bc_grid = _light_grid(domain, s, dim, with_coords=False)
        plan = structured_plan(info, embed=True)
        w = _uniform_weights(plan, _uniform_cell_stiffness(domain, s, dim))
        code_np = _embed_grid_numpy(np.where(bc_grid, 2.0, 1.0),
                                    plan.store_grid, fill=0.0)
        out.append(ConstMGLevel(
            plan=plan, weights=tuple(float(v) for v in w),
            code=torch.as_tensor(code_np.astype(np_dtype), device=device)))
    last = out[-1]
    if int(np.prod(last.plan.info.node_grid)) > _DENSE_COARSE_MAX:
        raise NotImplementedError(
            "coarsest level too large for a dense inverse; the Jacobi "
            "fallback needs the const smoother kernels, not ported yet")
    _, _, bc_grid = _light_grid(domain, sizes[-1], dim, with_coords=False)
    raw = _uniform_stencil_data(
        last.plan, _uniform_cell_stiffness(domain, sizes[-1], dim))
    raw = _apply_bc_numpy(raw, last.plan.offsets, _embed_grid_numpy(
        bc_grid, last.plan.store_grid, fill=False))
    last.coarse_inverse = torch.as_tensor(
        _dense_inverse_from_raw(last.plan, raw).astype(np_dtype),
        device=device)
    return out


def v_cycle(levels: List[ConstMGLevel], r: torch.Tensor, *, li: int = 0,
            omega: float = 0.8, final_dot: bool = False):
    """One V-cycle for A e = r on level li (embedded vectors), nu1 = nu2 = 1.

    Between levels it runs the fused transfer kernels: K3 (residual +
    restrict) and K4 (prolong + add + smooth).  ``final_dot=True`` (top level
    only) returns ``(e, <r, e>)`` with the dot fused into the last K4.
    """
    from tpufem_torch.ops.mg_transfer_cuda import (
        const_prolong_add_smooth_embedded, const_residual_restrict_embedded)

    level = levels[li]
    if final_dot and (li != 0 or li == len(levels) - 1):
        raise ValueError("final_dot needs the top level of a multi-level "
                         "hierarchy")
    if li == len(levels) - 1:
        e_nodes = level.coarse_inverse @ level.plan.extract_field(r)
        return level.plan.embed_field(e_nodes)

    coarse = levels[li + 1]
    e = omega * level.inv_diag * r            # first Jacobi sweep from e = 0
    rc = const_residual_restrict_embedded(level.weights, level.code,
                                          coarse.code, r, e, level.plan,
                                          coarse.plan)
    ec = v_cycle(levels, rc, li=li + 1, omega=omega)
    return const_prolong_add_smooth_embedded(
        level.weights, level.code, ec, r, e, level.plan, coarse.plan,
        omega=omega, with_dot=final_dot)


def mg_preconditioner(levels: List[ConstMGLevel], *, omega: float = 0.8,
                      with_dot: bool = False) -> Callable:
    """M^-1 r = one V-cycle (SPD), for solve.cg.  ``with_dot=True`` returns
    an ``M_dot``: r -> (z, <r, z>) with the dot fused into the last pass."""

    def apply(r):
        if with_dot and len(levels) < 2:
            # a single level is just the coarse solve: no pass to fuse into
            z = v_cycle(levels, r, omega=omega)
            return z, torch.dot(r, z)
        return v_cycle(levels, r, omega=omega, final_dot=with_dot)

    return apply
