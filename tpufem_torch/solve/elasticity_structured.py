"""3D elasticity at scale on structured boxes: the analytic block-stencil
path, as in tpufem.solve.elasticity_structured.

On a uniform box every cell contributes the same [12, 12] element matrix,
so the assembled operator is a 15-offset stencil of constant-per-offset
3 x 3 blocks with boundary corrections, set up on the host with slice-adds
(the scalar analytic multigrid levels' method), and no element arrays or
index arrays exist:

  * the SpMV is y_c = sum_k sum_d data[k, c, d] * shift(x_d, off_k): 135
    shifted multiply-adds over embedded [NS] planes (``block_stencil_
    matvec``; XLA in the reference, plain PyTorch here);
  * the consistent RHS is the analytic scalar mass stencil applied to the
    nodal body-force components;
  * block-Jacobi: precomputed 3 x 3 diagonal-block inverses, 9 more
    multiply-adds; or ``precond="mg"``, the vector geometric multigrid
    (componentwise P1 transfers, block-Jacobi smoothing, a dense
    coarsest inverse).

The displacement is clamped to zero on the whole box boundary.  The host
setup is numpy; the solve runs on the card unless ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from tpufem_torch.assemble.structured import StructuredPlan, structured_plan
from tpufem_torch.solve.cg import CGResult, cg
from tpufem_torch.solve.multigrid import (_embed_grid_numpy, _light_grid,
                                          _store_to_node_map,
                                          _uniform_stencil_data, prolong,
                                          restrict)
from tpufem_torch.sparse.stencil import stencil_matvec

__all__ = ["ElasticityBoxSolution", "uniform_cell_matrices",
           "elasticity_stencil_data", "block_stencil_matvec",
           "solve_elasticity_box", "manufactured_elasticity_3d",
           "build_elasticity_multigrid", "elastic_mg_preconditioner"]


class ElasticityBoxSolution(NamedTuple):
    u: torch.Tensor                # [3, NN] displacement components
    cg: CGResult
    num_dofs: int
    node_grid: tuple


def _np_dtype(dtype):
    return np.dtype(str(dtype).replace("torch.", "")).type


def uniform_cell_matrices(domain, s: int, lam: float, mu: float,
                          dtype=np.float64):
    """([T, 12, 12] elasticity Ke, [T, 4, 4] mass Me) of ONE cell, numpy
    (the weak form on the host in float64)."""
    from tpufem_torch.assemble.local import element_mass
    from tpufem_torch.fem.elements import P1Tetrahedron
    from tpufem_torch.fem.quadrature import tetrahedron_rule
    from tpufem_torch.fem.space import VectorFunctionSpace
    from tpufem_torch.mesh.box import box_mesh
    from tpufem_torch.solve.elasticity import elasticity_forms

    lo, hi = domain
    h = (hi - lo) / s
    mesh1 = box_mesh(lo, lo + h, lo, lo + h, lo, lo + h, 1, 1, 1)
    V = VectorFunctionSpace(mesh1, degree=1)
    wf = elasticity_forms(V, lam, mu)
    wf.dtype, wf.device = torch.float64, "cpu"
    ec = torch.as_tensor(mesh1.element_coords(), dtype=torch.float64)
    Ke = wf.element_matrices(ec).numpy().astype(dtype)        # [6, 12, 12]
    Me = element_mass(ec, P1Tetrahedron(),
                      tetrahedron_rule(2)).numpy().astype(dtype)
    return Ke, Me


def elasticity_stencil_data(plan: StructuredPlan, Ke_one: np.ndarray,
                            dtype=np.float32) -> np.ndarray:
    """[K, 3, 3, NS] block-stencil data from one cell's [T, 12, 12] Ke.

    Constant slice-adds per (type, local row, local col), the vector twin
    of solve.multigrid._uniform_stencil_data.  DOF order inside Ke is
    node-major, component-minor (fem.space convention).
    """
    cell_grid = plan.info.cell_grid
    sg = plan.store_grid
    T = Ke_one.shape[0]
    npe = Ke_one.shape[1] // 3
    out = np.zeros((plan.width, 3, 3) + tuple(sg), np.float64)
    for t in range(T):
        for a in range(npe):
            for b in range(npe):
                k = int(plan.entry_k[t, a, b])
                sh = plan.entry_shift[t, a, b]
                sl = tuple(slice(int(sh[d]), int(sh[d]) + cell_grid[d])
                           for d in range(len(cell_grid)))
                blk = Ke_one[t, 3 * a:3 * a + 3, 3 * b:3 * b + 3]
                out[(k, slice(None), slice(None)) + sl] += \
                    blk[:, :, None, None, None]
    return out.reshape(plan.width, 3, 3, -1).astype(np.dtype(dtype))


def _apply_bc_blocks(data: np.ndarray, offsets, mask_flat: np.ndarray):
    """Clamped-boundary elimination on block-stencil data (numpy, host):
    zero row / column blocks at masked nodes, an identity diagonal block
    there."""
    n = data.shape[-1]
    halo = max(abs(o) for o in offsets)
    mp = np.pad(mask_flat, (halo, halo))
    keep = ~mask_flat
    for k, off in enumerate(offsets):
        col_bc = mp[halo + off: halo + off + n]
        live = (keep & ~col_bc)
        data[k] *= live
        if off == 0:
            for c in range(3):
                data[k, c, c] = np.where(mask_flat, 1.0, data[k, c, c])
    return data


def block_stencil_matvec(data, x, offsets):
    """y[c, i] = sum_k sum_d data[k, c, d, i] * x[d, i + off_k].

    data [K, 3, 3, NS], x [3, NS]: shifted multiply-adds, no gathers (the
    reference leaves it to XLA; plain PyTorch here)."""
    n = x.shape[-1]
    halo = max(abs(int(o)) for o in offsets)
    xp = torch.nn.functional.pad(x, (halo, halo))
    y = None
    for k, off in enumerate(offsets):
        xs = xp[:, halo + int(off): halo + int(off) + n]
        contrib = (data[k] * xs[None, :, :]).sum(dim=1)      # [3, NS]
        y = contrib if y is None else y + contrib
    return y


@dataclasses.dataclass
class ElasticMGLevel:
    """One vector-multigrid level (embedded layout, analytic assembly)."""
    plan: StructuredPlan
    data: torch.Tensor            # [K, 3, 3, NS]
    inv_blocks: torch.Tensor      # [3, 3, NS] inverted diagonal blocks
    bc_mask: torch.Tensor         # [NS]
    coarse_inverse: Optional[torch.Tensor]   # dense [3 NN, 3 NN] or None


def _block_inverse(data_np, offsets, dtype):
    """[3, 3, NS] inverses of the diagonal blocks (identity where one is
    singular)."""
    D = np.moveaxis(data_np[offsets.index(0)], -1, 0)          # [NS, 3, 3]
    Dinv = np.linalg.inv(D + np.where(
        np.abs(np.linalg.det(D)) < 1e-30, 1.0, 0.0)[:, None, None]
        * np.eye(3))
    return np.moveaxis(Dinv, 0, -1).astype(dtype)


def _level_setup(domain, s, lam, mu, dtype):
    info, _, bc_grid = _light_grid(domain, s, 3, with_coords=False)
    plan = structured_plan(info, embed=True)
    Ke1, _ = uniform_cell_matrices(domain, s, lam, mu)
    data_np = elasticity_stencil_data(plan, Ke1, dtype)
    mask_np = _embed_grid_numpy(bc_grid, plan.store_grid, fill=False)
    data_np = _apply_bc_blocks(data_np, plan.offsets, mask_np)
    return plan, data_np, _block_inverse(data_np, plan.offsets, dtype), \
        mask_np


def build_elasticity_multigrid(domain, n_cells: int, *, lam: float,
                               mu: float, dtype=torch.float32,
                               coarse_max: int = 8, device="cuda"):
    """Analytic vector-MG hierarchy: per-level block-stencil operators,
    inverted diagonal blocks, a dense inverse on the coarsest level (at
    most 6000 DOFs).  Transfers are the scalar P1 operators applied per
    displacement component (P1 interpolation reproduces the rigid
    translations and every linear field)."""
    npd = _np_dtype(dtype)
    sizes = [n_cells]
    while sizes[-1] % 2 == 0 and sizes[-1] > coarse_max:
        sizes.append(sizes[-1] // 2)
    levels = []
    for li, s in enumerate(sizes):
        plan, data_np, Dinv, mask_np = _level_setup(domain, s, lam, mu, npd)
        cinv = None
        if li == len(sizes) - 1:
            nn = int(np.prod(plan.info.node_grid))
            if 3 * nn <= 6000:
                cinv = torch.as_tensor(_dense_block_inverse(plan, data_np),
                                       device=device).to(dtype)
        levels.append(ElasticMGLevel(
            plan=plan, data=torch.as_tensor(data_np, device=device),
            inv_blocks=torch.as_tensor(Dinv, device=device),
            bc_mask=torch.as_tensor(mask_np, device=device),
            coarse_inverse=cinv))
    return levels


def _dense_block_inverse(plan: StructuredPlan, data_np) -> np.ndarray:
    """Dense inverse of the coarsest operator over the valid node DOFs
    (node-major, component-minor)."""
    node_of = _store_to_node_map(plan)         # [NS] -> node or -1
    ns = plan.num_store_rows
    nn = int(np.prod(plan.info.node_grid))
    n3 = 3 * nn
    dense = np.zeros((n3, n3), np.float64)
    idx = np.arange(ns)
    for k, off in enumerate(plan.offsets):
        cidx = idx + off
        ok = (cidx >= 0) & (cidx < ns)
        ri = node_of[idx]
        ci = node_of[np.clip(cidx, 0, ns - 1)]
        m = ok & (ri >= 0) & (ci >= 0)
        for c in range(3):
            for d in range(3):
                vals = data_np[k, c, d][m]
                nz = vals != 0
                np.add.at(dense, (3 * ri[m][nz] + c, 3 * ci[m][nz] + d),
                          vals[nz].astype(np.float64))
    return np.linalg.inv(dense)


def _grid3(plan, x_store):
    """[3, NS] embedded -> [3, *node_grid]."""
    ng = plan.info.node_grid
    return torch.stack([plan.extract_field(x_store[c]).reshape(ng)
                        for c in range(3)])


def _store3(plan, x_grid):
    return torch.stack([plan.embed_field(x_grid[c].reshape(-1))
                        for c in range(3)])


def elastic_v_cycle(levels, r, *, li: int = 0, nu1: int = 1, nu2: int = 1,
                    omega: float = 0.7):
    """One V-cycle for the block-stencil elasticity system; r [3, NS]."""
    lv = levels[li]
    offsets = lv.plan.offsets

    def matvec(x):
        return block_stencil_matvec(lv.data, x, offsets)

    def bsmooth(rr, e):
        resid = rr - matvec(e)
        return e + omega * (lv.inv_blocks * resid[None]).sum(dim=1)

    if li == len(levels) - 1:
        if lv.coarse_inverse is not None:
            nn = int(np.prod(lv.plan.info.node_grid))
            rg = _grid3(lv.plan, r).reshape(3, -1)     # [3, NN] node order
            rflat = rg.T.reshape(-1)                   # node-major
            e = lv.coarse_inverse.to(r.dtype) @ rflat
            eg = e.reshape(nn, 3).T.reshape(
                (3,) + tuple(lv.plan.info.node_grid))
            return _store3(lv.plan, eg)
        e = omega * (lv.inv_blocks * r[None]).sum(dim=1)
        for _ in range(20):
            e = bsmooth(r, e)
        return e

    e = omega * (lv.inv_blocks * r[None]).sum(dim=1)
    for _ in range(nu1 - 1):
        e = bsmooth(r, e)

    resid = r - matvec(e)
    rg = _grid3(lv.plan, resid)
    rc_grid = torch.stack([restrict(rg[c], 3) for c in range(3)])
    nxt = levels[li + 1]
    rc = _store3(nxt.plan, rc_grid)
    rc = torch.where(nxt.bc_mask[None], 0.0, rc)

    ec = elastic_v_cycle(levels, rc, li=li + 1, nu1=nu1, nu2=nu2,
                         omega=omega)

    eg = _grid3(nxt.plan, ec)
    ef = torch.stack([prolong(eg[c], 3) for c in range(3)])
    e = e + _store3(lv.plan, ef)

    for _ in range(nu2):
        e = bsmooth(r, e)
    return e


def elastic_mg_preconditioner(levels, *, nu1: int = 1, nu2: int = 1,
                              omega: float = 0.7):
    def apply(r):
        return elastic_v_cycle(levels, r, nu1=nu1, nu2=nu2, omega=omega)
    return apply


def manufactured_elasticity_3d(lam: float, mu: float, amp=(1.0, 0.7, -0.5)):
    """u_c = amp_c * phi, phi = prod(9 - x_d^2): (u_exact(x), f(x)) numpy
    callables, f = -div sigma(u) = -(lam+mu) grad(div u) - mu laplace(u)
    evaluated analytically for the separable polynomial phi."""
    a = np.asarray(amp, np.float64)

    def parts(x, y, z):
        px, py, pz = 9.0 - x * x, 9.0 - y * y, 9.0 - z * z
        phi = px * py * pz
        d1 = np.stack([-2 * x * py * pz, -2 * y * px * pz,
                       -2 * z * px * py])                     # grad phi
        lap = -2.0 * (py * pz + px * pz + px * py)
        # Hessian entries H[i][j] = d2 phi / dxi dxj
        H = np.empty((3, 3) + np.shape(phi))
        H[0, 0] = -2 * py * pz
        H[1, 1] = -2 * px * pz
        H[2, 2] = -2 * px * py
        H[0, 1] = H[1, 0] = 4 * x * y * pz
        H[0, 2] = H[2, 0] = 4 * x * z * py
        H[1, 2] = H[2, 1] = 4 * y * z * px
        return phi, d1, lap, H

    def u_exact(x, y, z):
        phi = (9.0 - x * x) * (9.0 - y * y) * (9.0 - z * z)
        return np.stack([a[c] * phi for c in range(3)])

    def f(x, y, z):
        phi, d1, lap, H = parts(np.asarray(x, np.float64),
                                np.asarray(y, np.float64),
                                np.asarray(z, np.float64))
        # div u = sum_c a_c d_c phi;  grad(div u)_i = sum_c a_c H[i, c]
        gdiv = np.einsum("c,ic...->i...", a, H)
        a_b = a.reshape((3,) + (1,) * np.ndim(lap))
        return -(lam + mu) * gdiv - mu * a_b * lap[None]

    return u_exact, f


def solve_elasticity_box(domain, n_cells: int, *, lam: float = 1.0,
                         mu: float = 1.0, body_force: Callable = None,
                         dtype=torch.float32, tol: float = 1e-6,
                         maxiter: int = 2000, precond: str = "jacobi",
                         matvec_impl: Optional[Callable] = None,
                         device="cuda") -> ElasticityBoxSolution:
    """Clamped 3D elasticity on (domain)^3 with n_cells^3 cells.

    body_force: f(x, y, z) -> [3, ...] (numpy, evaluated on the node
    grid).  Assembly and preconditioner setup are analytic (host numpy);
    the solve runs PCG on the block-stencil SpMV with ``precond="jacobi"``
    (3 x 3 block-Jacobi) or ``"mg"`` (the vector geometric multigrid).
    ``matvec_impl(data, x)`` replaces the block-stencil product.  Runs on
    the card unless ``device="cpu"``.
    """
    if precond not in ("jacobi", "mg"):
        raise ValueError(f"unknown precond {precond!r}")
    npd = _np_dtype(dtype)
    info, coords_grid, bc_grid = _light_grid(domain, n_cells, 3)
    plan = structured_plan(info, embed=True)
    offsets = plan.offsets
    ng = info.node_grid
    nn = int(np.prod(ng))

    Ke1, Me1 = uniform_cell_matrices(domain, n_cells, lam, mu)
    data_np = elasticity_stencil_data(plan, Ke1, npd)
    mask_np = _embed_grid_numpy(bc_grid, plan.store_grid, fill=False)
    data_np = _apply_bc_blocks(data_np, offsets, mask_np)

    # consistent RHS: scalar mass stencil applied to nodal f components
    mass_np = _uniform_stencil_data(plan, Me1, npd)
    if body_force is None:
        f_nodes = np.zeros((3,) + tuple(ng))
    else:
        f_nodes = np.asarray(body_force(coords_grid[0], coords_grid[1],
                                        coords_grid[2]))
    b_np = np.stack([
        _embed_grid_numpy(f_nodes[c].reshape(ng), plan.store_grid)
        for c in range(3)]).astype(npd)

    data = torch.as_tensor(data_np, device=device)
    mass = torch.as_tensor(mass_np, device=device)
    Minv = torch.as_tensor(_block_inverse(data_np, offsets, npd),
                           device=device)
    b_f = torch.as_tensor(b_np, device=device)
    mask = torch.as_tensor(mask_np, device=device)
    mv = matvec_impl or (lambda d, x: block_stencil_matvec(d, x, offsets))

    b = torch.stack([stencil_matvec(mass, offsets, b_f[c])
                     for c in range(3)])
    b = torch.where(mask[None, :], 0.0, b)
    if precond == "mg":
        M = elastic_mg_preconditioner(build_elasticity_multigrid(
            domain, n_cells, lam=lam, mu=mu, dtype=dtype, device=device),
            nu1=1, nu2=1)
    else:
        def M(r):
            return (Minv * r[None, :, :]).sum(dim=1)

    res = cg(lambda x: mv(data, x), b, tol=tol, maxiter=maxiter, M=M)
    u = torch.stack([plan.extract_field(res.x[c]) for c in range(3)])
    return ElasticityBoxSolution(u=u, cg=res, num_dofs=3 * nn,
                                 node_grid=tuple(ng))
