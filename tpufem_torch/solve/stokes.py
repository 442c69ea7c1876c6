"""Stokes flow: Taylor-Hood P2-P1 mixed elements and block-preconditioned
MINRES, as in tpufem.solve.stokes.

    -nu div(grad u) + grad p = f        u in [P2]^d  (velocity)
                       div u = 0        p in  P1     (pressure),

a symmetric INDEFINITE system

    [ A   B^T ] [u]   [f]
    [ B   0   ] [p] = [0],   A = nu * vector-P2 Laplacian,
                             B = -int q div(v)  (pressure x velocity).

Both blocks are applied matrix-free: gather the element DOFs, contract
against the stored element matrices, add the element results into the
nodes.  The reference adds them with an unordered scatter; here the node
sums follow a plan built once per connectivity (sparse.matfree's: every
node's incident entries in element order, a gather and a left-to-right
sum), so a product has no atomics and gives the same bits from run to run.
Velocity Dirichlet rows are projected symmetrically (S K S + (I - S), the
rhs lifted) and the constant pressure mode by the mean projection, so
MINRES (solve/minres.py) keeps p mean-zero.  The preconditioner is the SPD
block diagonal diag(diag(A)^-1, nu M_p^-1) with the lumped P1 pressure
mass, or with ``velocity_precond="amg"`` one scalar-AMG V-cycle per
velocity component, whose level products are kernel B9 on the card.

The reference's pytree registration of the operator (its jit boundary) has
no counterpart here.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from tpufem_torch.assemble.dense import assemble_vector
from tpufem_torch.assemble.local import affine_geometry
from tpufem_torch.fem.quadrature import rule_for_cell
from tpufem_torch.fem.space import FunctionSpace, VectorFunctionSpace
from tpufem_torch.forms.language import fsum, grad, inner
from tpufem_torch.forms.weakform import WeakForm
from tpufem_torch.mesh.core import Mesh
from tpufem_torch.solve.elasticity import _synced
from tpufem_torch.solve.minres import MinresResult, minres
from tpufem_torch.sparse.matfree import _node_sum, _node_sum_plan

__all__ = ["StokesSolution", "StokesOperator", "build_stokes",
           "build_velocity_amg", "solve_stokes"]


class StokesSolution(NamedTuple):
    u: torch.Tensor            # [NV] velocity DOFs (node-major, comp-minor)
    p: torch.Tensor            # [NQ] pressure DOFs (mean-zero)
    res: MinresResult
    V: FunctionSpace           # velocity space ([P2]^d)
    Q: FunctionSpace           # pressure space (P1)
    walls: dict


@dataclasses.dataclass
class StokesOperator:
    """Matrix-free saddle-point operator and its block-diagonal
    preconditioner.  The seven fields are the reference's; the node-sum
    plans of the two connectivities are built beside them, once, when the
    operator is made (on the fields' device)."""

    Ke: torch.Tensor           # [NE, nlv, nlv] viscous block element matrices
    Be: torch.Tensor           # [NE, nlq, nlv] divergence element matrices
    conn_v: torch.Tensor       # [NE, nlv] velocity DOF connectivity
    conn_q: torch.Tensor       # [NE, nlq] pressure DOF connectivity
    free_v: torch.Tensor       # [NV] bool: velocity DOF not Dirichlet
    diag_a: torch.Tensor       # [NV] diag of A (BC rows = 1)
    mp_lumped: torch.Tensor    # [NQ] lumped pressure mass / nu

    def __post_init__(self):
        dev = self.Ke.device
        self._cv = self.conn_v.long()
        self._cq = self.conn_q.long()
        self._plan_v = _node_sum_plan(self.conn_v.cpu().numpy(), self.nv,
                                      dev)
        self._plan_q = _node_sum_plan(self.conn_q.cpu().numpy(), self.nq,
                                      dev)

    @property
    def nv(self) -> int:
        return int(self.free_v.shape[0])

    @property
    def nq(self) -> int:
        return int(self.mp_lumped.shape[0])

    # -- block applications --------------------------------------------------

    def apply_a(self, u):
        ue = u[self._cv]                                  # [NE, nlv]
        ye = fsum(self.Ke * ue[:, None, :], 2)
        return _node_sum(ye, self._plan_v)

    def apply_b(self, u):
        ue = u[self._cv]                                  # [NE, nlv]
        ye = fsum(self.Be * ue[:, None, :], 2)            # [NE, nlq]
        return _node_sum(ye, self._plan_q)

    def apply_bt(self, p):
        pe = p[self._cq]                                  # [NE, nlq]
        ye = fsum(self.Be * pe[:, :, None], 1)            # [NE, nlv]
        return _node_sum(ye, self._plan_v)

    # -- saddle-point system (BC-projected, pressure mean-projected) ---------

    def _proj_p(self, p):
        return p - torch.mean(p)

    def matvec(self, x):
        """K_tilde x for x = [u; p]: S K S + (I - S) on velocity,
        Pi B S / S B^T Pi coupling, symmetric by construction."""
        u, p = x[:self.nv], x[self.nv:]
        uf = torch.where(self.free_v, u, 0.0)
        pp = self._proj_p(p)
        yu = self.apply_a(uf) + self.apply_bt(pp)
        yu = torch.where(self.free_v, yu, u)
        yp = self._proj_p(self.apply_b(uf))
        return torch.cat([yu, yp])

    def rhs(self, f_v, u_bc):
        """Lifted rhs [S(f - K u_bc) + u_bc; Pi(-B u_bc)]."""
        bu = torch.where(self.free_v, f_v - self.apply_a(u_bc), u_bc)
        bp = self._proj_p(-self.apply_b(u_bc))
        return torch.cat([bu, bp])

    def precond(self, r):
        """SPD block diagonal: diag(A)^-1 on velocity, nu M_p^-1 on
        pressure (mp_lumped already carries the 1/nu)."""
        ru, rp = r[:self.nv], r[self.nv:]
        zu = ru / self.diag_a
        zp = self._proj_p(rp / self.mp_lumped)
        return torch.cat([zu, zp])


def build_stokes(mesh: Mesh, *, viscosity: float = 1.0,
                 dtype=torch.float64, device="cuda"):
    """Matrix-free Taylor-Hood operator blocks for a mesh, on ``device``.

    Returns ``(op, V, Q)``: the :class:`StokesOperator` and the velocity
    and pressure spaces."""
    V = VectorFunctionSpace(mesh, degree=2)
    Q = FunctionSpace(mesh, degree=1)
    d = mesh.dim

    # A = nu * vector Laplacian through the weak-form frontend
    wf = WeakForm(V, dtype=dtype, device=device)
    wf.build(lambda u, v: float(viscosity) * inner(grad(u), grad(v)))
    ecoords = torch.as_tensor(mesh.element_coords(), dtype=dtype,
                              device=device)
    Ke = wf.element_matrices(ecoords)                     # [NE, nlv, nlv]

    # B = -int q div(v): P1 value x P2 physical gradient at the points of
    # a rule exact for the (degree 1) * (degree 1) integrand
    rule = rule_for_cell(mesh.cell_type, 3)
    pts = np.asarray(rule.points)

    def table(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    w = table(rule.weights)                               # sums to |ref cell|
    phi_q = table(Q.element.shape_values(pts))            # [Qp, nlq]
    gref_v = table(V.element.shape_grads(pts))            # [Qp, nlvs, d]
    G, adet = affine_geometry(ecoords, Q.element)         # P1 corner geometry
    invJ = G[:, :d, :]                                    # [NE, m, d]
    # gphys[e,q,n,c] = sum_m gref[q,n,m] invJ[e,m,c]
    gphys = fsum(gref_v[None, :, :, :, None]
                 * invJ[:, None, None, :, :], 3)          # [NE, Qp, nlvs, d]
    # Be4[e,i,n,c] = -sum_q w_q phi[q,i] gphys[e,q,n,c] * |detJ|
    Be4 = -fsum(w[None, :, None, None, None] * phi_q[None, :, :, None, None]
                * gphys[:, :, None, :, :], 1)             # [NE, nlq, nlvs, d]
    Be4 = Be4 * adet[:, None, None, None]
    nlq = phi_q.shape[1]
    # (scalar dof, component) -> component-minor, the vector space's DOF
    # expansion
    Be = Be4.reshape(Be4.shape[0], nlq, -1)

    conn_v = torch.as_tensor(V.dof_conn, device=device)
    conn_q = torch.as_tensor(Q.dof_conn, device=device)
    free_v = torch.as_tensor(~V.dof_flags, device=device)

    # diag(A) with unit BC rows (the projected system is identity there)
    diag_ke = torch.diagonal(Ke, dim1=1, dim2=2)          # [NE, nlv]
    diag_a = assemble_vector(conn_v, diag_ke, V.num_dofs)
    diag_a = torch.where(free_v, diag_a, 1.0)

    # lumped pressure mass (row sums = int psi_i), scaled by 1/nu so the
    # preconditioner is nu * M_p^-1
    mass_rows = fsum(w[None, :, None] * phi_q[None]
                     * adet[:, None, None], 1)            # [NE, nlq]
    mp = assemble_vector(conn_q, mass_rows, Q.num_scalar_dofs)
    mp = mp / float(viscosity)

    op = StokesOperator(Ke=Ke, Be=Be, conn_v=conn_v, conn_q=conn_q,
                        free_v=free_v, diag_a=diag_a, mp_lumped=mp)
    return op, V, Q


def build_velocity_amg(mesh: Mesh, V: FunctionSpace, *,
                       viscosity: float = 1.0, dtype=torch.float64,
                       walls_out: Optional[dict] = None, device="cuda",
                       **amg_kw):
    """Scalar-AMG preconditioner pieces for the velocity block.

    The velocity block A is nu x the VECTOR P2 Laplacian with independent
    components, so one smoothed-aggregation hierarchy on the SCALAR P2
    Laplacian (same viscosity, same Dirichlet rows) preconditions every
    component.  The scalar DOFs are RCM-renumbered first so the
    hierarchy's products ride the banded kernel (B9); the permutation is
    conjugated into the preconditioner (z = P^T V-cycle(P r)).  On the card
    build_amg gives every level its banded plan at setup and raises where
    one fails.

    Returns ``(hier, perm, inv)``: the hierarchy and the permutation and
    its inverse as int64 tensors on ``device``.
    """
    from tpufem_torch.assemble.ell import ell_values_scatter
    from tpufem_torch.mesh.adjacency import ell_pattern, reverse_cuthill_mckee
    from tpufem_torch.solve.amg import build_amg
    from tpufem_torch.solve.bc import apply_dirichlet_ell
    from tpufem_torch.sparse.ell import (_AUTO_BAND_MAX, ELLMatrix,
                                         _bandwidth)
    from tpufem_torch.sparse.ell_cuda import auto_block_rows

    t0 = time.perf_counter()
    Vs = FunctionSpace(mesh, degree=V.element.degree)   # scalar twin:
    # identical scalar DOF numbering to V's (same construction path)
    wf = WeakForm(Vs, dtype=dtype, device=device)
    wf.build(lambda u, v: float(viscosity) * inner(grad(u), grad(v)))
    ec = torch.as_tensor(mesh.element_coords(), dtype=dtype, device=device)

    cols0 = ell_pattern(Vs.scalar_dof_conn, Vs.num_scalar_dofs,
                        with_sort_plan=False).cols
    perm = reverse_cuthill_mckee(cols0)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=perm.dtype)
    conn_p = inv[Vs.scalar_dof_conn].astype(Vs.scalar_dof_conn.dtype)
    pat = ell_pattern(conn_p, Vs.num_scalar_dofs, pad_to=8,
                      with_sort_plan=False)
    nrows, width = pat.cols.shape

    # element matrices -> ELL values (sorted, deterministic accumulation)
    # -> Dirichlet rows
    def index(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    data = ell_values_scatter(pat.slots.reshape(-1), wf.element_matrices(ec),
                              nrows, width)
    A_s, _ = apply_dirichlet_ell(
        ELLMatrix(data, index(pat.cols), index(pat.row_lengths),
                  index(pat.diag_pos)),
        torch.zeros(nrows, dtype=dtype, device=device),
        index(Vs.scalar_dof_flags[perm]))
    # the reference's automatic band policy, without its quiet fallback: a
    # plan that cannot be built raises
    bw = _bandwidth(pat.cols)
    if bw <= _AUTO_BAND_MAX:
        A_s.prime_band_plan(auto_block_rows(bw, nrows, width))
    if walls_out is not None:
        walls_out["scalar_system"] = _synced(device) - t0
    hier = build_amg(A_s, walls_out=walls_out, **amg_kw)
    return hier, index(perm).long(), index(inv).long()


def velocity_amg_precond(op: StokesOperator, hier, perm, inv, d: int):
    """SPD block preconditioner: a scalar V-cycle per velocity component
    (conjugated by the RCM permutation), the lumped mass on pressure."""
    def M(r):
        ru, rp = r[:op.nv], r[op.nv:]
        rs = ru.reshape(-1, d)                           # [nsd, d]
        zs = torch.stack([hier.apply(rs[:, c][perm])[inv]
                          for c in range(d)], dim=-1)
        zp = op._proj_p(rp / op.mp_lumped)
        return torch.cat([zs.reshape(-1), zp])
    return M


def solve_stokes(mesh: Mesh, *, body_force: Optional[Callable] = None,
                 bc_velocity: Optional[Callable] = None,
                 viscosity: float = 1.0, dtype=torch.float64,
                 tol: float = 1e-8, maxiter: int = 20_000,
                 check_every: int = 4,
                 velocity_precond: str = "jacobi",
                 amg_kw: Optional[dict] = None,
                 device="cuda") -> StokesSolution:
    """Assemble and solve Stokes with block-preconditioned MINRES.

    ``body_force``: callable on torch points x[..., d] -> f[..., d]
    (None = 0).  ``bc_velocity``: callable on the host's numpy boundary
    velocity DOF coordinates x[..., d] -> u[..., d] (None = no-slip
    everywhere); Taylor-Hood places velocity DOFs at vertices and edge
    midpoints, so it sees both.  ``velocity_precond``: "jacobi" =
    diag(A)^-1 (iterations grow ~1/h); "amg" = one scalar-AMG V-cycle per
    velocity component (build_velocity_amg), ``amg_kw`` passed to
    build_amg.

    ``walls``: "build", "precond_setup" and "precond_setup_detail" (AMG
    only) and "solve", each ending in a device synchronize.  The
    reference's "solve_compile" has no counterpart: nothing is compiled.
    """
    if velocity_precond not in ("jacobi", "amg"):
        raise ValueError(f"unknown velocity_precond {velocity_precond!r}")
    walls: dict = {}
    t0 = time.perf_counter()
    op, V, Q = build_stokes(mesh, viscosity=viscosity, dtype=dtype,
                            device=device)

    # velocity rhs: f against the vector P2 test functions
    if body_force is not None:
        from tpufem_torch.forms.language import Coefficient, dot

        f = Coefficient(body_force, rank=1)
        wf = WeakForm(V, dtype=dtype, device=device)
        wf.build(None, lambda v: dot(f, v))
        ecoords = torch.as_tensor(mesh.element_coords(), dtype=dtype,
                                  device=device)
        f_v = assemble_vector(V.dof_conn, wf.element_vectors(ecoords),
                              V.num_dofs)
    else:
        f_v = torch.zeros(V.num_dofs, dtype=dtype, device=device)

    # boundary velocity values at the DOF coordinates
    if bc_velocity is not None:
        vals = np.asarray(bc_velocity(V.scalar_dof_coords))  # [nsd, d]
        u_bc = torch.as_tensor(np.where(V.dof_flags, vals.reshape(-1), 0.0),
                               dtype=dtype, device=device)
    else:
        u_bc = torch.zeros(V.num_dofs, dtype=dtype, device=device)
    walls["build"] = _synced(device) - t0

    d = mesh.dim
    if velocity_precond == "amg":
        t0 = time.perf_counter()
        pw: dict = {}
        hier, perm, inv = build_velocity_amg(
            mesh, V, viscosity=viscosity, dtype=dtype, walls_out=pw,
            device=device, **(amg_kw or {}))
        walls["precond_setup"] = _synced(device) - t0
        # stage walls rounded as the reference rounds them; the
        # hierarchy's shape as it is
        walls["precond_setup_detail"] = {
            k: (round(v, 2) if isinstance(v, float)
                and k != "operator_complexity" else v)
            for k, v in pw.items()}
        M = velocity_amg_precond(op, hier, perm, inv, d)
    else:
        M = op.precond

    t0 = time.perf_counter()
    res = minres(op.matvec, op.rhs(f_v, u_bc), tol=tol, maxiter=maxiter,
                 M=M, check_every=check_every)
    walls["solve"] = _synced(device) - t0

    nv = V.num_dofs
    u = res.x[:nv]
    p = res.x[nv:]
    p = p - torch.mean(p)
    return StokesSolution(u=u, p=p, res=res, V=V, Q=Q, walls=walls)
