"""WeakForm: user lambdas -> element matrices and vectors -> assembled
systems, as in tpufem.forms.weakform.

    V  = FunctionSpace(mesh, degree=1)
    X  = SpatialCoordinate(V)
    wf = WeakForm(V)
    wf.build(lambda u, v: dot(grad(u), grad(v)),
             lambda v: (36 - 2 * (X[0] ** 2 + X[1] ** 2)) * v)
    wf.build_boundary(rhs=lambda v: g * v)          # Neumann data (ds)
    A, b = wf.assemble(format="ell")

``build`` stores the expression trees; evaluation binds every (trial,
test) basis pair at once by broadcasting over the leading axes [A(trial),
B(test), NE, Q] and contracts against the quadrature weights and |det J|.
The reference lets ``jax.jit`` fuse those broadcasts into one XLA kernel;
eager PyTorch materialises each intermediate (the 2D elasticity integrand
is [6, 6, NE, 7, 2, 2]: 4 GB in fp32 at 980,000 triangles), so the element
kernels run over chunks of elements, each small enough that one
intermediate stays within ``_CHUNK_BYTES``.  An element's result depends
only on its own coordinates, and every sum is an explicit left-to-right
``fsum`` (torch's reductions group rows by shape), so the chunking changes
no bit.

Cells: affine simplices (one Jacobian per element) and the tensor-product
quads and hexes (the multilinear map's Jacobian at every quadrature
point).  Boundary (ds) terms run over the boundary facets of
``fem.facets`` (triangles, tets, quads); their slots are added into the
assembled matrix with sorted accumulating scatters, so the sums are the
same from run to run on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from tpufem_torch.assemble.dense import assemble_dense, assemble_vector
from tpufem_torch.assemble.ell import assemble_ell
from tpufem_torch.assemble.structured import (assemble_stencil_structured,
                                              structured_plan)
from tpufem_torch.assemble.local import _inv_and_det
from tpufem_torch.fem.elements import element_for_cell, is_affine_cell
from tpufem_torch.fem.facets import (BoundaryFacets, boundary_facets,
                                     facet_dof_conn, facet_geometry)
from tpufem_torch.fem.quadrature import QuadratureRule, rule_for_cell
from tpufem_torch.fem.space import FunctionSpace
from tpufem_torch.forms.language import (Expr, TestFunction, TrialFunction,
                                         fsum)
from tpufem_torch.sparse.ell import ELLMatrix
from tpufem_torch.sparse.stencil import StencilMatrix

__all__ = ["WeakForm", "EvalContext", "Function", "integrate",
           "integrate_boundary"]

# one broadcast intermediate [A, B, chunk, Q, d, d] stays under this size
_CHUNK_BYTES = 1 << 29


def chunk_elements(space: FunctionSpace, rule: QuadratureRule,
                   dtype) -> int:
    """Elements per evaluation: the largest broadcast intermediate of a
    bilinear form, [nd, nd, chunk, Q, d, d], within ``_CHUNK_BYTES``.  It
    bounds the per-point geometry's of quads and hexes too,
    [chunk, Q, n, d, d] with n the cell's nodes or the basis' (n <= nd)."""
    nd, d = space.local_dofs, space.mesh.dim
    per_element = (nd * nd * rule.num_points * d * d
                   * torch.empty((), dtype=dtype).element_size())
    return max(1, _CHUNK_BYTES // per_element)


class EvalContext:
    """Numeric bindings for expression evaluation.

    All tensors broadcast against the leading axes [A, B, NE, Q] plus the
    value shape; degenerate axes are kept size-1.
    """

    def __init__(self, *, xq, dtype, phi=None, gphys=None, dof_conn=None,
                 trial_value=None, trial_grad=None,
                 test_value=None, test_grad=None, normal=None):
        self.xq = xq                    # [NE, Q, d]
        self.dtype = dtype
        self.device = xq.device
        self.phi = phi                  # [Q, ns] scalar shape values
        self.gphys = gphys              # [NE, Q, ns, d] physical gradients
        self.dof_conn = dof_conn        # [NE, ns] scalar dof connectivity
        self.normal = normal            # boundary ctx: broadcastable [..., d]
        self._trial_value = trial_value
        self._trial_grad = trial_grad
        self._test_value = test_value
        self._test_grad = test_grad

    def _get(self, v, what):
        if v is None:
            raise ValueError(
                f"{what} function used in a form that does not bind one "
                "(e.g. trial function inside a linear form)")
        return v

    @property
    def trial_value(self):
        return self._get(self._trial_value, "trial")

    @property
    def trial_grad(self):
        return self._get(self._trial_grad, "trial")

    @property
    def test_value(self):
        return self._get(self._test_value, "test")

    @property
    def test_grad(self):
        return self._get(self._test_grad, "test")


class Function(Expr):
    """A discrete FEM function (nodal DOF values) usable inside forms;
    ``values`` is the global DOF vector (a tensor or an array)."""

    def __init__(self, space: FunctionSpace, values):
        self.space = space
        self.values = values
        self.rank = 0 if space.num_components == 1 else 1

    def _elements(self, ctx):
        nc = self.space.num_components
        vals = torch.as_tensor(self.values, dtype=ctx.dtype,
                               device=ctx.device)
        if nc == 1:
            return vals[ctx.dof_conn]                     # [NE, ns]
        return vals.reshape(-1, nc)[ctx.dof_conn]         # [NE, ns, nc]

    def evaluate(self, ctx: EvalContext):
        ue = self._elements(ctx)
        if self.space.num_components == 1:
            # u(q) = sum_n phi[q, n] ue[e, n]
            return fsum(ctx.phi[None] * ue[:, None, :], 2)   # [NE, Q]
        return fsum(ctx.phi[None, :, :, None] * ue[:, None, :, :], 2)

    def gradient(self, ctx: EvalContext):
        ue = self._elements(ctx)
        if self.space.num_components == 1:
            return fsum(ctx.gphys * ue[:, None, :, None], 2)
        return fsum(ctx.gphys[:, :, :, None, :] * ue[:, None, :, :, None], 2)


# ---------------------------------------------------------------------------

def _table(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=dtype, device=device)


def _basis_tables(space: FunctionSpace, rule: QuadratureRule, dtype, device):
    """phi [Q, ns], dN [Q, ns, dim] as tensors."""
    el = space.element
    return (_table(el.shape_values(rule.points), dtype, device),
            _table(el.shape_grads(rule.points), dtype, device))


def _geometry(ecoords, dN, space: FunctionSpace, rule, dtype):
    """gphys [NE, Q, ns, d], |detJ| [NE, Q], xq [NE, Q, d].

    Two regimes, by cell type:

    * affine simplices: the P1 vertex map has a constant Jacobian per
      element, even for a higher-order basis (P2, whose gradients vary
      with q only through dN): one inverse per element, |detJ| broadcast
      over Q;
    * tensor-product cells (quad/hex): the multilinear isoparametric
      map's Jacobian varies across the cell, so J, its inverse and |detJ|
      are evaluated at every quadrature point.

    All contractions are broadcast-multiply-reduce, as in the reference,
    each sum an explicit left-to-right ``fsum``.
    """
    cell = space.mesh.cell_type
    device = ecoords.device
    geo = element_for_cell(cell, 1)
    phi_geo = _table(geo.shape_values(rule.points), dtype, device)  # [Q, npe]
    nq = rule.points.shape[0]
    if is_affine_cell(cell):
        dN_geo = _table(geo.shape_grads(rule.points)[0], dtype,
                        device)                                  # [npe, m]
        # J[e, d, m] = sum_n x[e, n, d] dN_geo[n, m]
        J = fsum(ecoords[:, :, :, None] * dN_geo[None, :, None, :], 1)
        invJ, det = _inv_and_det(J)
        # gphys[e, q, n, d] = sum_m dN[q, n, m] invJ[e, m, d]
        gphys = fsum(dN[None, :, :, :, None] * invJ[:, None, None, :, :], 3)
        adet = det.abs()[:, None].expand(ecoords.shape[0], nq)
    else:
        dN_geo = _table(geo.shape_grads(rule.points), dtype,
                        device)                                  # [Q, npe, m]
        # J[e, q, d, m] = sum_n x[e, n, d] dN_geo[q, n, m]
        J = fsum(ecoords[:, None, :, :, None]
                 * dN_geo[None, :, :, None, :], 2)
        invJ, det = _inv_and_det(J)                   # [NE, Q, d, d]
        # gphys[e, q, n, d] = sum_m dN[q, n, m] invJ[e, q, m, d]
        gphys = fsum(dN[None, :, :, :, None] * invJ[:, :, None, :, :], 3)
        adet = det.abs()
    # xq[e, q, d] = sum_n phi_geo[q, n] x[e, n, d]
    xq = fsum(phi_geo[None, :, :, None] * ecoords[:, None, :, :], 2)
    return gphys, adet, xq


def _expand_phi(phi, nc):
    """Scalar values [Q, ns] -> vector values [Q, ns*nc, nc] (phi_n * e_c,
    node-major, component-minor)."""
    ns = phi.shape[1]
    eye = torch.eye(nc, dtype=phi.dtype, device=phi.device)
    return (phi[:, :, None, None] * eye[None, None]).reshape(
        phi.shape[0], ns * nc, nc)


def _expand_vector_basis(phi, gphys, nc):
    """Scalar basis tables -> vector basis tables (node-major, comp-minor).

    values:  [Q, ns] -> [Q, ns*nc, nc]      (phi_n * e_c)
    grads:   [NE, Q, ns, d] -> [NE, Q, ns*nc, nc, d]
    """
    ns = phi.shape[1]
    eye = torch.eye(nc, dtype=phi.dtype, device=phi.device)
    vphi = _expand_phi(phi, nc)
    vg = gphys[:, :, :, None, None, :] * eye[None, None, None, :, :, None]
    vg = vg.reshape(gphys.shape[0], gphys.shape[1], ns * nc, nc,
                    gphys.shape[3])
    return vphi, vg


def _chunks(n: int, chunk: int):
    return [slice(s, min(s + chunk, n)) for s in range(0, n, chunk)] or [
        slice(0, 0)]


@dataclasses.dataclass
class WeakForm:
    """A variational problem a(u, v) = L(v) on a function space.

    ``device`` is where ``assemble`` evaluates (the card unless the caller
    passes "cpu"); ``element_matrices`` / ``element_vectors`` evaluate on
    the device of the coordinates they are given.
    """

    space: FunctionSpace
    quadrature: Optional[QuadratureRule] = None
    dtype: object = torch.float64
    device: object = "cuda"

    def __post_init__(self):
        if self.quadrature is None:
            cell = self.space.mesh.cell_type
            deg = 5 if cell == "triangle" else 3
            self.quadrature = rule_for_cell(cell, deg)
        self.lhs_expr: Optional[Expr] = None
        self.rhs_expr: Optional[Expr] = None
        self.bnd_lhs_expr: Optional[Expr] = None
        self.bnd_rhs_expr: Optional[Expr] = None
        self.bnd_quadrature: Optional[QuadratureRule] = None
        self.bnd_mask = None

    def build(self, lhs: Optional[Callable] = None,
              rhs: Optional[Callable] = None) -> "WeakForm":
        u = TrialFunction(self.space)
        v = TestFunction(self.space)
        if lhs is not None:
            self.lhs_expr = lhs(u, v)
        if rhs is not None:
            self.rhs_expr = rhs(v)
        return self

    def build_boundary(self, lhs: Optional[Callable] = None,
                       rhs: Optional[Callable] = None, *,
                       where: Optional[Callable] = None) -> "WeakForm":
        """Add boundary (ds) terms: ``lhs(u, v)`` Robin-type bilinear
        terms, ``rhs(v)`` Neumann loads / tractions.

        ``where``: an optional facet filter, a callable on the facet-center
        coordinates (numpy [NF, d]) -> bool mask, restricting the integral
        to part of the boundary (e.g. ``lambda x: x[:, 0] > 1 - 1e-9``).
        Gradients of trial / test functions are not available on facets
        (FacetNormal, values and spatial coefficients are).
        """
        u = TrialFunction(self.space)
        v = TestFunction(self.space)
        if lhs is not None:
            self.bnd_lhs_expr = lhs(u, v)
        if rhs is not None:
            self.bnd_rhs_expr = rhs(v)
        self.bnd_mask = where
        return self

    # -- element kernels -----------------------------------------------------

    def _context(self, ecoords, conn, *, bind_trial, bind_test):
        space = self.space
        rule = self.quadrature
        phi, dN = _basis_tables(space, rule, self.dtype, ecoords.device)
        gphys, adet, xq = _geometry(ecoords, dN, space, rule, self.dtype)
        nc = space.num_components
        if nc == 1:
            bphi, bg = phi, gphys          # [Q, ns], [NE, Q, ns, d]
        else:
            bphi, bg = _expand_vector_basis(phi, gphys, nc)

        kw = {}
        # leading layout [A(trial), B(test), NE, Q] + value shape; linear
        # forms leave A = 1
        if bind_trial:
            kw["trial_value"] = torch.movedim(bphi, 1, 0)[:, None, None]
            kw["trial_grad"] = torch.movedim(bg, 2, 0)[:, None]
        if bind_test:
            kw["test_value"] = torch.movedim(bphi, 1, 0)[None, :, None]
            kw["test_grad"] = torch.movedim(bg, 2, 0)[None]
        ctx = EvalContext(xq=xq, dtype=self.dtype, phi=phi, gphys=gphys,
                          dof_conn=conn, **kw)
        return ctx, adet, space.local_dofs

    def _coords(self, ecoords):
        if not isinstance(ecoords, torch.Tensor):
            ecoords = torch.as_tensor(ecoords, device=self.device)
        return ecoords.to(self.dtype)

    def _evaluate(self, expr, ecoords, bilinear):
        """sum_q expr * w_q |detJ| per element, over chunks of
        ``chunk_elements`` elements: [NE, nd, nd] (bilinear) or [NE, nd]."""
        ecoords = self._coords(ecoords)
        ne = ecoords.shape[0]
        conn_all = torch.as_tensor(self.space.scalar_dof_conn,
                                   device=ecoords.device).long()
        w = _table(self.quadrature.weights, self.dtype, ecoords.device)
        q = w.shape[0]
        chunk = chunk_elements(self.space, self.quadrature, self.dtype)
        parts = []
        for sl in _chunks(ne, chunk):
            ec = ecoords[sl]
            ctx, adet, nd = self._context(ec, conn_all[sl],
                                          bind_trial=bilinear,
                                          bind_test=True)
            res = expr.evaluate(ctx)
            n = ec.shape[0]
            if bilinear:
                res = res.expand(nd, nd, n, q)
                # Ke[e, i(test)=b, j(trial)=a] = sum_q res[a, b, e, q] w[q]
                # |detJ|[e, q]
                Ke = fsum(res * (w[None, :] * adet)[None, None], -1)
                parts.append(Ke.permute(2, 1, 0))
            else:
                res = res.expand(1, nd, n, q)[0]
                be = fsum(res * (w[None, :] * adet)[None], -1)   # [B, NE]
                parts.append(be.T)
        return torch.cat(parts).contiguous()

    def element_matrices(self, ecoords):
        """Ke [NE, nd, nd] with Ke[e, i(test), j(trial)] = a(phi_j, phi_i)."""
        if self.lhs_expr is None:
            raise ValueError("build() a lhs first")
        return self._evaluate(self.lhs_expr, ecoords, True)

    def element_vectors(self, ecoords):
        """be [NE, nd] with be[e, i] = L(phi_i)."""
        if self.rhs_expr is None:
            raise ValueError("build() a rhs first")
        return self._evaluate(self.rhs_expr, ecoords, False)

    # -- boundary (facet) kernels -------------------------------------------

    def _facet_setup(self):
        """Host precompute: facets, scalar facet DOFs, geometry, basis."""
        space = self.space
        mesh = space.mesh
        facets = boundary_facets(mesh)
        if self.bnd_mask is not None:
            centers = np.asarray(mesh.coords)[facets.conn].mean(axis=1)
            keep = np.asarray(self.bnd_mask(centers), bool)
            facets = BoundaryFacets(facets.conn[keep],
                                    facets.opposite[keep], facets.cell_type)
        rule = self.bnd_quadrature
        if rule is None:
            rule = rule_for_cell(facets.cell_type,
                                 min(2 * space.degree + 1, 5))
        fdofs = facet_dof_conn(space, facets)            # [NF, nfd]
        xq, detS, normal = facet_geometry(mesh.coords, facets, rule)
        fel = element_for_cell(facets.cell_type, space.degree)
        phi_f = fel.shape_values(rule.points)            # [Q, nfd]
        return facets, fdofs, rule, xq, detS, normal, phi_f

    def _facet_context(self, setup, *, bind_trial, bind_test):
        _, fdofs, rule, xq, detS, normal, phi_f = setup
        dt, dev = self.dtype, self.device
        phi = _table(phi_f, dt, dev)
        nc = self.space.num_components
        bphi = phi if nc == 1 else _expand_phi(phi, nc)
        kw = {}
        if bind_trial:
            kw["trial_value"] = torch.movedim(bphi, 1, 0)[:, None, None]
        if bind_test:
            kw["test_value"] = torch.movedim(bphi, 1, 0)[None, :, None]
        ctx = EvalContext(
            xq=_table(xq, dt, dev), dtype=dt, phi=phi,
            dof_conn=torch.as_tensor(fdofs, device=dev).long(),
            normal=_table(normal, dt, dev)[None, None, :, None, :], **kw)
        nfd = phi.shape[1] * nc
        return ctx, _table(detS, dt, dev), _table(rule.weights, dt, dev), nfd

    def boundary_element_matrices(self, setup=None):
        """Kf [NF, nfd, nfd] of the boundary bilinear term (Robin etc.)."""
        if self.bnd_lhs_expr is None:
            raise ValueError("build_boundary() a lhs first")
        setup = setup or self._facet_setup()
        ctx, detS, w, nfd = self._facet_context(setup, bind_trial=True,
                                                bind_test=True)
        res = self.bnd_lhs_expr.evaluate(ctx)
        nf, q = detS.shape[0], w.shape[0]
        res = res.expand(nfd, nfd, nf, q)
        Kf = fsum(res * w[None, None, None, :], -1)
        return (Kf * detS[None, None, :]).permute(2, 1, 0).contiguous()

    def boundary_element_vectors(self, setup=None):
        """bf [NF, nfd] of the boundary load (Neumann flux / traction)."""
        if self.bnd_rhs_expr is None:
            raise ValueError("build_boundary() a rhs first")
        setup = setup or self._facet_setup()
        ctx, detS, w, nfd = self._facet_context(setup, bind_trial=False,
                                                bind_test=True)
        res = self.bnd_rhs_expr.evaluate(ctx)
        nf, q = detS.shape[0], w.shape[0]
        res = res.expand(1, nfd, nf, q)[0]
        bf = fsum(res * w[None, None, :], -1)
        return (bf * detS[None, :]).T.contiguous()

    def _expanded_facet_dofs(self, fdofs):
        nc = self.space.num_components
        if nc == 1:
            return fdofs
        base = fdofs.astype(np.int64) * nc
        return (base[:, :, None] + np.arange(nc, dtype=np.int64)
                ).reshape(base.shape[0], -1).astype(np.int32)

    # -- assembly ------------------------------------------------------------

    def assemble(self, format: str = "ell", pattern=None, pad_to=None):
        """Assemble (A, b) on ``self.device``.  format in {"dense", "ell",
        "stencil"}; "stencil" (P1 scalar spaces on structured meshes) runs
        the shift-invariant assembly into the StencilMatrix of
        ``structured_plan(mesh)`` (node order, not embedded), the storage
        that ``solve.bc.apply_dirichlet_stencil`` takes.  Boundary terms
        (``build_boundary``) are added into the same storage."""
        from tpufem_torch.mesh.adjacency import ell_pattern, slots_for_conn

        if format not in ("dense", "ell", "stencil"):
            raise ValueError(f"unknown format {format!r}")
        space = self.space
        if format == "stencil":
            if getattr(space.mesh, "structured", None) is None:
                raise ValueError("format='stencil' needs a structured mesh "
                                 "(rectangle_mesh / box_mesh)")
            if space.degree != 1 or space.num_components != 1:
                raise ValueError("format='stencil' supports P1 scalar "
                                 "spaces; use 'ell' otherwise")
        ecoords = torch.as_tensor(space.mesh.element_coords(),
                                  dtype=self.dtype, device=self.device)
        Ke = self.element_matrices(ecoords)
        b = None
        if self.rhs_expr is not None:
            be = self.element_vectors(ecoords)
            b = assemble_vector(space.dof_conn, be, space.num_dofs)

        setup = fdofs_exp = Kf = None
        if self.bnd_rhs_expr is not None or self.bnd_lhs_expr is not None:
            setup = self._facet_setup()
            fdofs_exp = self._expanded_facet_dofs(setup[1])
        if self.bnd_rhs_expr is not None:
            bf = self.boundary_element_vectors(setup)
            b_bnd = assemble_vector(fdofs_exp, bf, space.num_dofs)
            b = b_bnd if b is None else b + b_bnd
        if self.bnd_lhs_expr is not None:
            Kf = self.boundary_element_matrices(setup)

        if format == "dense":
            A = assemble_dense(space.dof_conn, Ke, space.num_dofs)
            if Kf is not None:
                A = A + assemble_dense(fdofs_exp, Kf, space.num_dofs)
            return A, b
        if format == "stencil":
            A = assemble_stencil_structured(structured_plan(space.mesh), Ke)
            if Kf is not None:
                nn = space.num_dofs
                offsets = np.asarray(A.offsets, np.int64)
                rows = fdofs_exp[:, :, None].astype(np.int64)
                cols = fdofs_exp[:, None, :].astype(np.int64)
                ent = (cols - rows).reshape(-1)
                k = np.searchsorted(offsets, ent)
                if not np.array_equal(
                        offsets[np.minimum(k, offsets.size - 1)], ent):
                    raise RuntimeError("boundary entry outside the stencil")
                row_flat = np.broadcast_to(
                    rows, np.broadcast_shapes(rows.shape, cols.shape)
                ).reshape(-1)
                A = StencilMatrix(_add_slots(A.data, k * nn + row_flat, Kf),
                                  A.offsets)
            return A, b
        if pattern is None:
            if pad_to is None:
                pad_to = 8 if space.mesh.dim == 2 else 16
            pattern = ell_pattern(space.dof_conn, space.num_dofs,
                                  pad_to=pad_to, with_sort_plan=False)
        A = assemble_ell(pattern, Ke)
        if Kf is not None:
            slots = slots_for_conn(pattern, fdofs_exp).reshape(-1)
            A = ELLMatrix(data=_add_slots(A.data, slots, Kf), cols=A.cols,
                          row_lengths=A.row_lengths, diag_pos=A.diag_pos)
        return A, b


def _add_slots(data: torch.Tensor, slots, values: torch.Tensor):
    """data with values added at the flat slots: a sorted accumulating
    scatter (``index_put_(accumulate=True)``), the same sums from run to
    run on every device."""
    idx = torch.as_tensor(slots, device=data.device).reshape(-1).long()
    return data.reshape(-1).clone().index_put_(
        (idx,), values.reshape(-1), accumulate=True).reshape(data.shape)


def integrate(space: FunctionSpace, expr: Expr, *, quadrature=None,
              dtype=torch.float64, device="cuda"):
    """∫_Ω expr dx for an expression without trial/test functions (e.g. the
    L2 error of a Function against an exact Coefficient); a 0-d tensor."""
    cell = space.mesh.cell_type
    rule = quadrature or rule_for_cell(cell, 5 if cell == "triangle" else 3)
    wf = WeakForm(space, quadrature=rule, dtype=dtype, device=device)
    ecoords = torch.as_tensor(space.mesh.element_coords(), dtype=dtype,
                              device=device)
    conn = torch.as_tensor(space.scalar_dof_conn, device=device).long()
    ctx, adet, _ = wf._context(ecoords, conn, bind_trial=False,
                               bind_test=False)
    w = _table(rule.weights, dtype, device)
    res = expr.evaluate(ctx).expand(ecoords.shape[0], w.shape[0])
    return (res * w[None, :] * adet).sum()


def integrate_boundary(space: FunctionSpace, expr: Expr, *, quadrature=None,
                       where=None, dtype=torch.float64, device="cuda"):
    """∫_Γ expr ds over the (optionally filtered) boundary, e.g. the total
    flux ``integrate_boundary(V, dot(grad_of_exact, n))``, a surface area
    or a traction resultant; a 0-d tensor.  ``expr`` may use FacetNormal,
    Functions (by value), SpatialCoordinate and Coefficients; not
    grad(u / v)."""
    wf = WeakForm(space, dtype=dtype, device=device)
    wf.bnd_quadrature = quadrature
    wf.bnd_mask = where
    setup = wf._facet_setup()
    ctx, detS, w, _ = wf._facet_context(setup, bind_trial=False,
                                        bind_test=False)
    res = expr.evaluate(ctx)
    nf, q = detS.shape[0], w.shape[0]
    res = res.expand(1, 1, nf, q)[0, 0]
    return (fsum(res * w[None, :], 1) * detS).sum()
