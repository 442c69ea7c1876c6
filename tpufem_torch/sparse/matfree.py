"""Matrix-free operators: apply A without forming it, as in
tpufem.sparse.matfree.

Each product gathers the local DOFs per element, applies the local
operator and adds the element results back into the nodes:

  * ``element_operator`` -- stored local matrices Ke [NE, n, n];
  * ``poisson_operator`` -- the P1 Poisson factored form
                            y_e = G (G^T x_e) vol (n*d + 1 values an
                            element), or fully on the fly from the
                            coordinates (nothing stored beyond the mesh).

The reference adds the element results with an unordered scatter
(``.at[].add``).  Here the node sums follow a plan built once, when the
operator is made: every node's incident (element, local node) entries in
element order, padded to the largest valence with an entry that reads 0.
A product is then one gather and a left-to-right sum over the valence
(``fsum``): no atomics and no sort per product, the same bits from run to
run on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from tpufem_torch.assemble.local import affine_geometry
from tpufem_torch.fem.elements import ReferenceElement
from tpufem_torch.forms.language import fsum

__all__ = ["element_operator", "poisson_operator"]

_REF_VOLUME = {"triangle": 0.5, "tetrahedron": 1.0 / 6.0}


def _node_sum_plan(dof_conn, num_dofs: int, device=None) -> torch.Tensor:
    """[num_dofs, V] int64 positions into an element result flattened to
    [NE * n] and extended by one zero: row i lists, in element order, the
    positions of the entries that add into node i, padded with NE * n (the
    zero)."""
    conn = np.asarray(dof_conn, np.int64).reshape(-1)
    order = np.argsort(conn, kind="stable")
    counts = np.bincount(conn, minlength=num_dofs)
    width = max(int(counts.max()) if counts.size else 0, 1)
    start = np.zeros(num_dofs + 1, dtype=np.int64)
    np.cumsum(counts, out=start[1:])
    node = conn[order]
    slot = np.arange(conn.size, dtype=np.int64) - start[node]
    plan = np.full((num_dofs, width), conn.size, dtype=np.int64)
    plan[node, slot] = order
    return torch.as_tensor(plan, device=device)


def _node_sum(ye: torch.Tensor, plan: torch.Tensor) -> torch.Tensor:
    """y[i] = sum of the element entries of node i, in element order."""
    flat = torch.cat([ye.reshape(-1), ye.new_zeros(1)])
    return fsum(flat[plan], 1)


def element_operator(dof_conn, Ke: torch.Tensor, num_dofs: int):
    """matvec from stored local matrices: gather -> batched local product
    -> node sums (on Ke's device)."""
    conn = torch.as_tensor(dof_conn, device=Ke.device).long()
    plan = _node_sum_plan(dof_conn, num_dofs, Ke.device)

    def matvec(x):
        xe = x[conn]                                   # [NE, n]
        ye = fsum(Ke * xe[:, None, :], 2)
        return _node_sum(ye, plan)

    return matvec


def poisson_operator(ecoords: torch.Tensor, dof_conn, num_dofs: int,
                     element: ReferenceElement, *, on_the_fly: bool = False):
    """P1 Poisson matrix-free matvec (on ecoords' device).

    The factored product y_e = G_e (G_e^T x_e) vol_e never forms Ke; with
    ``on_the_fly=True`` even G is recomputed from the coordinates inside
    each product (about twice the operations for the least memory
    traffic).
    """
    ecoords = torch.as_tensor(ecoords)
    conn = torch.as_tensor(dof_conn, device=ecoords.device).long()
    plan = _node_sum_plan(dof_conn, num_dofs, ecoords.device)
    refvol = _REF_VOLUME[element.cell_type]

    if on_the_fly:
        def matvec(x):
            G, adet = affine_geometry(ecoords, element)
            vol = adet * refvol
            xe = x[conn]
            t = fsum(G * xe[:, :, None], 1) * vol[:, None]
            ye = fsum(G * t[:, None, :], 2)
            return _node_sum(ye, plan)

        return matvec

    G, adet = affine_geometry(ecoords, element)
    # fold the volume into G once: K_e = (G sqrt(v)) (G sqrt(v))^T
    Gs = G * torch.sqrt(adet * refvol)[:, None, None]

    def matvec(x):
        xe = x[conn]
        t = fsum(Gs * xe[:, :, None], 1)
        ye = fsum(Gs * t[:, None, :], 2)
        return _node_sum(ye, plan)

    return matvec
