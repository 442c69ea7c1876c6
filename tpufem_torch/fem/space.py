"""Function spaces: the DOF layout over a mesh, as in tpufem.fem.space.

Ported: P1 Lagrange spaces, scalar (DOF = node index) and vector-valued
(node-major, component-minor: the global DOF of node d, component c is
``d * num_components + c``, which keeps each node's block contiguous, as
the BCSR format wants).  Degree 2 waits for the P2 elements (ROADMAP A3)
and raises.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from tpufem_torch.fem.elements import element_for_cell
from tpufem_torch.fem.quadrature import QuadratureRule, rule_for_cell
from tpufem_torch.mesh.core import Mesh

__all__ = ["FunctionSpace", "VectorFunctionSpace"]


@dataclasses.dataclass
class FunctionSpace:
    """P1 Lagrange space on a mesh, scalar or (``num_components > 1``)
    vector-valued."""

    mesh: Mesh
    family: str = "Lagrange"
    degree: int = 1
    num_components: int = 1

    def __post_init__(self):
        if self.family not in ("Lagrange", "P", "CG"):
            raise NotImplementedError(f"family {self.family!r}")
        if self.degree != 1:
            raise NotImplementedError(
                f"degree {self.degree}: the port has the P1 spaces (P2 "
                "waits for its elements, ROADMAP A3)")
        self.element = element_for_cell(self.mesh.cell_type, self.degree)
        mesh = self.mesh
        self.scalar_dof_conn = mesh.conn.copy()
        self.num_scalar_dofs = mesh.num_nodes
        self.scalar_dof_flags = mesh.node_flags != 0
        self.scalar_dof_coords = mesh.coords.copy()
        nc = self.num_components
        if nc == 1:
            self.dof_conn = self.scalar_dof_conn
            self.num_dofs = self.num_scalar_dofs
            self.dof_flags = self.scalar_dof_flags
        else:
            # node-major, component-minor expansion
            base = self.scalar_dof_conn.astype(np.int64) * nc
            self.dof_conn = (
                base[:, :, None] + np.arange(nc, dtype=np.int64)
            ).reshape(base.shape[0], -1).astype(np.int32)
            self.num_dofs = self.num_scalar_dofs * nc
            self.dof_flags = np.repeat(self.scalar_dof_flags, nc)

    @property
    def local_dofs(self) -> int:
        return self.element.num_nodes * self.num_components

    def default_quadrature(self, extra_degree: int = 0) -> QuadratureRule:
        """Rule exact for the stiffness form of this space's degree (at
        least degree 2 on triangles, capped at 5 on triangles and 3 on
        tetrahedra)."""
        deg = max(1, 2 * self.degree + extra_degree)
        if self.mesh.cell_type == "triangle":
            return rule_for_cell("triangle", min(max(deg, 2), 5))
        return rule_for_cell(self.mesh.cell_type, min(deg, 3))

    def boundary_dofs(self) -> np.ndarray:
        return np.nonzero(self.dof_flags)[0].astype(np.int32)


def VectorFunctionSpace(mesh: Mesh, family: str = "Lagrange", degree: int = 1,
                        num_components: int | None = None) -> FunctionSpace:
    """Vector-valued Lagrange space (default: one component per space
    dimension)."""
    nc = mesh.dim if num_components is None else num_components
    return FunctionSpace(mesh, family=family, degree=degree,
                         num_components=nc)
