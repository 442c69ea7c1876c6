"""Function spaces: the DOF layout over a mesh, as in tpufem.fem.space.

Ported: the scalar P1 Lagrange space, whose DOFs are the mesh nodes.
Degree 2 and vector-valued spaces are not ported yet and raise.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from tpufem_torch.fem.elements import element_for_cell
from tpufem_torch.fem.quadrature import QuadratureRule, rule_for_cell
from tpufem_torch.mesh.core import Mesh

__all__ = ["FunctionSpace"]


@dataclasses.dataclass
class FunctionSpace:
    """Scalar P1 Lagrange space on a mesh (DOF = node index)."""

    mesh: Mesh
    family: str = "Lagrange"
    degree: int = 1
    num_components: int = 1

    def __post_init__(self):
        if self.family not in ("Lagrange", "P", "CG"):
            raise NotImplementedError(f"family {self.family!r}")
        if self.degree != 1 or self.num_components != 1:
            raise NotImplementedError(
                f"degree {self.degree} with {self.num_components} "
                "components: the port has the scalar P1 space")
        self.element = element_for_cell(self.mesh.cell_type, self.degree)
        mesh = self.mesh
        self.scalar_dof_conn = mesh.conn.copy()
        self.num_scalar_dofs = mesh.num_nodes
        self.scalar_dof_flags = mesh.node_flags != 0
        self.scalar_dof_coords = mesh.coords.copy()
        self.dof_conn = self.scalar_dof_conn
        self.num_dofs = self.num_scalar_dofs
        self.dof_flags = self.scalar_dof_flags

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
