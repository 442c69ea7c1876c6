"""The reference model problem, as in tpufem.solve.poisson.

-Δu = f on (-3,3)³ with u = 0 on the boundary and manufactured solution
u = Π(9 - x_d²).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

__all__ = ["RhsFunction", "model_problem_3d", "model_problem_3d_planes"]


@dataclasses.dataclass(frozen=True)
class RhsFunction:
    """An RHS coefficient f(x, y, z) on coordinate planes, in two forms.

    ``fn`` is a PyTorch (or numpy) callable, used by the plain versions;
    ``c_expr`` is the same function as a C expression of ``x, y, z`` of the
    kernel's floating type ``T`` (write literals as ``T(9)``), compiled into
    the fused-build kernel.  Without ``c_expr`` only the plain path runs.
    """

    fn: Callable
    c_expr: Optional[str] = None

    def __call__(self, x, y, z):
        return self.fn(x, y, z)


def model_problem_3d():
    """(f, exact) on points x [..., 3]."""

    def exact(x):
        return ((9.0 - x[..., 0] ** 2) * (9.0 - x[..., 1] ** 2)
                * (9.0 - x[..., 2] ** 2))

    def f(x):
        x0, x1, x2 = x[..., 0], x[..., 1], x[..., 2]
        return 2.0 * ((9.0 - x1 ** 2) * (9.0 - x2 ** 2)
                      + (9.0 - x0 ** 2) * (9.0 - x2 ** 2)
                      + (9.0 - x0 ** 2) * (9.0 - x1 ** 2))

    return f, exact


def model_problem_3d_planes() -> RhsFunction:
    """Plane form of the 3D RHS, with its C expression."""

    def f(x, y, z):
        return 2.0 * ((9.0 - y * y) * (9.0 - z * z)
                      + (9.0 - x * x) * (9.0 - z * z)
                      + (9.0 - x * x) * (9.0 - y * y))

    return RhsFunction(
        f, "T(2) * ((T(9) - y * y) * (T(9) - z * z)"
           " + (T(9) - x * x) * (T(9) - z * z)"
           " + (T(9) - x * x) * (T(9) - y * y))")
