"""The reference model problems, as in tpufem.solve.poisson.

-Δu = f on (-3,3)^dim with u = 0 on the boundary and manufactured solution
u = Π(9 - x_d²): in 2D f = 36 - 2(x² + y²), the reference's own problem;
in 3D its separable analogue.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

__all__ = ["RhsFunction", "model_problem_2d", "model_problem_2d_planes",
           "model_problem_3d", "model_problem_3d_planes"]


@dataclasses.dataclass(frozen=True)
class RhsFunction:
    """An RHS coefficient f(x, y[, z]) on coordinate planes, in two forms.

    ``fn`` is a PyTorch (or numpy) callable, used by the plain versions;
    ``c_expr`` is the same function as a C expression of ``x, y`` (and
    ``z`` in 3D) of the kernel's floating type ``T`` (write literals as
    ``T(9)``), compiled into the fused-build kernel.  Without ``c_expr``
    only the plain path runs.
    """

    fn: Callable
    c_expr: Optional[str] = None

    def __call__(self, *planes):
        return self.fn(*planes)


def model_problem_2d():
    """(f, exact) on points x [..., 2]."""

    def f(x):
        return 36.0 - 2.0 * (x[..., 0] ** 2 + x[..., 1] ** 2)

    def exact(x):
        return (9.0 - x[..., 0] ** 2) * (9.0 - x[..., 1] ** 2)

    return f, exact


def model_problem_2d_planes() -> RhsFunction:
    """Plane form of the 2D RHS, with its C expression."""

    def f(x, y):
        return 36.0 - 2.0 * (x * x + y * y)

    return RhsFunction(f, "T(36) - T(2) * (x * x + y * y)")


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
