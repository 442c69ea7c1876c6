"""Symbolic weak-form engine (SymPy), as in tpufem.forms.symbolic.

The pipeline of the reference's symbolic frontend:

  user lambdas over symbolic shape functions
    -> custom 8-argument functions sfR / sfS with the chain-rule
       derivatives dr/dx = (y2-y3)/jac, dr/dy = (x3-x2)/jac,
       ds/dx = (y3-y1)/jac, ds/dy = (x1-x3)/jac
    -> substitute sfR -> r, sfS -> s, x -> fx(r, s), y -> fy(r, s),
       multiply by the signed jac
    -> print source into a kernel template, compile it at run time,
       launch.

The reference's JAX package prints jax.numpy source and jits it; the port
prints PyTorch source, ``compile`` execs it and returns the plain function
(no ``torch.compile`` and no CUDA code generation): it is the host-side
check of the traced frontend (``forms.weakform``), not a device path.
SymPy is an optional dependency (the ``symbolic`` extra): neither the
package root nor the device paths import this module.

The reference multiplies by the signed Jacobian; the traced path uses
|det J|.  ``element_matrices_signed`` keeps the signed semantics for the
parity checks, ``element_matrices`` applies |.|.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import sympy as sp

__all__ = ["SymbolicFunctionSpace", "SymbolicWeakForm", "sym_grad", "sym_dot"]


# -- custom shape-function symbols with GiNaC-style chain rules --------------

class sfR(sp.Function):
    """r(x, y; x1..y3), held unevaluated, with the reference's derivative
    rule."""

    nargs = 8

    def fdiff(self, argindex=1):
        x, y, x1, x2, x3, y1, y2, y3 = self.args
        jac = (x1 - x3) * (y2 - y3) - (y1 - y3) * (x2 - x3)
        if argindex == 1:      # d/dx
            return (y2 - y3) / jac
        if argindex == 2:      # d/dy
            return (x3 - x2) / jac
        return sp.S.Zero


class sfS(sp.Function):
    """s(x, y; x1..y3), with the reference's derivative rule."""

    nargs = 8

    def fdiff(self, argindex=1):
        x, y, x1, x2, x3, y1, y2, y3 = self.args
        jac = (x1 - x3) * (y2 - y3) - (y1 - y3) * (x2 - x3)
        if argindex == 1:
            return (y3 - y1) / jac
        if argindex == 2:
            return (x1 - x3) / jac
        return sp.S.Zero


def sym_grad(f, x, y):
    """The gradient (d/dx, d/dy) of a symbolic expression."""
    return (sp.diff(f, x), sp.diff(f, y))


def sym_dot(l, r):
    """The dot product of two symbolic vectors."""
    return sum(a * b for a, b in zip(l, r))


class SymbolicFunctionSpace:
    """The P1 triangle's symbols: coordinates, reference coordinates,
    vertex coordinates, the shape functions and the affine map."""

    def __init__(self):
        self.x, self.y = sp.symbols("x y")
        self.r, self.s = sp.symbols("r s")
        self.x1, self.x2, self.x3 = sp.symbols("x1 x2 x3")
        self.y1, self.y2, self.y3 = sp.symbols("y1 y2 y3")
        self.sfr = sfR(self.x, self.y, self.x1, self.x2, self.x3,
                       self.y1, self.y2, self.y3)
        self.sfs = sfS(self.x, self.y, self.x1, self.x2, self.x3,
                       self.y1, self.y2, self.y3)
        # the affine map
        self.fx = (self.x1 * self.r + self.x2 * self.s
                   + self.x3 * (1 - self.r - self.s))
        self.fy = (self.y1 * self.r + self.y2 * self.s
                   + self.y3 * (1 - self.r - self.s))

    def shape_functions(self):
        """(sfr, sfs, 1 - sfr - sfs)."""
        return (self.sfr, self.sfs, 1 - self.sfr - self.sfs)

    def jacobian(self):
        """The signed jac = fx_r * fy_s - fy_r * fx_s."""
        fx, fy, r, s = self.fx, self.fy, self.r, self.s
        return sp.expand(sp.diff(fx, r) * sp.diff(fy, s)
                         - sp.diff(fy, r) * sp.diff(fx, s))


# -- the kernel template: placeholders are substituted with generated
# source, the string is compiled at run time and the function returned.
# ``_math`` takes the printer's ``math.*`` calls onto torch (numbers become
# float64 tensors first).
_KERNEL_TEMPLATE = '''\
import math

import torch


class _Math:
    def __getattr__(self, name):
        if hasattr(math, name) and not callable(getattr(math, name)):
            return getattr(math, name)
        fn = getattr(torch, name)

        def call(*args):
            return fn(*[a if isinstance(a, torch.Tensor)
                        else torch.tensor(float(a), dtype=torch.float64)
                        for a in args])

        return call


_math = _Math()


def fea_kernel(X, Y, R, S, W):
    """Generated element kernel: X, Y [NE, 3]; R, S, W [Q] -> (Ke, be)."""
    x1, x2, x3 = X[:, 0:1], X[:, 1:2], X[:, 2:3]
    y1, y2, y3 = Y[:, 0:1], Y[:, 1:2], Y[:, 2:3]
    r, s = R[None, :], S[None, :]
    integrands = [
        $INTEGRANDS$
    ]
    rhs = [
        $RHS$
    ]
    Ke = torch.stack([(term * W[None, :]).sum(1) for term in integrands],
                     dim=1).reshape(-1, 3, 3)
    be = torch.stack([(term * W[None, :]).sum(1) for term in rhs], dim=1)
    return Ke, be
'''


def _pycode(expr, broadcast_syms) -> str:
    """SymPy expression -> torch source, broadcast to [NE, Q] even where
    the expression is independent of r, s."""
    code = sp.printing.pycode(expr)
    code = code.replace("math.", "_math.")
    return f"({code}) * torch.ones_like(x1 * r)"


@dataclasses.dataclass
class SymbolicWeakForm:
    """The symbolic weak form: ``build()`` runs the symbolic pipeline,
    ``get_c_code()`` dumps the integrands as C source, ``get_code()``
    returns the kernel source and ``compile()`` compiles it at run time."""

    space: Optional[SymbolicFunctionSpace] = None

    def __post_init__(self):
        self.space = self.space or SymbolicFunctionSpace()
        self.lhs = None   # 3x3 nested list of sympy expressions (x1.., r, s)
        self.rhs = None   # list of 3

    def build(self, lhs_fn: Callable, rhs_fn: Optional[Callable] = None):
        """lhs_fn(u, v) and rhs_fn(v) over the symbolic shape functions:
        differentiate (the custom chain rule fires), substitute sfR -> r,
        sfS -> s, then x -> fx, y -> fy, multiply by the signed jac."""
        fs = self.space
        sfuncs = fs.shape_functions()
        jac = fs.jacobian()
        subs1 = {fs.sfr: fs.r, fs.sfs: fs.s}
        subs2 = {fs.x: fs.fx, fs.y: fs.fy}

        def pipeline(e):
            return sp.together(e.subs(subs1).subs(subs2) * jac)

        self.lhs = [[pipeline(lhs_fn(sfuncs[j], sfuncs[i]))
                     for i in range(3)] for j in range(3)]
        if rhs_fn is not None:
            self.rhs = [pipeline(rhs_fn(sfuncs[j])) for j in range(3)]
        return self

    # -- code generation -----------------------------------------------------

    def get_c_code(self) -> str:
        """C-source dump of all integrands (sympy ccode), the reference's
        print format."""
        lines = []
        for j in range(3):
            for i in range(3):
                lines.append(sp.ccode(self.lhs[j][i]))
            if self.rhs is not None:
                lines.append(sp.ccode(self.rhs[j]))
        return "\n".join(lines)

    def get_code(self) -> str:
        """The run-time-compilable torch kernel source (the template with
        its placeholders replaced)."""
        integrands = []
        for j in range(3):
            for i in range(3):
                # kernel entry (j*3+i) computes lhs[j][i]; row / col follow
                # the reference (li = idx / 3, lj = idx % 3)
                integrands.append(_pycode(self.lhs[j][i], None))
        rhs_exprs = self.rhs or [sp.S.Zero] * 3
        rhs = [_pycode(e, None) for e in rhs_exprs]
        src = _KERNEL_TEMPLATE.replace(
            "$INTEGRANDS$", ",\n        ".join(integrands))
        src = src.replace("$RHS$", ",\n        ".join(rhs))
        return src

    def compile(self):
        """Compile the generated source at run time (exec) and return the
        plain function fea_kernel(X, Y, R, S, W) -> (Ke [NE, 3, 3],
        be [NE, 3]) on torch tensors; Ke has the reference's signed-jac
        semantics."""
        namespace: dict = {}
        exec(compile(self.get_code(), "<tpufem_torch-generated-kernel>",
                     "exec"), namespace)
        return namespace["fea_kernel"]

    # -- direct numeric evaluation (for parity tests) ------------------------

    def _lambdify(self, exprs):
        fs = self.space
        args = (fs.x1, fs.x2, fs.x3, fs.y1, fs.y2, fs.y3, fs.r, fs.s)
        return [sp.lambdify(args, e, modules="numpy") for e in exprs]

    def element_matrices_signed(self, X, Y, rule) -> np.ndarray:
        """Quadrature-reduced local matrices with the signed jac: what the
        reference's generated kernel computes."""
        fns = self._lambdify([self.lhs[j][i] for j in range(3)
                              for i in range(3)])
        r, s = rule.points[:, 0], rule.points[:, 1]
        w = rule.weights
        ne = X.shape[0]
        Ke = np.zeros((ne, 3, 3))
        for idx, fn in enumerate(fns):
            li, lj = divmod(idx, 3)
            vals = fn(X[:, 0:1], X[:, 1:2], X[:, 2:3],
                      Y[:, 0:1], Y[:, 1:2], Y[:, 2:3],
                      r[None, :], s[None, :])
            vals = np.broadcast_to(vals, (ne, len(w)))
            Ke[:, li, lj] = vals @ w
        return Ke

    def element_matrices(self, X, Y, rule) -> np.ndarray:
        """The |det J| semantics (the mathematically correct target)."""
        Ke = self.element_matrices_signed(X, Y, rule)
        jac = ((X[:, 0] - X[:, 2]) * (Y[:, 1] - Y[:, 2])
               - (Y[:, 0] - Y[:, 2]) * (X[:, 1] - X[:, 2]))
        return Ke * np.sign(jac)[:, None, None]

    def element_vectors_signed(self, X, Y, rule) -> np.ndarray:
        fns = self._lambdify(self.rhs)
        r, s = rule.points[:, 0], rule.points[:, 1]
        w = rule.weights
        ne = X.shape[0]
        be = np.zeros((ne, 3))
        for j, fn in enumerate(fns):
            vals = fn(X[:, 0:1], X[:, 1:2], X[:, 2:3],
                      Y[:, 0:1], Y[:, 1:2], Y[:, 2:3],
                      r[None, :], s[None, :])
            vals = np.broadcast_to(vals, (ne, len(w)))
            be[:, j] = vals @ w
        return be
