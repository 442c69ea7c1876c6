"""Weak-form expression language, as in tpufem.forms.language.

The user states a variational form with the reference's algebra
(``dot(grad(u), grad(v))``, ``inner(sigma(u), sym(grad(v)))``, ``f * v``); it
builds a small expression tree that ``forms.weakform`` evaluates eagerly on
torch tensors: trial and test functions bind to batched basis tables,
spatial coordinates to the mapped quadrature points.

Value semantics: every expression evaluates to a tensor broadcastable over
the leading axes [A(trial), B(test), NE, Q] with a trailing *value shape*:
() scalar, (d,) vector or (d, d) tensor.  Contractions (dot, inner, ...)
act on the value shape only.  Every contraction is an explicit
left-to-right sum (``fsum``): torch's own reductions group rows by the
tensor's shape, so their bits would change with the number of elements
evaluated at once.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = [
    "Expr", "Constant", "Coefficient", "TrialFunction", "TestFunction",
    "SpatialCoordinate", "FacetNormal", "grad", "dot", "inner", "div",
    "sym", "tr", "Identity", "outer", "fsum",
]


def fsum(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over one small axis, left to right, as elementwise adds: the
    same bits whatever the sizes of the other axes, on every device."""
    parts = t.unbind(dim)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


class Expr:
    """Base expression node. ``rank`` is the tensor rank of the value."""

    rank: int = 0

    # -- algebra -------------------------------------------------------------
    def __add__(self, other):
        return _Binary(torch.add, self, _wrap(other), "+")

    def __radd__(self, other):
        return _Binary(torch.add, _wrap(other), self, "+")

    def __sub__(self, other):
        return _Binary(torch.sub, self, _wrap(other), "-")

    def __rsub__(self, other):
        return _Binary(torch.sub, _wrap(other), self, "-")

    def __mul__(self, other):
        return _Binary(torch.mul, self, _wrap(other), "*")

    def __rmul__(self, other):
        return _Binary(torch.mul, _wrap(other), self, "*")

    def __truediv__(self, other):
        return _Binary(torch.div, self, _wrap(other), "/")

    def __rtruediv__(self, other):
        return _Binary(torch.div, _wrap(other), self, "/")

    def __pow__(self, p):
        return _Binary(torch.pow, self, _wrap(p), "**")

    def __neg__(self):
        return _Unary(torch.neg, self, "-")

    def __getitem__(self, i):
        return _Component(self, i)

    def evaluate(self, ctx):
        raise NotImplementedError


def _wrap(v):
    if isinstance(v, Expr):
        return v
    return Constant(v)


def _bcast_binop(op, a, b, ra, rb):
    """Apply an elementwise op aligning value shapes on the right."""
    if ra == rb:
        return op(a, b)
    # scalar (op) tensor: expand the scalar's trailing dims
    if ra == 0:
        return op(a[(...,) + (None,) * rb], b)
    if rb == 0:
        return op(a, b[(...,) + (None,) * ra])
    raise ValueError(f"rank mismatch in elementwise op: {ra} vs {rb}")


class _Binary(Expr):
    def __init__(self, op, a, b, sym_):
        self.op, self.a, self.b, self.sym = op, a, b, sym_
        self.rank = max(a.rank, b.rank)
        if a.rank != b.rank and min(a.rank, b.rank) != 0:
            raise ValueError(f"rank mismatch in '{sym_}'")

    def evaluate(self, ctx):
        return _bcast_binop(self.op, self.a.evaluate(ctx),
                            self.b.evaluate(ctx), self.a.rank, self.b.rank)


class _Unary(Expr):
    def __init__(self, op, a, sym_):
        self.op, self.a, self.sym = op, a, sym_
        self.rank = a.rank

    def evaluate(self, ctx):
        return self.op(self.a.evaluate(ctx))


class _Component(Expr):
    def __init__(self, base, index):
        if base.rank < 1:
            raise ValueError("cannot index a scalar expression")
        self.base, self.index = base, index
        self.rank = base.rank - 1

    def evaluate(self, ctx):
        return self.base.evaluate(ctx)[..., self.index]


class Constant(Expr):
    """A number, vector or tensor (Python, numpy or torch) in the form."""

    def __init__(self, value):
        self.value = value
        self.rank = int(np.ndim(value))

    def evaluate(self, ctx):
        return torch.as_tensor(self.value, dtype=ctx.dtype, device=ctx.device)


class Coefficient(Expr):
    """A spatial coefficient f(x): a callable over physical coordinates.

    ``fn`` receives the quadrature points as a torch tensor ``x[..., dim]``
    on the working device and dtype, and returns ``[...]`` (scalar) or
    ``[..., k]`` (vector; set ``rank=1``) torch values.  Evaluation is
    eager, so any torch code works (there is no trace to satisfy).
    """

    def __init__(self, fn: Callable, rank: int = 0):
        self.fn = fn
        self.rank = rank

    def evaluate(self, ctx):
        return self.fn(ctx.xq)


class TrialFunction(Expr):
    """The unknown u. Scalar spaces: rank 0; vector spaces: rank 1."""

    def __init__(self, space):
        self.space = space
        self.rank = 0 if space.num_components == 1 else 1

    def evaluate(self, ctx):
        return ctx.trial_value


class TestFunction(Expr):
    __test__ = False            # not a pytest class

    def __init__(self, space):
        self.space = space
        self.rank = 0 if space.num_components == 1 else 1

    def evaluate(self, ctx):
        return ctx.test_value


class _Coord(Expr):
    rank = 1

    def evaluate(self, ctx):
        return ctx.xq


def SpatialCoordinate(space_or_mesh):  # noqa: N802 (UFL-style name)
    """The physical coordinate vector x; index it for components
    (``x, y = X[0], X[1]``)."""
    return _Coord()


class _Normal(Expr):
    rank = 1

    def evaluate(self, ctx):
        n = getattr(ctx, "normal", None)
        if n is None:
            raise ValueError(
                "FacetNormal is only defined in boundary integrals "
                "(WeakForm.build_boundary / integrate_boundary)")
        return n


def FacetNormal(space_or_mesh):  # noqa: N802 (UFL-style name)
    """The outward unit normal n on the boundary: valid only inside
    boundary forms (``WeakForm.build_boundary``, ``integrate_boundary``)."""
    return _Normal()


class _Grad(Expr):
    def __init__(self, a):
        if isinstance(a, TrialFunction):
            self.kind = "trial"
        elif isinstance(a, TestFunction):
            self.kind = "test"
        elif hasattr(a, "gradient"):
            # discrete Functions (forms.weakform.Function) provide their
            # own gradient evaluation
            self.kind = "custom"
        else:
            raise NotImplementedError(
                "grad() applies to trial/test/discrete functions; spatial "
                "coefficients can supply gradients analytically")
        self.a = a
        self.rank = a.rank + 1

    def evaluate(self, ctx):
        if self.kind == "trial":
            return ctx.trial_grad
        if self.kind == "test":
            return ctx.test_grad
        return self.a.gradient(ctx)


def grad(u) -> Expr:
    """∇u: scalar -> vector [d], vector -> tensor [nc, d] (du_i/dx_j)."""
    return _Grad(u)


class _Dot(Expr):
    def __init__(self, a, b):
        a, b = _wrap(a), _wrap(b)
        if a.rank < 1 or b.rank < 1:
            raise ValueError("dot() needs rank >= 1 operands")
        self.a, self.b = a, b
        self.rank = a.rank + b.rank - 2

    def evaluate(self, ctx):
        va, vb = self.a.evaluate(ctx), self.b.evaluate(ctx)
        if self.a.rank == 1 and self.b.rank == 1:
            return fsum(va * vb, -1)
        if self.a.rank == 2 and self.b.rank == 1:
            return fsum(va * vb[..., None, :], -1)
        if self.a.rank == 1 and self.b.rank == 2:
            return fsum(va[..., :, None] * vb, -2)
        if self.a.rank == 2 and self.b.rank == 2:
            # [..., i, k, 1] * [..., 1, k, j] summed over k
            return fsum(va[..., :, :, None] * vb[..., None, :, :], -2)
        raise NotImplementedError


def dot(a, b) -> Expr:
    """Single-index contraction."""
    return _Dot(a, b)


class _Inner(Expr):
    rank = 0

    def __init__(self, a, b):
        a, b = _wrap(a), _wrap(b)
        if a.rank != b.rank:
            raise ValueError("inner() needs equal-rank operands")
        self.a, self.b = a, b
        self.naxes = a.rank

    def evaluate(self, ctx):
        va, vb = self.a.evaluate(ctx), self.b.evaluate(ctx)
        if self.naxes == 0:
            return va * vb
        # the value axes flattened, summed in row-major order
        return fsum((va * vb).flatten(-self.naxes), -1)


def inner(a, b) -> Expr:
    """Full contraction over the value shape (A : B for tensors)."""
    return _Inner(a, b)


def _trace(v):
    return fsum(torch.diagonal(v, dim1=-2, dim2=-1), -1)


class _Div(Expr):
    rank = 0

    def __init__(self, a):
        self.g = grad(a)
        if self.g.rank != 2:
            raise ValueError("div() needs a vector field")

    def evaluate(self, ctx):
        return _trace(self.g.evaluate(ctx))


def div(u) -> Expr:
    return _Div(u)


class _Sym(Expr):
    def __init__(self, a):
        if a.rank != 2:
            raise ValueError("sym() needs a rank-2 expression")
        self.a = a
        self.rank = 2

    def evaluate(self, ctx):
        v = self.a.evaluate(ctx)
        return 0.5 * (v + v.transpose(-1, -2))


def sym(t) -> Expr:
    return _Sym(t)


class _Tr(Expr):
    rank = 0

    def __init__(self, a):
        if a.rank != 2:
            raise ValueError("tr() needs a rank-2 expression")
        self.a = a

    def evaluate(self, ctx):
        return _trace(self.a.evaluate(ctx))


def tr(t) -> Expr:
    return _Tr(t)


class Identity(Expr):
    rank = 2

    def __init__(self, d: int):
        self.d = d

    def evaluate(self, ctx):
        return torch.eye(self.d, dtype=ctx.dtype, device=ctx.device)


class _Outer(Expr):
    rank = 2

    def __init__(self, a, b):
        a, b = _wrap(a), _wrap(b)
        if a.rank != 1 or b.rank != 1:
            raise ValueError("outer() needs vector operands")
        self.a, self.b = a, b

    def evaluate(self, ctx):
        va, vb = self.a.evaluate(ctx), self.b.evaluate(ctx)
        return va[..., :, None] * vb[..., None, :]


def outer(a, b) -> Expr:
    return _Outer(a, b)
