"""Port parity, the SymPy weak-form frontend: tpufem_torch.forms.symbolic
against the JAX package's tpufem.forms.symbolic (float64, CPU).  The
symbolic pipeline prints the same C source, string for string; the
generated torch kernel (exec'd source, a plain function) gives the JAX
package's element matrices and vectors at 1e-12 and agrees with the traced
weak form; the signed-Jacobian semantics flip clockwise elements where
|det J| does not.  The module imports SymPy; the package root does not
import the module."""
import numpy as np
import sympy as sp
import torch

import jax.numpy as jnp

from tpufem.forms import symbolic as jsym

from tpufem_torch.assemble.local import element_load, p1_stiffness
from tpufem_torch.fem.elements import P1Triangle
from tpufem_torch.fem.quadrature import triangle_rule
from tpufem_torch.forms import symbolic as tsym
from tpufem_torch.mesh.rectangle import rectangle_mesh

torch.set_num_threads(1)


def _build(mod):
    fs = mod.SymbolicFunctionSpace()
    x, y = fs.x, fs.y
    f = -2 * (x * x + y * y) + 36
    wf = mod.SymbolicWeakForm(fs)
    wf.build(lambda u, v: mod.sym_dot(mod.sym_grad(u, x, y),
                                      mod.sym_grad(v, x, y)),
             lambda v: f * v)
    return wf


def _xy(mesh):
    ec = mesh.element_coords()
    return ec[:, :, 0], ec[:, :, 1]


def _close(a, ref, rtol=1e-12):
    a, ref = np.asarray(a), np.asarray(ref)
    assert a.shape == ref.shape
    assert np.abs(a - ref).max() <= rtol * max(np.abs(ref).max(), 1e-300)


def test_c_code_and_expressions_equal_jax():
    wf, jwf = _build(tsym), _build(jsym)
    assert wf.get_c_code() == jwf.get_c_code()
    assert len(wf.get_c_code().splitlines()) == 12
    for j in range(3):
        assert wf.rhs[j] == jwf.rhs[j]
        for i in range(3):
            assert wf.lhs[j][i] == jwf.lhs[j][i]
    fs = tsym.SymbolicFunctionSpace()
    jac = (fs.x1 - fs.x3) * (fs.y2 - fs.y3) - (fs.y1 - fs.y3) * (fs.x2
                                                                 - fs.x3)
    assert sp.simplify(fs.jacobian() - jac) == 0
    assert sp.simplify(sp.diff(fs.sfr, fs.x) - (fs.y2 - fs.y3) / jac) == 0
    assert sp.simplify(sp.diff(fs.sfs, fs.y) - (fs.x1 - fs.x3) / jac) == 0


def test_generated_torch_kernel_equals_jax():
    wf, jwf = _build(tsym), _build(jsym)
    src = wf.get_code()
    assert "import torch" in src and "jax" not in src
    assert "def fea_kernel" in src and "$INTEGRANDS$" not in src
    kernel = wf.compile()
    assert not isinstance(kernel, torch.nn.Module)
    X, Y = _xy(rectangle_mesh(-3, 3, -3, 3, 4, 4))
    rule = triangle_rule(5)
    args = (X, Y, rule.points[:, 0], rule.points[:, 1], rule.weights)
    Ke, be = kernel(*(torch.as_tensor(a) for a in args))
    jKe, jbe = jwf.compile()(*(jnp.asarray(a) for a in args))
    _close(Ke.numpy(), jKe)
    _close(be.numpy(), jbe)
    _close(Ke.numpy(), wf.element_matrices_signed(X, Y, rule))
    _close(be.numpy(), wf.element_vectors_signed(X, Y, rule))
    # the structured mesh's triangles are counterclockwise: the signed
    # kernel equals the traced P1 kernels
    ec = torch.as_tensor(rectangle_mesh(-3, 3, -3, 3, 4, 4)
                         .element_coords())
    _close(Ke.numpy(), p1_stiffness(ec, P1Triangle()).numpy())
    _close(be.numpy(), element_load(
        ec, P1Triangle(), rule,
        lambda p: 36.0 - 2.0 * (p[..., 0] ** 2 + p[..., 1] ** 2)).numpy())


def test_generated_kernel_takes_math_functions():
    """A form with a transcendental coefficient: the printer's math calls
    run on torch (numbers become tensors)."""
    fs = tsym.SymbolicFunctionSpace()
    wf = tsym.SymbolicWeakForm(fs).build(
        lambda u, v: u * v, lambda v: (sp.sin(fs.x) + sp.sqrt(2)) * v)
    jfs = jsym.SymbolicFunctionSpace()
    jwf = jsym.SymbolicWeakForm(jfs).build(
        lambda u, v: u * v, lambda v: (sp.sin(jfs.x) + sp.sqrt(2)) * v)
    X, Y = _xy(rectangle_mesh(0, 1, 0, 1, 2, 2))
    rule = triangle_rule(5)
    args = (X, Y, rule.points[:, 0], rule.points[:, 1], rule.weights)
    Ke, be = wf.compile()(*(torch.as_tensor(a) for a in args))
    jKe, jbe = jwf.compile()(*(jnp.asarray(a) for a in args))
    _close(Ke.numpy(), jKe)
    _close(be.numpy(), jbe)


def test_signed_versus_abs_on_clockwise_elements():
    wf, jwf = _build(tsym), _build(jsym)
    X, Y = _xy(rectangle_mesh(-3, 3, -3, 3, 2, 2))
    Xf, Yf = X.copy(), Y.copy()
    Xf[0], Yf[0] = X[0, ::-1], Y[0, ::-1]        # element 0 clockwise
    rule = triangle_rule(5)
    K_signed = wf.element_matrices_signed(Xf, Yf, rule)
    K_abs = wf.element_matrices(Xf, Yf, rule)
    np.testing.assert_array_equal(K_signed,
                                  jwf.element_matrices_signed(Xf, Yf, rule))
    np.testing.assert_array_equal(K_abs, jwf.element_matrices(Xf, Yf, rule))
    K_orig = wf.element_matrices_signed(X, Y, rule)
    perm = [2, 1, 0]
    np.testing.assert_allclose(K_signed[0], -K_orig[0][np.ix_(perm, perm)],
                               rtol=1e-12)
    np.testing.assert_allclose(K_abs[0], K_orig[0][np.ix_(perm, perm)],
                               rtol=1e-12)
    # the generated kernel keeps the signed semantics
    args = (Xf, Yf, rule.points[:, 0], rule.points[:, 1], rule.weights)
    Ke, _ = wf.compile()(*(torch.as_tensor(a) for a in args))
    _close(Ke.numpy(), K_signed)
    _close(wf.element_vectors_signed(Xf, Yf, rule),
           jwf.element_vectors_signed(Xf, Yf, rule))
