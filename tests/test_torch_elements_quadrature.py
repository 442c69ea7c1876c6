"""Port parity, the reference elements and quadrature rules of the weak-form
frontend: tpufem_torch.fem.elements and fem.quadrature against the JAX
package's (host numpy on both sides).  Every element's tables and every
rule's points and weights are equal bit for bit; the Duffy rule of the
tetrahedron (degree >= 4) integrates monomials exactly."""
import math

import numpy as np
import pytest

from tpufem.fem import elements as jel
from tpufem.fem import quadrature as jq

from tpufem_torch.fem import elements as tel
from tpufem_torch.fem import quadrature as tq

_CELLS = [("segment", 1), ("segment", 2), ("triangle", 1), ("triangle", 2),
          ("tetrahedron", 1), ("tetrahedron", 2), ("quad", 1),
          ("hexahedron", 1)]


def _rules_equal(a, b):
    np.testing.assert_array_equal(a.points, b.points)
    np.testing.assert_array_equal(a.weights, b.weights)
    assert (a.degree, a.cell_type) == (b.degree, b.cell_type)


@pytest.mark.parametrize("cell,degree", _CELLS,
                         ids=[f"{c}-{d}" for c, d in _CELLS])
def test_element_tables_equal_jax(cell, degree):
    el, ref = (tel.element_for_cell(cell, degree),
               jel.element_for_cell(cell, degree))
    assert type(el).__name__ == type(ref).__name__
    assert isinstance(el, tel.ReferenceElement)
    for field in ("name", "cell_type", "dim", "num_nodes", "degree"):
        assert getattr(el, field) == getattr(ref, field), field
    dim = el.dim
    for deg in (1, 3, 5):
        pts = jq.rule_for_cell(cell, deg).points
        np.testing.assert_array_equal(el.shape_values(pts),
                                      ref.shape_values(pts))
        np.testing.assert_array_equal(el.shape_grads(pts),
                                      ref.shape_grads(pts))
        # partition of unity, and gradients summing to zero
        np.testing.assert_allclose(el.shape_values(pts).sum(1), 1.0,
                                   atol=1e-13)
        assert el.shape_grads(pts).shape == (pts.shape[0], el.num_nodes,
                                             dim)
        np.testing.assert_allclose(el.shape_grads(pts).sum(1), 0.0,
                                   atol=1e-12)
    assert tel.is_affine_cell(cell) == jel.is_affine_cell(cell)


def test_unknown_elements_raise_as_jax():
    for cell, degree in (("quad", 2), ("hexahedron", 2), ("triangle", 3)):
        with pytest.raises(NotImplementedError):
            jel.element_for_cell(cell, degree)
        with pytest.raises(NotImplementedError):
            tel.element_for_cell(cell, degree)
    assert tel.__all__ == jel.__all__


@pytest.mark.parametrize("cell", ["segment", "triangle", "tetrahedron",
                                  "quad", "hexahedron"])
def test_rules_equal_jax(cell):
    for deg in range(1, 8 if cell != "triangle" else 6):
        _rules_equal(tq.rule_for_cell(cell, deg), jq.rule_for_cell(cell, deg))
    with pytest.raises(ValueError):
        tq.rule_for_cell("pyramid", 2)
    for name in ("segment_rule", "quad_rule", "hexahedron_rule",
                 "tetrahedron_rule"):
        _rules_equal(getattr(tq, name)(4), getattr(jq, name)(4))


@pytest.mark.parametrize("degree", [4, 5, 6])
def test_duffy_tetrahedron_rule_is_exact(degree):
    """int_T r^a s^b t^c = a! b! c! / (a + b + c + 3)! for a + b + c <=
    degree; the rule has ((degree + 4) // 2)^3 points (64 at degree 4)."""
    rule = tq.tetrahedron_rule(degree)
    n1 = (degree + 4) // 2
    assert rule.num_points == n1 ** 3 and rule.degree == degree
    r, s, t = rule.points.T
    assert (rule.barycentric() >= 0).all()
    for a in range(degree + 1):
        for b in range(degree + 1 - a):
            for c in range(degree + 1 - a - b):
                exact = (math.factorial(a) * math.factorial(b)
                         * math.factorial(c)
                         / math.factorial(a + b + c + 3))
                got = float((rule.weights * r ** a * s ** b * t ** c).sum())
                assert abs(got - exact) <= 1e-14, (a, b, c)


def test_tensor_and_segment_rules_integrate_exactly():
    for deg in (1, 3, 5):
        seg = tq.segment_rule(deg)
        for a in range(seg.degree + 1):
            assert abs((seg.weights * seg.points[:, 0] ** a).sum()
                       - 1 / (a + 1)) < 1e-14
        hexr = tq.hexahedron_rule(deg)
        p = hexr.points
        for a in range(hexr.degree + 1):
            got = (hexr.weights * p[:, 0] ** a * p[:, 1] * p[:, 2] ** a).sum()
            assert abs(got - 0.5 / (a + 1) ** 2) < 1e-14
    assert tq.quad_rule(5).num_points == 9
    assert tq.hexahedron_rule(3).num_points == 8
