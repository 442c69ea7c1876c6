"""MINRES: tpufem_torch.solve.minres against the JAX package's on the CPU,
fp64.

The systems are tests/test_stokes.py's (an indefinite dense matrix, an SPD
one with a Jacobi preconditioner), made from numpy seeds; both packages get
the same arrays.  The port copies the recurrence term for term, so the step
counts are equal (``check_every`` batches included), the flags are equal
and the iterates agree to rounding.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpufem.solve.minres import minres as j_minres

from tpufem_torch.solve.minres import MinresResult, minres

torch.set_num_threads(1)


def _sym_indefinite(n, seed=0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.concatenate([np.linspace(1.0, 10.0, n - n // 3),
                          -np.linspace(1.0, 4.0, n // 3)])
    return (Q * lam) @ Q.T


def _spd(n, seed=2):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    return M @ M.T + n * np.eye(n)


def _both(A, b, *, d=None, **kw):
    """(reference result, port result) for A x = b, with the diagonal
    preconditioner r -> d * r when ``d`` is given."""
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    Mj = None if d is None else (lambda r, dj=jnp.asarray(d): dj * r)
    Mt = None if d is None else (lambda r, dt=torch.as_tensor(d): dt * r)
    ref = j_minres(lambda x: Aj @ x, jnp.asarray(b), M=Mj, **kw)
    res = minres(lambda x: At @ x, torch.as_tensor(b), M=Mt, **kw)
    return ref, res


def _assert_same(ref, res, tol, atol=1e-10):
    assert isinstance(res, MinresResult)
    assert res.iterations == int(ref.iterations)
    assert res.converged == bool(ref.converged)
    assert res.diverged == bool(ref.diverged)
    x_ref = np.asarray(ref.x)
    assert np.abs(res.x.numpy() - x_ref).max() <= atol * max(
        np.abs(x_ref).max(), 1.0)
    # past convergence the estimate is rounding: agree to a tenth of tol
    np.testing.assert_allclose(res.residual_norm.item(),
                               float(ref.residual_norm), rtol=1e-6,
                               atol=0.1 * tol)


@pytest.mark.parametrize("check_every", [1, 4])
@pytest.mark.parametrize("case", ["indefinite", "spd_jacobi"])
def test_minres_matches_jax(case, check_every):
    if case == "indefinite":
        A = _sym_indefinite(60)
        b = np.random.default_rng(1).standard_normal(60)
        d, tol, maxiter = None, 1e-12, 400
    else:
        A = _spd(80)
        b = np.random.default_rng(2).standard_normal(80)
        d, tol, maxiter = 1.0 / np.diag(A), 1e-12, 300
    ref, res = _both(A, b, d=d, tol=tol, maxiter=maxiter,
                     check_every=check_every)
    assert res.converged and not res.diverged
    _assert_same(ref, res, tol)
    if check_every > 1:
        assert res.iterations % check_every == 0
    np.testing.assert_allclose(res.x.numpy(), np.linalg.solve(A, b),
                               rtol=1e-8, atol=1e-8)


def test_check_every_batches_agree():
    """tests/test_stokes.py's batching case: 1 against 4 steps a check."""
    A = _sym_indefinite(40, seed=3)
    b = np.random.default_rng(4).standard_normal(40)
    r1 = _both(A, b, tol=1e-10, maxiter=300)[1]
    r4 = _both(A, b, tol=1e-10, maxiter=300, check_every=4)[1]
    assert r1.converged and r4.converged
    assert r4.iterations >= r1.iterations
    np.testing.assert_allclose(r1.x.numpy(), r4.x.numpy(), rtol=1e-7,
                               atol=1e-7)


@pytest.mark.parametrize("check_every", [1, 3])
def test_non_spd_preconditioner_diverges_at_the_same_step(check_every):
    """An indefinite 'preconditioner' makes beta^2 negative: both flag it
    at the same step and keep the same last finite iterate."""
    A = _spd(30, seed=5)
    b = np.random.default_rng(6).standard_normal(30)
    d = np.where(np.arange(30) % 2 == 0, 1.0, -0.5) / np.diag(A)
    ref, res = _both(A, b, d=d, tol=1e-12, maxiter=200,
                     check_every=check_every)
    assert res.diverged and not res.converged
    _assert_same(ref, res, 1e-12)
    assert np.isfinite(res.x.numpy()).all()


@pytest.mark.parametrize("check_every", [1, 4])
def test_nan_operator_diverges_at_the_same_step(check_every):
    """An operator that turns NaN at the third Lanczos vector (the first
    whose e_0 component lies in (0, 0.05)): the step that sees it is
    flagged and x stays the last finite iterate."""
    A = _sym_indefinite(24, seed=7)
    b = np.random.default_rng(8).standard_normal(24)
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    poison = np.zeros(24)
    poison[5] = np.nan

    def jmv(x):
        # a pure function of x, as the reference's while_loop needs
        hit = (jnp.abs(x[0]) > 0) & (jnp.abs(x[0]) < 0.05)
        return Aj @ x + jnp.where(hit, jnp.asarray(poison), 0.0)

    def tmv(x):
        hit = (x[0].abs() > 0) & (x[0].abs() < 0.05)
        return At @ x + torch.where(hit, torch.as_tensor(poison), 0.0)

    kw = dict(tol=1e-12, maxiter=100, check_every=check_every)
    ref = j_minres(jmv, jnp.asarray(b), **kw)
    res = minres(tmv, torch.as_tensor(b), **kw)
    assert bool(ref.diverged)
    assert res.diverged and not res.converged
    assert res.iterations == int(ref.iterations) == 3
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-12)
    assert np.isfinite(res.x.numpy()).all()


@pytest.mark.parametrize("check_every, maxiter", [(1, 7), (4, 7), (4, 8)])
def test_maxiter_stops_at_the_same_count(check_every, maxiter):
    """maxiter is tested between batches: a count past it by up to
    check_every - 1, as the reference's while_loop gives."""
    A = _sym_indefinite(50, seed=9)
    b = np.random.default_rng(10).standard_normal(50)
    ref, res = _both(A, b, tol=1e-14, maxiter=maxiter,
                     check_every=check_every)
    assert not res.converged and not res.diverged
    _assert_same(ref, res, 1e-14)
    assert res.iterations == -(-maxiter // check_every) * check_every


def test_zero_rhs_and_x0():
    """b = 0: beta1 = 0, no step runs, x = 0, converged (the guarded
    divisions); a given x0 is the start of the recurrence."""
    A = _sym_indefinite(20, seed=11)
    ref, res = _both(A, np.zeros(20), tol=1e-10, maxiter=50)
    assert res.iterations == int(ref.iterations) == 0
    assert res.converged == bool(ref.converged)
    assert not res.x.abs().any()
    _assert_same(ref, res, 1e-10)
    b = np.random.default_rng(12).standard_normal(20)
    x0 = np.random.default_rng(13).standard_normal(20)
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    ref = j_minres(lambda x: Aj @ x, jnp.asarray(b), jnp.asarray(x0),
                   tol=1e-10, maxiter=200, check_every=2)
    res = minres(lambda x: At @ x, torch.as_tensor(b), torch.as_tensor(x0),
                 tol=1e-10, maxiter=200, check_every=2)
    _assert_same(ref, res, 1e-10)
