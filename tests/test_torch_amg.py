"""Port parity, scalar smoothed-aggregation AMG (tpufem_torch.solve.amg)
against the JAX package's tpufem.solve.amg, float64 on the CPU: given the
same RCM-ordered P1 system, build_amg gives the same hierarchy (every
level's operator, transfers, emb, inv_diag, lmax, interval scales,
coarse_inv and the operator complexity exactly equal) for greedy and
interval aggregation, banded and gather transfers, V and W cycles and a
strength filter; one JAX-built hierarchy carried across (convert.py)
gives the same cycle within 1e-12 relative; apply_multi equals column-wise
apply within 1e-13; the cycle is SPD; solve_poisson_ell(precond="amg")
takes the JAX package's fp64 iteration count."""
import functools

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

from tpufem.solve import amg as jamg
from tpufem.solve.poisson import solve_poisson_ell as jax_solve_ell
from tpufem.sparse.ell import ELLMatrix as JaxELLMatrix

from tpufem_torch.assemble.ell import assemble_ell
from tpufem_torch.assemble.local import p1_stiffness
from tpufem_torch.convert import amg_hierarchy_from_numpy, ell_from_numpy
from tpufem_torch.fem.elements import P1Triangle
from tpufem_torch.mesh.adjacency import ell_pattern, reverse_cuthill_mckee
from tpufem_torch.mesh.rectangle import perturbed_rectangle_mesh
from tpufem_torch.solve import amg
from tpufem_torch.solve.bc import apply_dirichlet_ell
from tpufem_torch.solve.poisson import solve_poisson_ell
from tpufem_torch.sparse.ell import reorder_ell

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """One BLAS thread a test, as one torch thread: numpy's OpenBLAS
    threads spin against the other workers on the shared CPU (a 729 x 729
    inverse takes seconds on eight, 0.07 s on one)."""
    with threadpool_limits(1, user_api="blas"):
        yield


@pytest.fixture(autouse=True)
def jax_gather(monkeypatch):
    """The JAX package's own switch: its ELLMatrix products take the XLA
    gather instead of the interpreted Pallas kernel on the CPU."""
    monkeypatch.setenv("TPUFEM_BAND_DISPATCH", "0")


@functools.lru_cache(maxsize=None)
def _system(n=20):
    """The RCM-ordered, Dirichlet-eliminated P1 operator of the perturbed
    n x n square (the JAX package's amg_systems.p1_system), assembled by
    the port: (data, cols) numpy."""
    mesh = perturbed_rectangle_mesh(-3, 3, -3, 3, n, n, jitter=0.25, seed=0)
    pat = ell_pattern(mesh.conn, mesh.num_nodes, pad_to=8)
    A = assemble_ell(pat, p1_stiffness(
        torch.as_tensor(mesh.element_coords()), P1Triangle()))
    A, _ = apply_dirichlet_ell(A, torch.zeros(mesh.num_nodes,
                                              dtype=torch.float64),
                               torch.as_tensor(mesh.node_flags != 0))
    return reorder_ell(A.data, A.cols,
                       reverse_cuthill_mckee(A.cols.numpy()))


def _systems(n=20):
    data, cols = _system(n)
    return (JaxELLMatrix(jnp.asarray(data), jnp.asarray(cols)),
            ell_from_numpy(data, cols), None)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


_MATRICES = ("A", "Qp", "Qr", "Rop", "Pop")
_ARRAYS = ("inv_diag", "p_data", "p_cols", "r_data", "r_cols", "tv", "emb")


def _assert_same_hierarchy(hj, ht):
    assert len(hj.levels) == len(ht.levels) >= 1
    for lj, lt in zip(hj.levels, ht.levels):
        for name in _MATRICES:
            mj, mt = getattr(lj, name), getattr(lt, name)
            assert (mj is None) == (mt is None), name
            if mj is not None:
                np.testing.assert_array_equal(_np(mt.data), _np(mj.data))
                np.testing.assert_array_equal(_np(mt.cols), _np(mj.cols))
        for name in _ARRAYS:
            aj, at = getattr(lj, name), getattr(lt, name)
            assert (aj is None) == (at is None), name
            if aj is not None:
                np.testing.assert_array_equal(_np(at), _np(aj))
        assert (lt.lmax, lt.s, lt.omega) == (lj.lmax, lj.s, lj.omega)
    np.testing.assert_array_equal(_np(ht.coarse_inv), _np(hj.coarse_inv))
    assert ht.operator_complexity == hj.operator_complexity
    assert (ht.gamma, ht.smoother_degree, ht.smoother_ratio) == (
        hj.gamma, hj.smoother_degree, hj.smoother_ratio)


_CASES = [dict(), dict(strength=0.08), dict(cycle="W"),
          dict(transfer="gather"), dict(transfer="gather", cycle="W"),
          dict(aggregation="interval"),
          dict(aggregation="interval", cycle="W"),
          dict(strength=0.08, smoother_degree=3)]


@pytest.mark.parametrize("kw", _CASES, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()) or "default")
def test_same_hierarchy(kw):
    """The same float64 matrix gives the same hierarchy in both packages
    (the cycles on it: ``test_carried_hierarchy_same_cycle``)."""
    Aj, At, _ = _systems()
    _assert_same_hierarchy(jamg.build_amg(Aj, coarse_n=60, **kw),
                           amg.build_amg(At, coarse_n=60, **kw))


def _carried(hj):
    """A JAX hierarchy's arrays, as the dicts convert.py takes."""
    levels = []
    for lv in hj.levels:
        d = {}
        for name in lv._fields:
            v = getattr(lv, name)
            if v is None or isinstance(v, (int, float)):
                d[name] = v
            elif hasattr(v, "cols"):
                d[name] = (np.asarray(v.data), np.asarray(v.cols))
            else:
                d[name] = np.asarray(v)
        levels.append(d)
    return amg_hierarchy_from_numpy(
        levels, np.asarray(hj.coarse_inv),
        smoother_degree=hj.smoother_degree,
        smoother_ratio=hj.smoother_ratio,
        operator_complexity=hj.operator_complexity, gamma=hj.gamma)


@pytest.mark.parametrize("kw", [dict(strength=0.08),
                                dict(aggregation="interval", cycle="W"),
                                dict(transfer="gather", cycle="W")],
                         ids=["greedy", "interval-W", "gather-W"])
def test_carried_hierarchy_same_cycle(kw):
    """One JAX-built hierarchy, carried across: both packages' cycles
    agree within 1e-12 relative, and its multi-RHS cycle (q = 3) equals
    the column-wise apply within 1e-13."""
    Aj, _, _ = _systems()
    hj = jamg.build_amg(Aj, coarse_n=60, **kw)
    ht = _carried(hj)
    R = np.random.default_rng(1).standard_normal((Aj.shape[0], 3))
    Zj = np.asarray(jax.jit(hj.apply_multi)(jnp.asarray(R)))
    Zc = np.stack([ht.apply(torch.as_tensor(R[:, q])).numpy()
                   for q in range(3)], axis=1)
    assert np.abs(Zc - Zj).max() <= 1e-12 * np.abs(Zj).max()
    Z = ht.apply_multi(torch.as_tensor(R)).numpy()
    assert np.abs(Z - Zc).max() <= 1e-13 * np.abs(Zc).max()


def test_numpy_setup_gives_the_same_operators():
    """native_setup=False (the numpy specification of aggregation and the
    Galerkin product) builds the same hierarchy: equal level sizes and
    transfers, coarse operators equal as dense matrices within 1e-12."""
    _, At, _ = _systems()
    hn = amg.build_amg(At, coarse_n=60, strength=0.08)
    hs = amg.build_amg(At, coarse_n=60, strength=0.08, native_setup=False)
    assert len(hn.levels) == len(hs.levels) >= 2
    for ln, ls in zip(hn.levels[1:], hs.levels[1:]):
        Dn, Ds = ln.A.to_dense().numpy(), ls.A.to_dense().numpy()
        assert np.abs(Dn - Ds).max() <= 1e-12 * np.abs(Ds).max()
    for ln, ls in zip(hn.levels, hs.levels):
        np.testing.assert_array_equal(ln.emb.numpy(), ls.emb.numpy())
    np.testing.assert_allclose(hs.coarse_inv.numpy(), hn.coarse_inv.numpy(),
                               rtol=0, atol=1e-10 * float(
                                   hn.coarse_inv.abs().max()))


def test_cycle_is_spd_and_walls():
    _, At, _ = _systems()
    walls = {}
    h = amg.build_amg(At, coarse_n=60, walls_out=walls)
    assert len(h.levels) >= 1
    n = At.shape[0]
    M = h.apply_multi(torch.eye(n, dtype=torch.float64)).numpy()
    assert np.abs(M - M.T).max() <= 1e-10 * np.abs(M).max()
    assert np.linalg.eigvalsh(0.5 * (M + M.T)).min() > 0
    assert {"aggregate", "smooth_p", "galerkin", "plans", "transfers",
            "coarse_inv"} <= set(walls)
    assert walls["coarse_rows"] == h.coarse_inv.shape[0]
    assert walls["gather"] == []            # the CPU primes nothing


def test_solve_poisson_ell_amg_matches_the_reference():
    """The fp64 PCG count and solution of solve_poisson_ell(precond="amg")
    (RCM path, greedy strength-0.08 V-cycle) equal the JAX package's."""
    from tpufem.mesh.rectangle import perturbed_rectangle_mesh as jax_mesh

    kw = dict(jitter=0.2, seed=3)
    ref = jax_solve_ell(jax_mesh(-3, 3, -3, 3, 40, 40, **kw), tol=1e-10,
                        precond="amg")
    sol = solve_poisson_ell(perturbed_rectangle_mesh(-3, 3, -3, 3, 40, 40,
                                                     **kw),
                            tol=1e-10, precond="amg", device="cpu")
    assert sol.cg.converged and bool(ref.cg.converged)
    assert sol.cg.iterations == int(ref.cg.iterations)
    u_ref = np.asarray(ref.u)
    assert np.abs(sol.u.numpy() - u_ref).max() <= 1e-10 * np.abs(u_ref).max()


def test_sym_dense_inv_matches_on_a_near_singular_matrix():
    """The reference's fault, matched: on a near-singular SPSD matrix
    Cholesky succeeds and the inverse is amplified (here past 1e10); the
    port returns the JAX package's array bit for bit."""
    rng = np.random.default_rng(4)
    V = rng.standard_normal((40, 39))
    dense = V @ V.T + 1e-13 * np.eye(40)      # rank 39 + a tiny shift
    ours, ref = amg.sym_dense_inv(dense), jamg.sym_dense_inv(dense)
    np.testing.assert_array_equal(ours, ref)
    assert np.abs(ours).max() > 1e10


def test_cpu_hierarchy_launches_no_kernel():
    """On CPU tensors the hierarchy's products run the plain versions: no
    kernel's launch count moves (B9, B9g, B10)."""
    from tpufem_torch.sparse import ell_cuda

    counters = (ell_cuda.ell_matvec_cuda, ell_cuda.ell_gather_matvec_cuda,
                ell_cuda.ell_matvec_multi_cuda,
                ell_cuda.ell_gather_matvec_multi_cuda)
    before = [fn.launches for fn in counters]
    _, At, _ = _systems()
    for kw in (dict(strength=0.08), dict(transfer="gather"),
               dict(aggregation="interval")):
        h = amg.build_amg(At, coarse_n=60, **kw)
        h.apply(torch.ones(At.shape[0], dtype=torch.float64))
        h.apply_multi(torch.ones((At.shape[0], 2), dtype=torch.float64))
    assert [fn.launches for fn in counters] == before
