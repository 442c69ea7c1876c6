"""Port parity, block smoothed-aggregation AMG for elasticity
(tpufem_torch.solve.amg_block) against the JAX package's
tpufem.solve.amg_block, float64 on the CPU: the rigid body modes equal;
given the same BCSR matrix, build_block_amg gives the same hierarchy
(every level's operator, Qp / Qr or gather transfers, emb, inv_diag,
lmax, coarse_inv, the operator complexity: exactly equal) in 2D (b = 2,
m = 3), in 3D (b = 3, m = 6), on the rank-deficient p = 5 case and with
translations only; one JAX-built hierarchy carried across (convert.py)
gives the same cycle within 1e-12 relative; the cycle is SPD.  The
solves are in test_torch_amg_solve.py."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpufem.solve import amg_block as jblk
from tpufem.sparse.bcsr import BCSRMatrix as JaxBCSR

from tpufem_torch.convert import bcsr_from_numpy, \
    block_amg_hierarchy_from_numpy
from tpufem_torch.fem.space import VectorFunctionSpace
from tpufem_torch.mesh.adjacency import ell_pattern
from tpufem_torch.mesh.box import box_mesh
from tpufem_torch.mesh.rectangle import perturbed_rectangle_mesh
from tpufem_torch.solve import amg_block
from tpufem_torch.solve.elasticity import elasticity_forms
from tpufem_torch.sparse.bcsr import apply_dirichlet_bcsr, assemble_bcsr

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def jax_gather(monkeypatch):
    """The JAX package's own switch: its products take XLA's gather
    instead of the interpreted Pallas kernel on the CPU."""
    monkeypatch.setenv("TPUFEM_BAND_DISPATCH", "0")


_MESHES = {2: lambda m: m(-1, 1, -1, 1, 20, 20, jitter=0.2, seed=0),
           3: lambda m: m(-1, 1, -1, 1, -1, 1, 6, 6, 6)}


def _port_mesh(dim):
    return _MESHES[dim](perturbed_rectangle_mesh if dim == 2 else box_mesh)


@functools.lru_cache(maxsize=None)
def _system(dim):
    """The Dirichlet-eliminated elasticity operator (lam = mu = 1) on the
    perturbed 20 x 20 square or the 6^3 box, assembled by the port:
    (data [ns, K, b, b], cols [ns, K], coords) numpy."""
    mesh = _port_mesh(dim)
    V = VectorFunctionSpace(mesh, degree=1)
    wf = elasticity_forms(V, 1.0, 1.0)
    wf.device = "cpu"
    Ke = wf.element_matrices(torch.as_tensor(mesh.element_coords()))
    pat = ell_pattern(V.scalar_dof_conn, V.num_scalar_dofs,
                      pad_to=8 if dim == 2 else 16)
    A = assemble_bcsr(pat, Ke, dim)
    A, _ = apply_dirichlet_bcsr(
        A, torch.zeros(V.num_dofs, dtype=torch.float64), V.dof_flags)
    return A.data.numpy(), A.cols.numpy(), mesh.coords


def _pair(dim):
    data, cols, coords = _system(dim)
    return (JaxBCSR(jnp.asarray(data), jnp.asarray(cols)),
            bcsr_from_numpy(data, cols), coords)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same_hierarchy(hj, ht):
    assert len(hj.levels) == len(ht.levels) >= 1
    for lj, lt in zip(hj.levels, ht.levels):
        for name in ("A", "Qp", "Qr"):
            mj, mt = getattr(lj, name), getattr(lt, name)
            assert (mj is None) == (mt is None), name
            if mj is not None:
                np.testing.assert_array_equal(_np(mt.data), _np(mj.data))
                np.testing.assert_array_equal(_np(mt.cols), _np(mj.cols))
        for name in ("inv_diag", "p_data", "p_cols", "r_data", "r_cols",
                     "emb"):
            aj, at = getattr(lj, name), getattr(lt, name)
            assert (aj is None) == (at is None), name
            if aj is not None:
                np.testing.assert_array_equal(_np(at), _np(aj))
        assert (lt.lmax, lt.m) == (lj.lmax, lj.m)
    np.testing.assert_array_equal(_np(ht.coarse_inv), _np(hj.coarse_inv))
    assert ht.operator_complexity == hj.operator_complexity
    assert ht.gamma == hj.gamma


def _near_null(dim, case, coords):
    if case == "translations":
        return None
    B = jblk.rigid_body_modes(coords)
    if case == "p5":
        # m = 5 > 2 b: every small aggregate takes the rank-deficient path
        rng = np.random.default_rng(0)
        B = np.hstack([B, rng.standard_normal((B.shape[0], 2))])
    return B


_CASES = [(2, "rbm", {}), (2, "rbm", dict(cycle="W")),
          (2, "rbm", dict(transfer="gather")), (2, "translations", {}),
          (2, "p5", dict(coarse_n=60)), (3, "rbm", {}),
          (3, "rbm", dict(transfer="gather", cycle="W"))]


@pytest.mark.parametrize("dim,case,kw", _CASES,
                         ids=[f"{d}d-{c}-" + "-".join(
                             f"{k}={v}" for k, v in kw.items())
                             for d, c, kw in _CASES])
def test_same_hierarchy(dim, case, kw):
    Aj, At, coords = _pair(dim)
    B = _near_null(dim, case, coords)
    hj = jblk.build_block_amg(Aj, B=B, **kw)
    ht = amg_block.build_block_amg(At, B=B, **kw)
    _assert_same_hierarchy(hj, ht)
    if case == "p5":
        assert ht.levels[0].m == 5 and ht.levels[0].Qp.block_size == 5
    if case == "rbm" and kw.get("transfer") != "gather":
        assert ht.levels[0].Qp.block_size == max(dim, 3 * (dim - 1))


def test_rigid_body_modes():
    for dim in (2, 3):
        coords = _system(dim)[2]
        np.testing.assert_array_equal(amg_block.rigid_body_modes(coords),
                                      jblk.rigid_body_modes(coords))


def _carried(hj):
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
    return block_amg_hierarchy_from_numpy(
        levels, np.asarray(hj.coarse_inv),
        smoother_degree=hj.smoother_degree,
        smoother_ratio=hj.smoother_ratio,
        operator_complexity=hj.operator_complexity, gamma=hj.gamma)


@pytest.mark.parametrize("dim,case,kw", [
    (2, "rbm", {}), (3, "rbm", {}), (2, "p5", dict(coarse_n=60)),
    (2, "rbm", dict(transfer="gather", cycle="W"))],
    ids=["2d", "3d", "p5", "2d-gather-W"])
def test_carried_hierarchy_same_cycle(dim, case, kw):
    """One JAX-built hierarchy, carried across: both packages' cycles
    agree within 1e-12 relative."""
    Aj, _, coords = _pair(dim)
    hj = jblk.build_block_amg(Aj, B=_near_null(dim, case, coords), **kw)
    ht = _carried(hj)
    r = np.random.default_rng(2).standard_normal(Aj.shape[0])
    zj = np.asarray(jax.jit(hj.apply)(jnp.asarray(r)))
    zt = ht.apply(torch.as_tensor(r)).numpy()
    assert np.abs(zt - zj).max() <= 1e-12 * np.abs(zj).max()


def test_numpy_setup_and_spd():
    """native_setup=False (the numpy blocked products) gives the same
    hierarchy, its coarse operators equal as dense matrices within 1e-12;
    the cycle is symmetric (1e-10) and positive definite on 40 random
    vectors."""
    _, At, coords = _pair(2)
    walls = {}
    hn = amg_block.build_block_amg(At, coords=coords, walls_out=walls)
    hs = amg_block.build_block_amg(At, coords=coords, native_setup=False)
    assert len(hn.levels) == len(hs.levels) >= 1
    for ln, ls in zip(hn.levels[1:], hs.levels[1:]):
        Dn, Ds = ln.A.to_dense().numpy(), ls.A.to_dense().numpy()
        assert np.abs(Dn - Ds).max() <= 1e-12 * np.abs(Ds).max()
    assert {"diag_lmax", "aggregate", "tentative", "smooth_p", "galerkin",
            "plans", "transfers", "coarse_inv"} <= set(walls)
    assert walls["gather"] == []
    # the cycle on 40 random vectors: X^T M X symmetric and PD
    X = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (40, At.shape[0])))
    G = (X @ torch.stack([hn.apply(x) for x in X], dim=1)).numpy()
    assert np.abs(G - G.T).max() <= 1e-10 * np.abs(G).max()
    assert np.linalg.eigvalsh(0.5 * (G + G.T)).min() > 0


def test_unguarded_retry_matches(monkeypatch):
    """The reference's fault, matched: with strength 0 the degraded-
    coarsening retry (no `strength > 0` guard) still runs, here on a
    system of decoupled 2 x 2 blocks (every node a singleton), and the
    hierarchy equals the JAX package's."""
    rng = np.random.default_rng(5)
    ns = 400
    G = rng.standard_normal((ns, 2, 2))
    data = (G @ np.swapaxes(G, 1, 2) + 2 * np.eye(2))[:, None]
    cols = np.arange(ns, dtype=np.int32)[:, None]
    calls = []
    inner = amg_block.greedy_aggregate

    def counting(c, **kw):
        calls.append(c.shape[0])
        return inner(c, **kw)

    monkeypatch.setattr(amg_block, "greedy_aggregate", counting)
    kw = dict(coarse_n=60, strength=0.0)
    ht = amg_block.build_block_amg(bcsr_from_numpy(data, cols), **kw)
    assert calls[:2] == [ns, ns]             # the level aggregated twice
    _assert_same_hierarchy(
        jblk.build_block_amg(JaxBCSR(jnp.asarray(data), jnp.asarray(cols)),
                             **kw), ht)
