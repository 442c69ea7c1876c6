"""Port parity, the native host library (tpufem_torch.native, built from
the port's copy of meshgen.cpp): every function against the JAX package's
library (tpufem.native) bit for bit, and against the numpy specification
(bit for bit where the two produce the same layout; the Galerkin products,
whose ELL layouts may order slots differently, as dense operators within
1e-12 relative, the JAX package's own criterion); the use_native policy
(False takes no library, a library that cannot be built raises)."""
import numpy as np
import pytest
import torch

from tpufem import native as jnative

from tpufem_torch import native
from tpufem_torch.mesh import adjacency
from tpufem_torch.mesh.box import box_mesh
from tpufem_torch.mesh.rectangle import (perturbed_rectangle_mesh,
                                         rectangle_mesh)
from tpufem_torch.solve import amg, amg_block

torch.set_num_threads(1)


def _eq(*arrays):
    for a in arrays[1:]:
        np.testing.assert_array_equal(a, arrays[0])


def test_library_builds_into_the_build_dir():
    so = native.build_native()
    assert so.parent == native._BUILD and so.exists()
    assert so.name.startswith("meshgen-") and native.available()


def test_meshes_and_adjacency_match():
    for port, ref, ctor, args in (
            (native.rectangle_mesh, jnative.rectangle_mesh, rectangle_mesh,
             (-3.0, 3.0, -1.0, 2.0, 5, 7)),
            (native.box_mesh, jnative.box_mesh, box_mesh,
             (0, 1, 0, 2, -1, 1, 3, 4, 2))):
        mesh = ctor(*args)
        for a, b, c in zip(port(*args), ref(*args),
                           (mesh.coords, mesh.conn, mesh.node_flags)):
            _eq(c, a, b)
        la, ia = native.node_adjacency(mesh.conn, mesh.num_nodes)
        lj, ij = jnative.node_adjacency(mesh.conn, mesh.num_nodes)
        ln, i_n = adjacency.node_adjacency(mesh.conn, mesh.num_nodes)
        _eq(ln, la, lj)
        _eq(i_n, ia, ij)


def test_ell_pattern_matches():
    mesh = perturbed_rectangle_mesh(-1, 1, -1, 1, 9, 11, jitter=0.2, seed=1)
    pat = adjacency.ell_pattern(mesh.conn, mesh.num_nodes, pad_to=8)
    nnz, cols, diag, slots = native.ell_pattern(mesh.conn, mesh.num_nodes,
                                                8)
    ref = jnative.ell_pattern(mesh.conn, mesh.num_nodes, 8)
    assert nnz == ref[0] == pat.nnz
    for a, b, c in zip((cols, diag, slots), ref[1:],
                       (pat.cols, pat.diag_pos, pat.slots)):
        _eq(c, a, b)
    with pytest.raises(ValueError, match="width"):
        native.ell_pattern(mesh.conn, mesh.num_nodes, 3)


@pytest.mark.parametrize("dim", [2, 3])
def test_ell_pattern2_matches(dim):
    """ell_pattern2 (the row counting sort ``ell_pattern`` takes with
    with_sort_plan=False) against the JAX library and the numpy
    pattern, including its width retry (guess 1)."""
    mesh = (perturbed_rectangle_mesh(-1, 1, -1, 1, 12, 10, jitter=0.2,
                                     seed=2) if dim == 2
            else box_mesh(0, 1, 0, 1, 0, 1, 3, 4, 2))
    pad = 8 if dim == 2 else 16
    spec = adjacency.ell_pattern(mesh.conn, mesh.num_nodes, pad_to=pad)
    fast = adjacency.ell_pattern(mesh.conn, mesh.num_nodes, pad_to=pad,
                                 with_sort_plan=False)
    for f in ("cols", "row_lengths", "diag_pos", "slots"):
        _eq(getattr(spec, f), getattr(fast, f))
    assert fast.nnz == spec.nnz and fast.unique_keys is None
    a = native.ell_pattern2(mesh.conn, mesh.num_nodes, width_guess=1)
    b = jnative.ell_pattern2(mesh.conn, mesh.num_nodes, width_guess=1)
    for x, y in zip(a, b):
        _eq(x, y)
    assert a[0].shape[1] == int(spec.row_lengths.max())


def test_rcm_matches():
    """RCM: the port's library, the JAX library and the numpy version
    give one permutation, also with duplicate columns and isolated nodes
    (disconnected components)."""
    mesh = perturbed_rectangle_mesh(-3, 3, -3, 3, 40, 40, jitter=0.25,
                                    seed=3)
    cols = adjacency.ell_pattern(mesh.conn, mesh.num_nodes, pad_to=8).cols
    rng = np.random.default_rng(0)
    odd = np.clip(np.arange(500)[:, None]
                  + rng.integers(-20, 21, size=(500, 6)),
                  0, 499).astype(np.int32)
    odd[100:105] = np.arange(100, 105)[:, None]
    for c in (cols, odd):
        _eq(adjacency.reverse_cuthill_mckee(c, use_native=False),
            adjacency.reverse_cuthill_mckee(c),
            native.reverse_cuthill_mckee(c),
            jnative.reverse_cuthill_mckee(c))


def test_greedy_aggregate_matches():
    mesh = perturbed_rectangle_mesh(-1, 1, -1, 1, 16, 16, jitter=0.25,
                                    seed=4)
    cols = adjacency.ell_pattern(mesh.conn, mesh.num_nodes, pad_to=8).cols
    agg, na = native.greedy_aggregate(cols)
    jagg, jna = jnative.greedy_aggregate(cols)
    _eq(agg, jagg)
    assert na == jna
    spec, nspec = amg.greedy_aggregate(cols, use_native=False)
    ported, nported = amg.greedy_aggregate(cols)
    _eq(spec, ported)
    assert nspec == nported == na


def _dense(d, c, nrows, ncols):
    out = np.zeros((nrows, ncols))
    np.add.at(out, (np.repeat(np.arange(nrows), d.shape[1]),
                    c.astype(np.int64).ravel()), d.ravel())
    return out


def test_galerkin_ell_matches():
    """A_c = P^T A P: the two libraries bit for bit; the chunked numpy
    product as a dense operator within 1e-12 relative."""
    rng = np.random.default_rng(0)
    mesh = perturbed_rectangle_mesh(-1, 1, -1, 1, 14, 14, jitter=0.25,
                                    seed=1)
    pat = adjacency.ell_pattern(mesh.conn, mesh.num_nodes, pad_to=8)
    n = mesh.num_nodes
    data = np.where(pat.cols != np.arange(n)[:, None],
                    rng.standard_normal(pat.cols.shape), 2.0)
    data[pat.row_lengths[:, None] <= np.arange(pat.cols.shape[1])] = 0.0
    nc, Kp = 40, 3
    p_cols = rng.integers(0, nc, size=(n, Kp)).astype(np.int32)
    p_data = rng.standard_normal((n, Kp))
    p_data[:, 2] = 0.0                       # zero-skipping
    cd, cc = native.galerkin_ell(data, pat.cols, p_data, p_cols, nc)
    jd, jc = jnative.galerkin_ell(data, pat.cols, p_data, p_cols, nc)
    _eq(cd, jd)
    _eq(cc, jc)
    cr, c2, cv = amg._spmm_ell_coo(data, pat.cols.astype(np.int64), p_data,
                                   p_cols, nc, 1 << 21)
    gr, gc, gv = amg._spmm_t_coo(p_data, p_cols, cr, c2, cv, nc, 1 << 21)
    sd, sc = amg._coo_to_ell(gr, gc, gv, nc)
    Dn, Ds = _dense(cd, cc, nc, nc), _dense(sd, sc, nc, nc)
    assert np.abs(Dn - Ds).max() < 1e-12 * max(1.0, np.abs(Ds).max())


def test_galerkin_ell_width_retry():
    rng = np.random.default_rng(1)
    n, K, nc = 60, 4, 6
    cols = rng.integers(0, n, size=(n, K)).astype(np.int32)
    cols[:, 0] = np.arange(n)
    data = rng.standard_normal((n, K))
    p_cols = rng.integers(0, nc, size=(n, 2)).astype(np.int32)
    p_data = rng.standard_normal((n, 2))
    cd, cc = native.galerkin_ell(data, cols, p_data, p_cols, nc,
                                 width_guess=2)
    jd, jc = jnative.galerkin_ell(data, cols, p_data, p_cols, nc,
                                  width_guess=2)
    assert cd.shape == cc.shape and cd.shape[0] == nc and cd.shape[1] > 2
    _eq(cd, jd)
    _eq(cc, jc)


def _bell_dense(data, cols, nrows, ncols):
    n, K, p, q = data.shape
    out = np.zeros((nrows * p, ncols * q))
    for i in range(n):
        for k in range(K):
            j = int(cols[i, k])
            if j >= ncols:
                assert not np.any(data[i, k])
                continue
            out[i * p:(i + 1) * p, j * q:(j + 1) * q] += data[i, k]
    return out


def _block_operands(seed=0, n=80, K=5, b=3, nc=12, Kp=2, m=2):
    rng = np.random.default_rng(seed)
    a_cols = rng.integers(0, n, size=(n, K)).astype(np.int32)
    a_cols[:, 0] = np.arange(n)
    a_data = rng.standard_normal((n, K, b, b))
    a_data[:, K - 1] = 0.0
    p_cols = rng.integers(0, nc, size=(n, Kp)).astype(np.int32)
    p_data = rng.standard_normal((n, Kp, b, m))
    p_data[::7] = 0.0
    return a_data, a_cols, p_data, p_cols


@pytest.mark.parametrize("which", ["bspmm", "galerkin"])
def test_block_products_match(which):
    a_data, a_cols, p_data, p_cols = _block_operands(seed=3)
    n, nc = a_data.shape[0], 12
    port = getattr(native, f"{which}_bell")
    ref = getattr(jnative, f"{which}_bell")
    cd, cc = port(a_data, a_cols, p_data, p_cols, nc)
    jd, jc = ref(a_data, a_cols, p_data, p_cols, nc)
    _eq(cd, jd)
    _eq(cc, jc)
    cr, c2, cv = amg_block._bspmm(a_data, a_cols, p_data, p_cols, nc,
                                  1 << 18)
    if which == "bspmm":
        sd, sc = amg_block._bcoo_to_bell(cr, c2, cv, n)
        Dn, Ds = (_bell_dense(cd, cc, n, nc), _bell_dense(sd, sc, n, nc))
    else:
        gr, gc, gv = amg_block._bspmm_t(p_data, p_cols, cr, c2, cv, nc,
                                        1 << 18)
        sd, sc = amg_block._bcoo_to_bell(gr, gc, gv, nc)
        Dn, Ds = (_bell_dense(cd, cc, nc, nc), _bell_dense(sd, sc, nc, nc))
    assert np.abs(Dn - Ds).max() < 1e-12 * max(1.0, np.abs(Ds).max())


def test_galerkin_bell_width_retry():
    ops = _block_operands(seed=5, n=40, K=6, b=2, nc=4, Kp=3, m=2)
    gd, gc = native.galerkin_bell(*ops, 4, width_guess=1)
    jd, jc = jnative.galerkin_bell(*ops, 4, width_guess=1)
    assert gd.shape[0] == 4 and gd.shape[:2] == gc.shape
    assert gd.shape[1] > 1
    _eq(gd, jd)
    _eq(gc, jc)


def test_use_native_false_takes_no_library(monkeypatch):
    """With use_native / native_setup False the numpy specification runs:
    a library that would raise is never reached."""
    def refuse():
        raise AssertionError("the native library was asked for")

    monkeypatch.setattr(native, "_load", refuse)
    mesh = perturbed_rectangle_mesh(-1, 1, -1, 1, 10, 10, jitter=0.2,
                                    seed=0)
    cols = adjacency.ell_pattern(mesh.conn, mesh.num_nodes, pad_to=8).cols
    adjacency.reverse_cuthill_mckee(cols, use_native=False)
    amg.greedy_aggregate(cols, use_native=False)
    data = np.where(cols == np.arange(cols.shape[0])[:, None], 6.0, -1.0)
    from tpufem_torch.sparse.ell import ELLMatrix
    A = ELLMatrix(torch.as_tensor(data), torch.as_tensor(cols))
    h = amg.build_amg(A, coarse_n=20, native_setup=False)
    assert len(h.levels) >= 1
    with pytest.raises(AssertionError, match="native library"):
        adjacency.reverse_cuthill_mckee(cols)


def test_unbuildable_library_raises(monkeypatch, tmp_path):
    """No fallback: a compiler that is not there makes the native paths
    raise (the reference would quietly take numpy)."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_BUILD", tmp_path)
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    cols = np.arange(6, dtype=np.int32)[:, None].repeat(2, axis=1)
    with pytest.raises(RuntimeError, match="host compiler"):
        native.build_native()
    with pytest.raises(RuntimeError, match="host compiler"):
        adjacency.reverse_cuthill_mckee(cols)
    with pytest.raises(RuntimeError, match="host compiler"):
        amg.greedy_aggregate(cols)
    assert not list(tmp_path.glob("*.so"))
