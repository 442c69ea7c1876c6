"""Port parity, the ELL kernels' module: the banded plan (ell_band_plan)
equal to the JAX package's, the plain versions of B9 (static, segmented),
B11 (per_block) and B10 against the Pallas kernels in interpret mode at
1e-12 (float64), int16 and int32 window indices; the gather form,
ELLMatrix's dispatch and its products against the JAX package's."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpufem.sparse import ell as jax_ell
from tpufem.sparse import ell_pallas as jax_ep

from tpufem_torch.sparse import ell_cuda
from tpufem_torch.sparse.ell import (ELLMatrix, ell_matvec, ell_matvec_multi,
                                     reorder_ell)
from tpufem_torch.sparse.ell_cuda import (auto_block_rows, ell_band_plan,
                                          ell_matvec_cuda,
                                          ell_matvec_multi_cuda)

# several pytest workers share the CPU: one intra-op thread each keeps
# the many small tensor ops from oversubscribing it
torch.set_num_threads(1)

# (rows, slots, half bandwidth, block rows): R = 128 stores int16 windows,
# R = 11008 (3R > 32767) int32 ones
_CASES = {"int16": (900, 8, 64, 128), "int32": (12000, 8, 300, 11008)}


def _random_banded(seed, n, k, band):
    rng = np.random.default_rng(seed)
    cols = np.clip(np.arange(n)[:, None]
                   + rng.integers(-band, band + 1, size=(n, k)),
                   0, n - 1).astype(np.int32)
    return rng.standard_normal((n, k)), cols, rng


def _close(a, b, rtol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= rtol * max(np.abs(b).max(), 1e-300)


def _plans(case, per_block=False, segment=True):
    data, cols, rng = _random_banded(1, *_CASES[case][:3])
    R = _CASES[case][3]
    kw = dict(block_rows=R, per_block=per_block, segment=segment)
    return (jax_ep.ell_band_plan(data, cols, **kw),
            ell_band_plan(data, cols, **kw), data, cols, rng)


@pytest.mark.parametrize("per_block", [False, True])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_band_plan_equals_jax(case, per_block):
    ref, plan, *_ = _plans(case, per_block)
    assert plan.rel.dtype == ref.rel.dtype == (
        np.int16 if case == "int16" else np.int32)
    np.testing.assert_array_equal(plan.rel, ref.rel)
    np.testing.assert_array_equal(plan.data_t, ref.data_t)
    assert (plan.n, plan.np_rows, plan.block_rows, plan.width) == (
        ref.n, ref.np_rows, ref.block_rows, ref.width)
    assert plan.d_lists == ref.d_lists
    assert plan.segments == ref.segments
    if per_block:
        np.testing.assert_array_equal(plan.dtab, ref.dtab)
    else:
        assert plan.dtab is None and ref.dtab is None


@pytest.mark.parametrize("bw,n,k", [(30, 625, 8), (1001, 1_002_001, 8),
                                    (5000, 20000, 16), (200, 100, None),
                                    (2000, 50000, 51)])
def test_auto_block_rows_equals_jax(bw, n, k):
    assert auto_block_rows(bw, n, k) == jax_ep.auto_block_rows(bw, n, k)


def test_band_plan_refuses_a_wide_band():
    data, cols, _ = _random_banded(2, 4000, 4, 2000)
    with pytest.raises(ValueError, match="bandwidth"):
        ell_band_plan(data, cols, block_rows=1024)


@pytest.mark.parametrize("mode", ["static", "segmented", "per_block"])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_band_matvec_matches_pallas(case, mode):
    """B9 (static, segmented) and B11 (per_block): the plain version the
    wrapper runs on a CPU tensor against the TPU kernel, interpreted."""
    ref_plan, plan, _, _, rng = _plans(case, per_block=mode == "per_block")
    assert (plan.segments is not None) == (plan.np_rows > plan.block_rows)
    x = rng.standard_normal(plan.n)
    y_ref = jax_ep.ell_matvec_pallas(
        ref_plan, jnp.asarray(ref_plan.data_t), jnp.asarray(ref_plan.rel),
        jnp.asarray(x), interpret=True, per_block=mode == "per_block",
        segmented=mode == "segmented")
    before = ell_matvec_cuda.launches
    y = ell_matvec_cuda(plan, torch.as_tensor(plan.data_t),
                        torch.as_tensor(plan.rel), torch.as_tensor(x),
                        per_block=mode == "per_block",
                        segmented=mode == "segmented")
    assert ell_matvec_cuda.launches == before      # plain on the CPU
    assert y.shape == (plan.n,)
    _close(y.numpy(), y_ref)


@pytest.mark.parametrize("segmented", [False, True])
@pytest.mark.parametrize("q", [1, 2, 3, 5, 8])
def test_band_matvec_multi_matches_pallas(q, segmented):
    """B10: Y = A X against the TPU multi-RHS kernel, interpreted."""
    ref_plan, plan, _, _, rng = _plans("int16")
    X = rng.standard_normal((plan.n, q))
    Y_ref = jax_ep.ell_matvec_pallas_multi(
        ref_plan, jnp.asarray(ref_plan.data_t), jnp.asarray(ref_plan.rel),
        jnp.asarray(X), interpret=True, segmented=segmented)
    Y = ell_matvec_multi_cuda(plan, torch.as_tensor(plan.data_t),
                              torch.as_tensor(plan.rel), torch.as_tensor(X),
                              segmented=segmented)
    _close(Y.numpy(), Y_ref)


def test_band_plan_for_a_padded_vector():
    """x of NP rows (the reference's padded form) gives the same y."""
    _, plan, data, cols, rng = _plans("int16")
    x = rng.standard_normal(plan.n)
    xp = np.concatenate([x, np.zeros(plan.np_rows - plan.n)])
    args = (plan, torch.as_tensor(plan.data_t), torch.as_tensor(plan.rel))
    assert torch.equal(ell_matvec_cuda(*args, torch.as_tensor(x)),
                       ell_matvec_cuda(*args, torch.as_tensor(xp)))


@pytest.mark.parametrize("q", [None, 3])
def test_gather_matvec_matches_jax(q):
    data, cols, rng = _random_banded(3, 700, 8, 650)
    if q is None:
        x = rng.standard_normal(700)
        ref = jax_ell.ell_matvec(jnp.asarray(data), jnp.asarray(cols),
                                 jnp.asarray(x))
        y = ell_matvec(torch.as_tensor(data), torch.as_tensor(cols),
                       torch.as_tensor(x))
    else:
        x = rng.standard_normal((700, q))
        ref = jax_ell.ell_matvec_multi(jnp.asarray(data), jnp.asarray(cols),
                                       jnp.asarray(x))
        y = ell_matvec_multi(torch.as_tensor(data), torch.as_tensor(cols),
                             torch.as_tensor(x))
    _close(y.numpy(), ref)


def _symmetric_ell(seed, n, band):
    """A symmetric ELL matrix with its diagonal in slot 0, up to 3 random
    lower neighbours within ``band`` per row (and their mirrors), and
    self-pointing zero padding, as assembly gives."""
    rng = np.random.default_rng(seed)
    nbrs = [dict() for _ in range(n)]
    for i in range(1, n):
        lo = max(0, i - band)
        for j in rng.choice(np.arange(lo, i), size=min(i - lo, 3),
                            replace=False):
            nbrs[i][int(j)] = nbrs[int(j)][i] = rng.standard_normal()
    k = max(len(d) for d in nbrs) + 2
    data = np.zeros((n, k))
    cols = np.repeat(np.arange(n, dtype=np.int32)[:, None], k, axis=1)
    for i, d in enumerate(nbrs):
        data[i, 0] = 10.0
        data[i, 1:1 + len(d)] = list(d.values())
        cols[i, 1:1 + len(d)] = list(d.keys())
    return data, cols, np.zeros(n, np.int32), rng


@pytest.mark.parametrize("band,banded", [(40, True), (4500, False)])
def test_ellmatrix_matches_jax(monkeypatch, band, banded):
    """ELLMatrix's dispatch (banded plan iff bandwidth <= 4096) and its
    products, diagonal, dense form and transpose product against the JAX
    package's (its gather form, with the reference's own switch)."""
    monkeypatch.setenv("TPUFEM_BAND_DISPATCH", "0")
    n = 5000
    data, cols, diag_pos, rng = _symmetric_ell(4, n, band)
    A = ELLMatrix(torch.as_tensor(data), torch.as_tensor(cols),
                  diag_pos=torch.as_tensor(diag_pos))
    R = jax_ell.ELLMatrix(jnp.asarray(data), jnp.asarray(cols),
                          diag_pos=jnp.asarray(diag_pos))
    x = rng.standard_normal(n)
    X = rng.standard_normal((n, 3))
    _close(A.matvec(torch.as_tensor(x)).numpy(), R.matvec(jnp.asarray(x)))
    assert (A._band is not None) == banded
    _close((A @ torch.as_tensor(x)).numpy(), R @ jnp.asarray(x))
    _close(A.matvec_multi(torch.as_tensor(X)).numpy(),
           R.matvec_multi(jnp.asarray(X)))
    np.testing.assert_array_equal(A.diagonal().numpy(),
                                  np.asarray(R.diagonal()))
    _close(A.transpose_matvec(torch.as_tensor(x)).numpy(),
           R.transpose_matvec(jnp.asarray(x)))
    assert A.shape == (n, n) and A.width == data.shape[1]
    assert A.dtype == torch.float64
    # without diag_pos the masked row sum finds the same diagonal
    B = ELLMatrix(torch.as_tensor(data), torch.as_tensor(cols))
    np.testing.assert_array_equal(B.diagonal().numpy(), data[:, 0])


def test_to_dense_equals_jax():
    data, cols, _, _ = _symmetric_ell(8, 300, 40)
    np.testing.assert_array_equal(
        ELLMatrix(torch.as_tensor(data), torch.as_tensor(cols)).to_dense()
        .numpy(),
        np.asarray(jax_ell.ELLMatrix(jnp.asarray(data),
                                     jnp.asarray(cols)).to_dense()))


def test_failed_band_plan_warns_and_gathers(monkeypatch):
    import tpufem_torch.sparse.ell as port_ell

    def broken(*args, **kwargs):
        raise MemoryError("plan")

    monkeypatch.setattr(port_ell, "ell_band_plan", broken)
    data, cols, diag_pos, rng = _symmetric_ell(5, 300, 20)
    A = ELLMatrix(torch.as_tensor(data), torch.as_tensor(cols))
    x = torch.as_tensor(rng.standard_normal(300))
    with pytest.warns(RuntimeWarning, match="band-plan build failed"):
        y = A.matvec(x)
    assert A._band is None
    _close(y.numpy(), (A.to_dense() @ x).numpy())


def test_matvec_forward_mode_and_no_transpose():
    """The JVP of the product applies the kernel to the tangent (as the
    reference's custom_jvp); the reverse mode raises."""
    data, cols, _, rng = _symmetric_ell(6, 400, 30)
    A = ELLMatrix(torch.as_tensor(data), torch.as_tensor(cols)).resolve_band()
    assert A._band is not None
    x, t = (torch.as_tensor(rng.standard_normal(400)) for _ in range(2))
    import torch.autograd.forward_ad as fwad
    with fwad.dual_level():
        y = A.matvec(fwad.make_dual(x, t))
        primal, tangent = fwad.unpack_dual(y)
    dense = A.to_dense()
    _close(primal.numpy(), (dense @ x).numpy())
    _close(tangent.numpy(), (dense @ t).numpy())
    xr = x.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="transpose"):
        A.matvec(xr).sum().backward()
    # the gather form the same way
    G = ELLMatrix(torch.as_tensor(data), torch.as_tensor(cols))
    G._band = None
    with fwad.dual_level():
        tangent = fwad.unpack_dual(G.matvec(fwad.make_dual(x, t))).tangent
    _close(tangent.numpy(), (dense @ t).numpy())
    with pytest.raises(NotImplementedError, match="transpose"):
        G.matvec(xr).sum().backward()


def test_reorder_ell_equals_jax():
    data, cols, _, rng = _symmetric_ell(7, 500, 50)
    perm = rng.permutation(500)
    ref = jax_ell.reorder_ell(data, cols, perm)
    got = reorder_ell(torch.as_tensor(data), cols, perm)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_plain_versions_are_what_the_wrappers_run_on_the_cpu():
    _, plan, data, cols, rng = _plans("int16")
    x = torch.as_tensor(rng.standard_normal(plan.n))
    args = (plan, torch.as_tensor(plan.data_t), torch.as_tensor(plan.rel))
    assert torch.equal(ell_matvec_cuda(*args, x),
                       ell_cuda.ell_band_matvec_plain(*args, x))
    # the window arithmetic and the gather give the same products, in the
    # same slot order
    assert torch.equal(ell_cuda.ell_band_matvec_plain(*args, x),
                       ell_matvec(torch.as_tensor(data),
                                  torch.as_tensor(cols), x))
