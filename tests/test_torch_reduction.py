"""Port parity, the reduction and SAXPY kernels' plain versions (B14, B15)
and the library reductions beside them, against the JAX package and the
SAXPY example's golden values (CPU)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpufem.ops.reduction import pallas_block_reduce as jax_block_reduce
from tpufem.ops.reduction import reduction_check as jax_reduction_check

from tpufem_torch.ops.reduction import (block_reduce, block_reduce_plain,
                                        pallas_block_reduce, reduce_sum,
                                        reduction_check, segment_reduce)
from tpufem_torch.ops.saxpy_cuda import saxpy, saxpy_plain

# several pytest workers share the CPU: one intra-op thread each keeps
# the many small tensor ops from oversubscribing it
torch.set_num_threads(1)


def _input(dtype):
    """tests/test_elasticity.py's seeded 65,536-element input."""
    return np.random.default_rng(0).random(1 << 16).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_block_reduce_matches_jax(dtype):
    x = _input(dtype)
    before = block_reduce.launches
    got = pallas_block_reduce(torch.as_tensor(x), block=4096)
    assert block_reduce.launches == before and pallas_block_reduce is \
        block_reduce
    ref = jax_block_reduce(jnp.asarray(x), block=4096, interpret=True)
    assert got.dtype == torch.as_tensor(x).dtype and got.dim() == 0
    # the same values summed in another order: rounding of the type
    tol = 1e-12 if dtype == np.float64 else 1e-6
    assert abs(got.item() - float(ref)) <= tol * abs(float(ref))
    check, jcheck = reduction_check(x, got), jax_reduction_check(x, ref)
    assert check["match"] and jcheck["match"]
    assert check["cpu"] == jcheck["cpu"]
    assert reduction_check(torch.as_tensor(x), reduce_sum(
        torch.as_tensor(x)))["match"]


@pytest.mark.parametrize("n, block", [(65536 - 77, 5000), (10, 4096),
                                      (3 * 4096 + 1, 4096),
                                      (70000, 9000)],
                         ids=["padded", "tiny", "one_over", "ragged_slices"])
def test_block_reduce_padding(n, block):
    """x not a multiple of block: the zero padding of the reference."""
    x = _input(np.float64)[:n]
    got = block_reduce_plain(torch.as_tensor(x), block)
    assert abs(got.item() - x.sum()) <= 1e-12 * x.sum()
    ref = jax_block_reduce(jnp.asarray(x), block=block, interpret=True)
    assert abs(got.item() - float(ref)) <= 1e-12 * abs(float(ref))


def test_block_reduce_order_is_the_kernels():
    """The plain version adds in the kernel's order: 16 strided values per
    thread of 256, then the shuffle and shared-memory trees (checked here
    on values whose float32 sums depend on the order)."""
    x = torch.zeros(4096, dtype=torch.float32)
    x[0], x[256], x[1] = 1e8, -1e8, 1.0
    # thread 0 adds 1e8 then -1e8 (exactly 0) before thread 1's 1 joins
    assert block_reduce_plain(x, 4096).item() == 1.0
    z = torch.zeros(4096, dtype=torch.float32)
    z[0], z[1], z[2] = 1e8, -1e8, 1.0
    # the warp tree adds lanes 0 and 2 first ((1e8 + 1) rounds to 1e8),
    # then lane 1: 0, where the sum in index order gives 1
    assert block_reduce_plain(z, 4096).item() == 0.0
    with pytest.raises(ValueError, match="block"):
        block_reduce(x, 0)


def test_segment_reduce_matches_bincount():
    rng = np.random.default_rng(0)
    x = rng.random(1 << 16)
    ids = rng.integers(0, 100, 1 << 16).astype(np.int32)
    seg = segment_reduce(torch.as_tensor(x), torch.as_tensor(ids), 100)
    np.testing.assert_allclose(seg.numpy(),
                               np.bincount(ids, weights=x, minlength=100),
                               rtol=1e-12)
    assert reduction_check(x, seg.sum())["match"]
    order = np.argsort(ids, kind="stable")
    sorted_seg = segment_reduce(torch.as_tensor(x[order]), ids[order], 100,
                                indices_are_sorted=True)
    np.testing.assert_allclose(sorted_seg.numpy(), seg.numpy(), rtol=1e-12)


def test_saxpy_plain_matches_the_examples_golden():
    """examples/saxpy_pallas.py: n = 32 x 16,384, a = 5.1, x = arange,
    y = 2 arange; max |err| < 1e-4 in float32 (here exactly 0: the product
    and the sum are rounded on their own, as numpy rounds them)."""
    n = 32 * 128 * 128
    a = torch.tensor([5.1], dtype=torch.float32)
    x = torch.arange(n, dtype=torch.float32)
    y = torch.arange(n, dtype=torch.float32) * 2.0
    before = saxpy.launches
    out = saxpy(a, x, y)
    assert saxpy.launches == before
    expected = 5.1 * np.arange(n, dtype=np.float32) + 2.0 * np.arange(
        n, dtype=np.float32)
    err = float(np.abs(out.numpy() - expected).max())
    assert err < 1e-4
    assert torch.equal(out, saxpy_plain(a, x, y))
    odd = saxpy(torch.tensor([5.1], dtype=torch.float64),
                x[:1001].double(), y[:1001].double())
    np.testing.assert_allclose(odd.numpy(),
                               5.1 * np.arange(1001.0) + 2 * np.arange(1001.0),
                               rtol=1e-15)
    with pytest.raises(ValueError, match="one element"):
        saxpy(torch.ones(2), x, y)
    with pytest.raises(ValueError, match="one type"):
        saxpy(a.double(), x, y)



@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shift", [0, 1, 3])
def test_saxpy_output_starts_at_the_inputs_16_byte_phase(dtype, shift):
    """B15's wrapper allocates out at x's offset within 16 bytes, so that
    the kernel moves x and out as aligned 16-byte vectors past one scalar
    head; out is contiguous and shaped like x."""
    from tpufem_torch.ops.saxpy_cuda import _empty_at_phase

    x = torch.arange(1001 + shift, dtype=dtype)[shift:]
    out = _empty_at_phase(x)
    assert out.shape == x.shape and out.dtype == dtype
    assert out.is_contiguous()
    assert out.data_ptr() % 16 == x.data_ptr() % 16
