"""Reduction microbenchmark with golden checks and a bandwidth report, as
examples/reduction_bench.py: the library sum, the two-stage block sum
(kernel B14, ``ops.reduction.pallas_block_reduce``) and the
deterministic segment sum, each against the float64 host sum; then the
block sum's bandwidth by the reference's rep-difference
(``utils.timing.device_seconds_per_rep``), each repetition carrying the
previous one's result.  The reference times its fused XLA sum there; the
port times B14, its hand-written reduction.  64 MB of fp32 on the card,
2^20 values on the host; the fraction is of the NVIDIA H100 SXM's 3.35
TB/s.

    python -m tpufem_torch.examples.reduction_bench
    python -m tpufem_torch.examples.reduction_bench --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from tpufem_torch.examples._common import add_device_arg, device_of
from tpufem_torch.ops.reduction import (pallas_block_reduce, reduce_sum,
                                        reduction_check, segment_reduce)
from tpufem_torch.utils.timing import bandwidth_gbs, device_seconds_per_rep

HBM_GBS = 3350.0        # NVIDIA H100 SXM HBM3 (data sheet)


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_of(args)
    # 64 MB of float32 on the card (the reference's SIZE); smaller on the
    # host, where the plain versions do the block sums
    n = (64 * 1024 * 1024 // 4) if dev.type == "cuda" else (1 << 20)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.random(n, np.float32), device=dev)

    checks = {}
    checks["fused"] = reduction_check(x, reduce_sum(x))
    print("fused sum:        ", checks["fused"])
    checks["block"] = reduction_check(x, pallas_block_reduce(x,
                                                             block=n // 8))
    print("pallas block sum: ", checks["block"])

    ids = torch.as_tensor(rng.integers(0, 1000, n, np.int32), device=dev)
    checks["segment"] = reduction_check(x, segment_reduce(x, ids,
                                                          1000).sum())
    print("segment sum:      ", checks["segment"])

    def sum_many(reps):
        acc = torch.zeros((), dtype=x.dtype, device=dev)
        for _ in range(reps):
            acc = acc * 0.0 + pallas_block_reduce(x, block=n // 8)
        return acc

    dt = device_seconds_per_rep(sum_many, reps_low=10, reps_high=210)
    gbs = bandwidth_gbs(n * 4, dt)
    print(f"block sum bandwidth: {gbs:.0f} GB/s "
          f"({gbs / HBM_GBS:.0%} of H100 HBM3 peak)")
    return {"n": n, "checks": checks,
            "match": all(c["match"] for c in checks.values()),
            "seconds_per_rep": dt, "bandwidth_gbs": gbs,
            "hbm_fraction": gbs / HBM_GBS}


if __name__ == "__main__":
    main()
