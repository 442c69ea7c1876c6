"""SAXPY, out = a x + y, as examples/saxpy_pallas.py: the "author a kernel,
build it at run time, launch it" check.  n = 32 x 16,384 fp32 values
through ``ops.saxpy_cuda.saxpy``: B15 (csrc/saxpy.cu, built at first use)
on the card, its plain version on host tensors (the JAX example's own CPU
branch skips its kernel too).

    python -m tpufem_torch.examples.saxpy_cuda
    python -m tpufem_torch.examples.saxpy_cuda --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from tpufem_torch.examples._common import add_device_arg, device_of
from tpufem_torch.ops.saxpy_cuda import saxpy

NUM_BLOCKS, BLOCK = 32, 128 * 128     # the reference's grid and block


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    dev = device_of(ap.parse_args(argv))

    n = NUM_BLOCKS * BLOCK
    a = torch.tensor([5.1], dtype=torch.float32, device=dev)
    x = torch.arange(n, dtype=torch.float32, device=dev)
    y = torch.arange(n, dtype=torch.float32, device=dev) * 2.0
    out = saxpy(a, x, y)
    expected = 5.1 * np.arange(n, dtype=np.float32) + 2.0 * np.arange(
        n, dtype=np.float32)
    err = float(np.abs(out.cpu().numpy() - expected).max())
    print(f"saxpy n={n}: max |err| = {err}")
    assert err < 1e-4
    print("PASSED")
    return {"n": n, "max_abs_err": err, "out": out}


if __name__ == "__main__":
    main()
