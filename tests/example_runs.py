"""What the example parity tests (tests/test_torch_examples_*.py) share:
running a JAX example's and a port example's ``main`` with their printed
output captured, the comparison of two solutions, and the fixtures (one
BLAS thread a test, the JAX package's host forms, torch's default dtype
float64 beside JAX's x64)."""
import contextlib
import importlib
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:          # the JAX examples/ beside the port
    sys.path.insert(0, str(REPO))


@pytest.fixture(autouse=True)
def one_blas_thread():
    """One BLAS thread a test, as one torch thread: numpy's OpenBLAS
    threads spin against the other workers on the shared CPU."""
    with threadpool_limits(1, user_api="blas"):
        yield


@pytest.fixture(autouse=True)
def jax_host_forms(monkeypatch):
    """The JAX package's XLA gather products (its interpreted Pallas
    kernels otherwise), and no executable cache written under HOME."""
    monkeypatch.setenv("TPUFEM_BAND_DISPATCH", "0")
    monkeypatch.setenv("TPUFEM_AOT_CACHE", "0")


@pytest.fixture
def float64_default():
    """torch's default dtype float64, as JAX's default float is here (the
    test configuration enables x64)."""
    before = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(before)


def jax_main(name, argv, call=None):
    """(what the JAX example's main returned, what it printed); ``call``
    runs a main that takes no argv."""
    mod = importlib.import_module(f"examples.{name}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = call(mod) if call is not None else mod.main(argv)
    return ret, buf.getvalue()


def port_main(name, argv):
    """(the port example's returned dict, what it printed), on the host."""
    mod = importlib.import_module(f"tpufem_torch.examples.{name}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = mod.main(argv + ["--device", "cpu"])
    return out, buf.getvalue()


def json_line(text):
    """The last JSON line of a printout."""
    return json.loads([line for line in text.splitlines()
                       if line.startswith("{")][-1])


def assert_close(x, ref, rel):
    """max |x - ref| <= rel * max |ref| over the flattened arrays."""
    x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x,
                   np.float64).reshape(-1)
    ref = np.asarray(ref, np.float64).reshape(-1)
    assert x.shape == ref.shape
    assert np.abs(x - ref).max() <= rel * np.abs(ref).max()
