"""Kernel loader: nvcc by hand into a shared library, bound with ctypes.

Each CUDA source in ``tpufem_torch/csrc`` exports plain C entry points
(pointers, sizes and the CUDA stream as integers; each returns
``cudaGetLastError()``).  ``load_library`` compiles a source for Hopper
(``sm_90a``) into ``tpufem_torch/_build/`` at first use — never at import —
keyed by a hash of the source, the shared headers, any generated headers
and the flags, and loads it with ctypes.  A source with a plain C interface
builds in seconds; nothing here includes PyTorch's headers.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["NVCC_FLAGS", "BUILD_DIR", "CSRC_DIR", "load_library",
           "check_launch", "stream_handle"]

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# loaded libraries by (source, generated headers): one dlopen each per process
_LOADED: dict = {}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                           "kernels are built from source at first use")
    return found


def _build_key(source: str, headers: dict) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC_DIR / source).read_bytes())
    for inc in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(inc.name.encode())
        h.update(inc.read_bytes())
    for name in sorted(headers):
        h.update(name.encode())
        h.update(headers[name].encode())
    return h.hexdigest()[:16]


def load_library(source: str, signatures: dict, headers: dict | None = None
                 ) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>``.

    ``signatures`` maps each exported C function to its ctypes argtypes
    (every function returns an int status).  ``headers`` maps file names
    to generated header text, written beside the build and put on the
    include path (e.g. the fused build's RHS expression and plan tables).
    """
    headers = dict(headers or {})
    # memo on the call's own inputs first: hashing the sources reads files,
    # which would cost more than a launch on every call
    memo = (source, tuple(sorted(headers.items())))
    lib = _LOADED.get(memo)
    if lib is not None:
        return lib
    key = _build_key(source, headers)
    stem = Path(source).stem
    so_path = BUILD_DIR / f"{stem}-{key}.so"
    if not so_path.exists():
        inc_dir = BUILD_DIR / f"{stem}-{key}.include"
        inc_dir.mkdir(parents=True, exist_ok=True)
        for name, text in headers.items():
            (inc_dir / name).write_text(text)
        tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-I", str(inc_dir),
               "-o", str(tmp), str(CSRC_DIR / source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source} "
                               f"(rc {proc.returncode}):\n{log}")
        so_path.with_suffix(".log").write_text(log)
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(str(so_path))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    _LOADED[memo] = lib
    return lib


def check_launch(status: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


def stream_handle() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream
