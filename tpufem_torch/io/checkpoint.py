"""Checkpoint and resume, as in tpufem.io.checkpoint: assembled systems
and solver iterates.

``save_system`` / ``load_system`` and ``save_solution`` /
``load_solution`` write the reference's compressed npz layout: the keys
``kind``, ``data``, ``cols``, ``row_lengths``, ``diag_pos``, ``offsets``,
``b``, ``extra_*`` and ``x``, ``iterations``, ``residual_norm``, with the
arrays' own dtypes, written to a temporary file and renamed into place.
A file written by either package loads in the other.  ``load_*`` place
the tensors on ``device`` (the card unless the caller asks for the CPU);
CG resumes from a loaded iterate through ``solve.cg.cg``'s ``x0``.

``orbax_save`` / ``orbax_restore`` keep the reference's names and
semantics for a nested dict of tensors (multi-device state, hierarchies,
iterates) on ``torch.distributed.checkpoint`` in place of orbax, which
imports JAX.  It runs in one process without a process group.
"""
from __future__ import annotations

import os
import shutil

import numpy as np
import torch

from tpufem_torch.sparse.ell import ELLMatrix
from tpufem_torch.sparse.stencil import StencilMatrix

__all__ = ["save_system", "load_system", "save_solution", "load_solution",
           "orbax_save", "orbax_restore"]


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _savez_atomic(path: str, arrays: dict) -> None:
    """np.savez_compressed to ``path`` through a temporary name (numpy
    appends ".npz" to it), then one rename."""
    tmp = path + ".tmp"
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def save_system(path: str, A, b=None, **extra) -> None:
    """Save an assembled system (ELL or stencil matrix + optional RHS)."""
    arrays = {}
    if isinstance(A, ELLMatrix):
        arrays["kind"] = np.array("ell")
        arrays["data"] = _np(A.data)
        arrays["cols"] = _np(A.cols)
        if A.row_lengths is not None:
            arrays["row_lengths"] = _np(A.row_lengths)
        if A.diag_pos is not None:
            arrays["diag_pos"] = _np(A.diag_pos)
    elif isinstance(A, StencilMatrix):
        arrays["kind"] = np.array("stencil")
        arrays["data"] = _np(A.data)
        arrays["offsets"] = np.asarray(A.offsets, dtype=np.int64)
    else:
        raise TypeError(f"unsupported matrix type {type(A)}")
    if b is not None:
        arrays["b"] = _np(b)
    for k, v in extra.items():
        arrays[f"extra_{k}"] = _np(v)
    _savez_atomic(path, arrays)


def load_system(path: str, *, device="cuda"):
    """Load (A, b, extras) saved by save_system; A and b on ``device``,
    the extras numpy."""
    def t(a):
        return torch.as_tensor(a, device=device)

    with np.load(path, allow_pickle=False) as z:
        kind = str(z["kind"])
        if kind == "ell":
            A = ELLMatrix(
                t(z["data"]), t(z["cols"]),
                t(z["row_lengths"]) if "row_lengths" in z else None,
                t(z["diag_pos"]) if "diag_pos" in z else None)
        elif kind == "stencil":
            A = StencilMatrix(t(z["data"]),
                              tuple(int(o) for o in z["offsets"]))
        else:
            raise ValueError(f"unknown matrix kind {kind!r}")
        b = t(z["b"]) if "b" in z else None
        extras = {k[6:]: np.asarray(z[k]) for k in z.files
                  if k.startswith("extra_")}
    return A, b, extras


def save_solution(path: str, x, *, iterations: int = 0,
                  residual_norm: float = 0.0, **extra) -> None:
    """Save a solver iterate for a warm restart (CG resumes via x0)."""
    arrays = {"x": _np(x),
              "iterations": _np(iterations),
              "residual_norm": _np(residual_norm)}
    for k, v in extra.items():
        arrays[f"extra_{k}"] = _np(v)
    _savez_atomic(path, arrays)


def load_solution(path: str, *, device="cuda"):
    """(x on ``device``, info: iterations, residual_norm and the
    extras)."""
    with np.load(path, allow_pickle=False) as z:
        x = torch.as_tensor(z["x"], device=device)
        info = {"iterations": int(z["iterations"]),
                "residual_norm": float(z["residual_norm"])}
        info.update({k[6:]: np.asarray(z[k]) for k in z.files
                     if k.startswith("extra_")})
    return x, info


# -- the sharded-state variant (torch.distributed.checkpoint) ----------------

def _no_dist() -> bool:
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized())


def _fill_like(tree):
    """A tree of the reference tree's structure with fresh tensors of its
    leaves' shapes, types and devices (what the load fills)."""
    if isinstance(tree, dict):
        return {k: _fill_like(v) for k, v in tree.items()}
    return torch.empty_like(torch.as_tensor(tree))


def _tree_from_metadata(path: str) -> dict:
    """Empty host tensors at the checkpoint's keys, shapes and types,
    nested as they were saved."""
    from torch.distributed.checkpoint import FileSystemReader
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    md = FileSystemReader(path).read_metadata()
    tree: dict = {}
    for key, meta in md.state_dict_metadata.items():
        if not isinstance(meta, TensorStorageMetadata):
            raise TypeError(f"checkpoint entry {key!r} is not a tensor")
        where = (md.planner_data or {}).get(key, (key,))
        node = tree
        for part in where[:-1]:
            node = node.setdefault(part, {})
        node[where[-1]] = torch.empty(tuple(meta.size),
                                      dtype=meta.properties.dtype)
    return tree


def orbax_save(path: str, pytree) -> None:
    """Checkpoint a nested dict of tensors (replacing what ``path``
    held), for multi-device state such as hierarchies or distributed CG
    iterates."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    if os.path.isdir(path):
        shutil.rmtree(path)
    dcp.save(pytree, checkpoint_id=path, no_dist=_no_dist())


def orbax_restore(path: str, reference_pytree=None):
    """Restore a tree saved by orbax_save.  With ``reference_pytree`` (a
    matching tree of tensors) the result has its structure, types and
    devices; without one it is rebuilt from the checkpoint's metadata on
    the host."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    tree = (_fill_like(reference_pytree) if reference_pytree is not None
            else _tree_from_metadata(path))
    dcp.load(tree, checkpoint_id=path, no_dist=_no_dist())
    return tree
