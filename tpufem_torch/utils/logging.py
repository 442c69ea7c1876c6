"""Structured run logging, as in tpufem.utils.logging.

A run's events (mesh size, nnz, assembly seconds, DOFs/s, CG iterations,
final residual) as dicts with the reference's event and field names,
streamed as JSON lines and mirrored to the standard logging module under
the logger ``"tpufem_torch"``.
"""
from __future__ import annotations

import json
import logging
import sys
import time
from typing import Optional

__all__ = ["RunLogger", "get_logger"]

_logger = logging.getLogger("tpufem_torch")


def get_logger() -> logging.Logger:
    return _logger


class RunLogger:
    """Collects structured events for one run; optionally streams JSONL."""

    def __init__(self, stream=None, name: str = "run"):
        self.name = name
        self.events: list[dict] = []
        self.stream = stream
        self._t0 = time.perf_counter()

    def log(self, event: str, **fields):
        rec = {"event": event, "t": round(time.perf_counter() - self._t0, 6),
               **fields}
        self.events.append(rec)
        if self.stream is not None:
            print(json.dumps(rec), file=self.stream, flush=True)
        _logger.info("%s %s", event, fields)
        return rec

    def mesh_stats(self, mesh):
        return self.log("mesh", num_nodes=mesh.num_nodes,
                        num_elements=mesh.num_elements, dim=mesh.dim,
                        cell_type=mesh.cell_type)

    def assembly(self, *, num_dofs: int, nnz: Optional[int] = None,
                 seconds: Optional[float] = None, format: str = ""):
        fields = {"num_dofs": num_dofs, "format": format}
        if nnz is not None:
            fields["nnz"] = nnz
        if seconds is not None:
            fields["seconds"] = seconds
            fields["dofs_per_sec"] = num_dofs / seconds if seconds else None
        return self.log("assembly", **fields)

    def solve(self, result, *, seconds: Optional[float] = None):
        """A solve's event from a ``solve.cg.CGResult`` (its 0-d residual
        tensor read as a float)."""
        fields = {"iterations": int(result.iterations),
                  "residual_norm": float(result.residual_norm),
                  "converged": bool(result.converged),
                  "diverged": bool(result.diverged)}
        if seconds is not None:
            fields["seconds"] = seconds
        return self.log("solve", **fields)

    def dump(self, file=None):
        out = file or sys.stdout
        for rec in self.events:
            print(json.dumps(rec), file=out)
