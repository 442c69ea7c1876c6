"""Problem and solver configuration dataclasses + CLI construction, as in
tpufem.config: configuration is data, and one argparse adapter gives the
examples one flag set (the reference's flags and defaults)."""
from __future__ import annotations

import argparse
import dataclasses
from typing import Tuple

__all__ = ["ProblemConfig", "SolverConfig", "add_cli_args", "from_cli"]


@dataclasses.dataclass(frozen=True)
class ProblemConfig:
    dim: int = 2
    cells: Tuple[int, ...] = (64, 64)
    domain: Tuple[float, float] = (-3.0, 3.0)
    degree: int = 1
    dtype: str = "float32"

    def make_mesh(self):
        from tpufem_torch.mesh.box import box_mesh
        from tpufem_torch.mesh.rectangle import rectangle_mesh

        lo, hi = self.domain
        if self.dim == 2:
            n_row, n_col = self.cells if len(self.cells) == 2 else \
                (self.cells[0], self.cells[0])
            return rectangle_mesh(lo, hi, lo, hi, n_row, n_col)
        if self.dim == 3:
            c = self.cells if len(self.cells) == 3 else (self.cells[0],) * 3
            return box_mesh(lo, hi, lo, hi, lo, hi, *c)
        raise ValueError(f"dim {self.dim}")


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    format: str = "stencil"           # dense | ell | stencil | matfree
    tol: float = 1e-8
    maxiter: int = 10_000
    preconditioner: str = "jacobi"    # none | jacobi | block_jacobi
    assembly_method: str = "scatter"  # scatter | sort (index-based formats)


def add_cli_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--dim", type=int, default=2, choices=(2, 3))
    parser.add_argument("--cells", type=int, nargs="+", default=[64])
    parser.add_argument("--degree", type=int, default=1)
    parser.add_argument("--dtype", default="float32")
    parser.add_argument("--format", default="stencil",
                        choices=("dense", "ell", "stencil", "matfree"))
    parser.add_argument("--tol", type=float, default=1e-8)
    parser.add_argument("--maxiter", type=int, default=10_000)
    parser.add_argument("--preconditioner", default="jacobi",
                        choices=("none", "jacobi", "block_jacobi"))


def from_cli(args: argparse.Namespace):
    prob = ProblemConfig(dim=args.dim, cells=tuple(args.cells),
                         degree=args.degree, dtype=args.dtype)
    sol = SolverConfig(format=args.format, tol=args.tol,
                       maxiter=args.maxiter,
                       preconditioner=args.preconditioner)
    return prob, sol
