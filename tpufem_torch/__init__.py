"""tpufem_torch — the PyTorch/CUDA port of tpufem for NVIDIA Hopper.

Mirrors the JAX package's module paths (``tpufem_torch/solve/multigrid.py``
is the counterpart of ``tpufem/solve/multigrid.py``); every Pallas module
``ops/X_pallas.py`` becomes ``ops/X_cuda.py`` with its hand-written CUDA
source in ``csrc/X.cu``.  Kernels are compiled with nvcc at first use, never
at import, so importing this package needs only torch and numpy.

Ported so far: the structured P1 Poisson fast path in 2D and 3D (fused
system build, stencil SpMV, const and general MG V-cycles, PCG,
mixed-precision refinement; ``solve.structured_fast.solve_poisson_fast``),
generic structured assembly (shift-invariant stencil assembly, the fused
Kuhn-tetrahedron stiffness kernel ``ops.assemble_cuda``), the unstructured
ELL path (mesh, RCM, ELL pattern and assembly, Dirichlet elimination,
Jacobi / Chebyshev PCG on the banded ELL kernel;
``solve.poisson.solve_poisson_ell``), the weak-form frontend
(``forms.language``, ``forms.weakform``: volume and boundary forms on P1 and
P2 simplices and Q1 quads and hexes, dense, ELL and stencil assembly;
``fem.facets``, COO assembly ``assemble.coo``, the matrix-free operators
``sparse.matfree``, element coloring, and the SymPy frontend
``forms.symbolic``, which needs SymPy and is not imported here),
unstructured linear elasticity (vector P1
spaces, BCSR assembly, block-Jacobi PCG on the banded block kernel;
``solve.elasticity.solve_elasticity``), smoothed-aggregation AMG (scalar
``solve.amg.build_amg``, block ``solve.amg_block.build_block_amg``, the
preconditioners of ``solve_poisson_ell`` and ``solve_elasticity`` with
``precond="amg"``; their host setup on the native library
``tpufem_torch.native``), the reduction and SAXPY kernels
(``ops.reduction``, ``ops.saxpy_cuda``) and the multi-device path
(``dist``: a single-controller device mesh, the sharded halo CGs, the
sharded fused build on kernel B8, the distributed multigrid and AMG), and
the physics solvers: matrix-free Newton-Krylov (``solve.newton``),
explicit leapfrog dynamics (``solve.dynamics``), modal analysis by
subspace iteration (``solve.eigen``, on ``solve.cg.cg_fixed_block``), and
MINRES with Taylor-Hood Stokes (``solve.minres``, ``solve.stokes``); the
auxiliaries (``config``, ``utils.logging``, ``utils.debug``,
``utils.profiling``, ``utils.timing``, ``io.checkpoint``) and ten of the
JAX package's examples as modules of ``tpufem_torch.examples``.

The package root exports the meshes, spaces, rules, ``cg`` and the matrix
classes, and resolves the heavier entry points lazily, as the JAX
package's root does.
"""
from tpufem_torch.mesh.core import Mesh
from tpufem_torch.mesh.rectangle import (rectangle_mesh, unit_square_mesh,
                                         RectangleMesh, UnitSquareMesh,
                                         rectangle_quad_mesh)
from tpufem_torch.mesh.box import (box_mesh, unit_cube_mesh, BoxMesh,
                                   UnitCubeMesh, box_hex_mesh)
from tpufem_torch.mesh.adjacency import (ell_pattern, node_adjacency,
                                         greedy_element_coloring)
from tpufem_torch.fem.space import FunctionSpace, VectorFunctionSpace
from tpufem_torch.fem.quadrature import (triangle_rule, tetrahedron_rule,
                                         rule_for_cell)
from tpufem_torch.solve.cg import cg, CGResult
from tpufem_torch.sparse.ell import ELLMatrix
from tpufem_torch.sparse.stencil import StencilMatrix

__version__ = "0.1.0"

# name -> (module, attribute): resolved on first access
_LAZY = {
    "WeakForm": ("tpufem_torch.forms.weakform", "WeakForm"),
    "solve_poisson_fast": ("tpufem_torch.solve.structured_fast",
                           "solve_poisson_fast"),
    "build_poisson_multigrid": ("tpufem_torch.solve.multigrid",
                                "build_poisson_multigrid"),
    "solve_elasticity": ("tpufem_torch.solve.elasticity",
                         "solve_elasticity"),
    "solve_poisson_ell": ("tpufem_torch.solve.poisson", "solve_poisson_ell"),
    "build_amg": ("tpufem_torch.solve.amg", "build_amg"),
    "build_dist_amg": ("tpufem_torch.dist.amg", "build_dist_amg"),
    "build_block_amg": ("tpufem_torch.solve.amg_block", "build_block_amg"),
    "newton_krylov": ("tpufem_torch.solve.newton", "newton_krylov"),
    "smallest_eigenpairs": ("tpufem_torch.solve.eigen",
                            "smallest_eigenpairs"),
    "leapfrog_wave": ("tpufem_torch.solve.dynamics", "leapfrog_wave"),
    "solve_stokes": ("tpufem_torch.solve.stokes", "solve_stokes"),
    "minres": ("tpufem_torch.solve.minres", "minres"),
}

# names the JAX package exports that the port does not have yet, with the
# ROADMAP item that brings each
_NOT_PORTED: dict = {}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    if name in _NOT_PORTED:
        raise AttributeError(f"tpufem_torch.{name} is not ported yet "
                             f"(ROADMAP {_NOT_PORTED[name]})")
    raise AttributeError(f"module 'tpufem_torch' has no attribute {name!r}")
