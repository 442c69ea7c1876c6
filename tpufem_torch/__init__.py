"""tpufem_torch — the PyTorch/CUDA port of tpufem for NVIDIA Hopper.

Mirrors the JAX package's module paths (``tpufem_torch/solve/multigrid.py``
is the counterpart of ``tpufem/solve/multigrid.py``); every Pallas module
``ops/X_pallas.py`` becomes ``ops/X_cuda.py`` with its hand-written CUDA
source in ``csrc/X.cu``.  Kernels are compiled with nvcc at first use, never
at import, so importing this package needs only torch and numpy.

Ported so far: the structured P1 Poisson fast path in 2D and 3D (fused
system build, stencil SpMV, const and general MG V-cycles, PCG,
mixed-precision refinement; ``solve.structured_fast.solve_poisson_fast``),
the unstructured ELL path (mesh, RCM, ELL pattern and assembly,
Dirichlet elimination, Jacobi / Chebyshev PCG on the banded ELL kernel;
``solve.poisson.solve_poisson_ell``), the weak-form frontend
(``forms.language``, ``forms.weakform``: volume forms on affine cells,
dense and ELL assembly) and unstructured linear elasticity (vector P1
spaces, BCSR assembly, block-Jacobi PCG on the banded block kernel;
``solve.elasticity.solve_elasticity``).
"""

__version__ = "0.1.0"
