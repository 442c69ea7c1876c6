"""tpufem_torch — the PyTorch/CUDA port of tpufem for NVIDIA Hopper.

Mirrors the JAX package's module paths (``tpufem_torch/solve/multigrid.py``
is the counterpart of ``tpufem/solve/multigrid.py``); every Pallas module
``ops/X_pallas.py`` becomes ``ops/X_cuda.py`` with its hand-written CUDA
source in ``csrc/X.cu``.  Kernels are compiled with nvcc at first use, never
at import, so importing this package needs only torch and numpy.

The first slice covers the 3D P1 Poisson main path: fused system build,
stencil SpMV, constant-coefficient MG V-cycle with fused transfers, PCG and
mixed-precision refinement (``solve.structured_fast.solve_poisson_fast``).
"""

__version__ = "0.1.0"
