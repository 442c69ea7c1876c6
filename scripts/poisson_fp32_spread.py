"""How far fp32 rounding moves the port's structured 3D Poisson solution
(``solve_poisson_fast``, the model problem of examples/poisson_10m.py) at
n cells a side, on the host: the fp64 solve to 1e-10 (the discrete
solution's own error against the exact one), then fp32 to the example's
1e-5 and to 1e-7.  Where the fp32 error stays put as the tolerance
tightens, the fp32 system's rounding, not the stopping, sets it.

    python scripts/poisson_fp32_spread.py 224    # about 6 minutes, 20 GB
    python scripts/poisson_fp32_spread.py 56

Prints one line a solve: dtype, tol, iterations, relres, rel L2 error
against the exact solution, and the distance to the fp64 solution.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tpufem_torch.solve.multigrid import _light_grid  # noqa: E402
from tpufem_torch.solve.poisson import (model_problem_3d,  # noqa: E402
                                        model_problem_3d_planes)
from tpufem_torch.solve.structured_fast import solve_poisson_fast  # noqa: E402


def main(n):
    _, coords, _ = _light_grid((-3.0, 3.0), n, 3)
    ue = model_problem_3d()[1](np.moveaxis(coords, 0, -1).reshape(-1, 3))
    u64 = None
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-5),
                       (torch.float32, 1e-7)):
        t0 = time.perf_counter()
        sol = solve_poisson_fast((-3.0, 3.0), n, model_problem_3d_planes(),
                                 tol=tol, maxiter=60, dtype=dtype,
                                 device="cpu")
        u = sol.u.double().numpy()
        u64 = u if u64 is None else u64
        print(f"{dtype} tol {tol:g}: {sol.cg.iterations} iterations, relres "
              f"{float(sol.cg.residual_norm):.3e}, rel L2 error "
              f"{np.linalg.norm(u - ue) / np.linalg.norm(ue):.4e}, from the "
              f"fp64 solution {np.linalg.norm(u - u64) / np.linalg.norm(u64):.3e}"
              f" ({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]))
