"""The JAX examples' own CPU numbers at chip_smoke.py's ex_* sizes: each
example's ``main`` run on the host, in JAX's default float (fp32, x64 off,
as a user runs the example), the XLA gather products
(TPUFEM_BAND_DISPATCH=0), no executable cache (TPUFEM_AOT_CACHE=0), and
eight virtual CPU devices (for dist_amg_demo).

    python scripts/examples_jax_reference.py poisson_2d --cells 64
    python scripts/examples_jax_reference.py heat_equation --cells 1000 --steps 20
    python scripts/examples_jax_reference.py poisson_3d_multigrid --n 96 --no-pallas
    python scripts/examples_jax_reference.py poisson_10m --n 224
    python scripts/examples_jax_reference.py unstructured_1m --n 300
    python scripts/examples_jax_reference.py unstructured_1m --n 300 --precond amg
    python scripts/examples_jax_reference.py dist_amg_demo --n 96 --devices 8
    python scripts/examples_jax_reference.py elasticity_unstructured --n 200 --precond amg --interpret --no-aot

With ``--port`` first, the port's example runs instead
(``tpufem_torch.examples.<name>.main(argv + ["--device", "cpu"])``: fp32,
the plain versions of the kernels), and its returned numbers are printed:

    python scripts/examples_jax_reference.py --port heat_equation --cells 1000 --steps 20

Each prints one JSON line: the example, its argv, the wall time, what
the example printed (its JSON line parsed where it prints one) and the
numbers read from what it returned (iterations, residual, convergence;
heat_equation's total CG iterations from its line, and its L2^2 before
and after at full precision from the same mass matrix).  poisson_10m's
``solve_poisson_fast`` runs in interpret mode, as the JAX package's tests
run it on the CPU (n = 224: about 6 minutes and 5 GB).
"""
import contextlib
import importlib
import io
import json
import os
import re
import sys
import time

os.environ.setdefault("TPUFEM_BAND_DISPATCH", "0")
os.environ.setdefault("TPUFEM_AOT_CACHE", "0")
os.environ["XLA_FLAGS"] = (re.sub(
    r"--xla_force_host_platform_device_count=\d+", "",
    os.environ.get("XLA_FLAGS", "")) + " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def _returned(ret):
    """Numbers of what main returned: a CGResult or a solution vector."""
    if ret is None:
        return {}
    if hasattr(ret, "iterations"):
        return {"iterations": int(ret.iterations),
                "residual_norm": float(ret.residual_norm),
                "converged": bool(ret.converged),
                "x_norm": float(np.linalg.norm(np.asarray(ret.x,
                                                          np.float64)))}
    u = np.asarray(ret, np.float64)
    return {"u_norm": float(np.linalg.norm(u)), "u_size": int(u.size)}


def _heat_energies(argv, u):
    """heat_equation's L2^2 = u^T M u of its initial state and of the state
    it returned, summed in float64 on the host from the example's fp32 M
    and states (the example prints four places of an fp32 dot, whose
    rounding at 1M terms reaches the fourth place)."""
    import argparse

    import jax.numpy as jnp

    from tpufem import FunctionSpace, RectangleMesh
    from tpufem.forms.weakform import WeakForm
    from tpufem.mesh.adjacency import ell_pattern

    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, default=32)
    cells = ap.parse_known_args(argv)[0].cells
    mesh = RectangleMesh(-3.0, 3.0, -3.0, 3.0, cells, cells)
    V = FunctionSpace(mesh, "Lagrange", 1)
    pattern = ell_pattern(V.dof_conn, V.num_dofs, pad_to=8)
    M, _ = WeakForm(V).build(lambda a, v: a * v).assemble(format="ell",
                                                          pattern=pattern)
    c = mesh.coords
    u0 = jnp.asarray(np.exp(-((c[:, 0]) ** 2 + (c[:, 1]) ** 2)))
    u0 = jnp.where(jnp.asarray(V.dof_flags), 0.0, u0)
    data = np.asarray(M.data, np.float64)
    cols = np.asarray(M.cols)
    out = []
    for v in (np.asarray(u0, np.float64), np.asarray(u, np.float64)):
        out.append(float(np.dot((data * v[cols]).sum(axis=1), v)))
    return out


def _parsed(text):
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("{"):
            out["json"] = json.loads(line)
        for key, val in re.findall(r"(\w+)=([-+\w.]+)", line):
            out.setdefault("fields", {})[key] = val
        m = re.search(r"L2\^2 ([-+\d.e]+) -> ([-+\d.e]+)", line)
        if m:
            out["l2sq"] = [float(m.group(1)), float(m.group(2))]
    return out


def port(argv):
    """The port's example on the host: its returned scalars (and a list of
    per-step counts where it returns one)."""
    import torch

    name, rest = argv[0], argv[1:]
    mod = importlib.import_module(f"tpufem_torch.examples.{name}")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out = mod.main(rest + ["--device", "cpu"])
    wall = time.perf_counter() - t0
    keep = {k: v for k, v in out.items()
            if isinstance(v, (bool, int, float, str))
            or (isinstance(v, list) and all(isinstance(i, int) for i in v))}
    print(json.dumps({"example": name, "argv": rest, "port": True,
                      "torch": torch.__version__, "wall_s": round(wall, 2),
                      **keep}))


def main(argv):
    if argv[0] == "--port":
        return port(argv[1:])
    name, rest = argv[0], argv[1:]
    mod = importlib.import_module(f"examples.{name}")
    if name == "poisson_10m":
        import functools

        from tpufem.solve import structured_fast

        mod.solve_poisson_fast = functools.partial(
            structured_fast.solve_poisson_fast, interpret=True)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        if name == "elasticity_1m":
            sys.argv = [name] + rest
            ret = mod.main()
        elif name == "reduction_bench":
            ret = mod.main()
        else:
            ret = mod.main(rest)
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    extra = ({"l2sq_full": _heat_energies(rest, ret)}
             if name == "heat_equation" else {})
    print(json.dumps({"example": name, "argv": rest,
                      "wall_s": round(wall, 2), "stdout": text.strip(),
                      **_parsed(text), **_returned(ret), **extra}))


if __name__ == "__main__":
    main(sys.argv[1:])
