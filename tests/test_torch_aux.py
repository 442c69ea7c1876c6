"""The port's auxiliaries against the JAX package's, on the CPU:
``utils.timing`` (the rep-difference estimator and ``bandwidth_gbs``),
``utils.logging`` (the same records), ``utils.debug`` (the same
validators, the same failures), ``utils.profiling`` (a Chrome trace with
the annotated regions), ``io.checkpoint`` (npz files that each package
reads from the other; the sharded-state variant's round trip) and
``config`` (the same flags, fields and meshes)."""
import argparse
import dataclasses
import glob
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(1)


def test_device_seconds_per_rep_calls_run_as_the_reference():
    from tpufem.utils import timing as jtiming

    from tpufem_torch.utils import timing

    seen, jseen = [], []

    def run(reps, seen=seen):
        seen.append(reps)
        x = torch.ones(8)
        for _ in range(reps):
            x = x * 1.0
        return x

    def jrun(reps):
        jseen.append(reps)
        return jnp.ones(8)

    for kw in ({}, dict(reps_low=10, reps_high=60, trials=2),
               dict(warmup=False, trials=1)):
        seen.clear()
        jseen.clear()
        dt = timing.device_seconds_per_rep(run, **kw)
        jtiming.device_seconds_per_rep(jrun, **kw)
        assert seen == jseen and dt > 0.0
    # a tuple's first tensor is what completes
    assert timing.device_seconds_per_rep(
        lambda r: (torch.zeros(2), 0), trials=1) > 0.0
    assert timing.bandwidth_gbs(3.0e9, 0.5) == jtiming.bandwidth_gbs(
        3.0e9, 0.5) == 6.0


def test_run_logger_records_match_the_reference():
    import io

    from tpufem.mesh.rectangle import RectangleMesh as JaxRect
    from tpufem.solve.cg import CGResult as JaxResult
    from tpufem.utils.logging import RunLogger as JaxLogger
    from tpufem.utils.logging import get_logger as jax_get_logger

    from tpufem_torch.mesh.rectangle import RectangleMesh
    from tpufem_torch.solve.cg import CGResult
    from tpufem_torch.utils.logging import RunLogger, get_logger

    res = CGResult(x=torch.zeros(3), iterations=17,
                   residual_norm=torch.tensor(3.5e-9, dtype=torch.float64),
                   converged=True,
                   diverged=False)
    jres = JaxResult(x=jnp.zeros(3), iterations=jnp.int32(17),
                     residual_norm=jnp.asarray(3.5e-9), converged=True,
                     diverged=False)
    stream, jstream = io.StringIO(), io.StringIO()
    logs = []
    for Logger, mesh, r, s in ((RunLogger, RectangleMesh(-3, 3, -3, 3, 4, 5),
                                res, stream),
                               (JaxLogger, JaxRect(-3, 3, -3, 3, 4, 5), jres,
                                jstream)):
        log = Logger(stream=s, name="demo")
        log.mesh_stats(mesh)
        log.assembly(num_dofs=30, nnz=140, seconds=0.5, format="ell")
        log.assembly(num_dofs=30)
        log.solve(r, seconds=0.25)
        log.solve(r)
        log.log("hierarchy", levels=3)
        logs.append(log)
    ours, ref = ([{k: v for k, v in e.items() if k != "t"}
                  for e in log.events] for log in logs)
    assert ours == ref
    assert [json.loads(line)["event"] for line in
            stream.getvalue().splitlines()] == [e["event"] for e in ref]
    dumped = io.StringIO()
    logs[0].dump(dumped)
    assert dumped.getvalue() == stream.getvalue()
    assert get_logger().name == "tpufem_torch"
    assert jax_get_logger().name == "tpufem"


def _pattern_pair():
    """The same P1 pattern from both packages, and its element matrices."""
    from tpufem.mesh.adjacency import ell_pattern as jax_pattern
    from tpufem.mesh.rectangle import perturbed_rectangle_mesh as jax_mesh

    from tpufem_torch.assemble.local import p1_stiffness
    from tpufem_torch.fem.elements import P1Triangle
    from tpufem_torch.mesh.adjacency import ell_pattern
    from tpufem_torch.mesh.rectangle import perturbed_rectangle_mesh

    mesh = perturbed_rectangle_mesh(-1, 1, -1, 1, 5, 4, seed=3)
    jmesh = jax_mesh(-1, 1, -1, 1, 5, 4, seed=3)
    pat = ell_pattern(mesh.conn, mesh.num_nodes, pad_to=8)
    jpat = jax_pattern(jmesh.conn, jmesh.num_nodes, pad_to=8)
    Ke = p1_stiffness(torch.as_tensor(mesh.element_coords()), P1Triangle())
    return mesh, pat, jpat, Ke


def _corrupt(pattern, how):
    if how == "slot_plus_one":
        slots = pattern.slots.copy()
        slots[2, 1, 0] += 1
        return dataclasses.replace(pattern, slots=slots)
    if how == "swapped_columns":
        cols = pattern.cols.copy()
        cols[7, [0, 1]] = cols[7, [1, 0]]
        return dataclasses.replace(pattern, cols=cols)
    dpos = pattern.diag_pos.copy()
    dpos[4] += 1
    return dataclasses.replace(pattern, diag_pos=dpos)


def test_debug_validators_pass_on_the_same_pattern():
    from tpufem.utils import debug as jdebug

    from tpufem_torch.assemble.ell import assemble_ell
    from tpufem_torch.utils import debug

    mesh, pat, jpat, Ke = _pattern_pair()
    assert debug.validate_ell_pattern(pat, mesh.conn, mesh.num_nodes)
    assert jdebug.validate_ell_pattern(jpat, mesh.conn, mesh.num_nodes)
    assert debug.check_assembly_agreement(pat, Ke)
    assert jdebug.check_assembly_agreement(jpat, jnp.asarray(Ke.numpy()))
    A = assemble_ell(pat, Ke)
    for ours in (A, A.to_dense()):
        assert debug.check_operator_invariants(ours, zero_row_sums=True)
    assert jdebug.check_operator_invariants(A.to_dense().numpy(),
                                            zero_row_sums=True)
    skew = A.to_dense()
    skew[0, 1] += 1.0
    for check in (debug.check_operator_invariants,
                  jdebug.check_operator_invariants):
        with pytest.raises(AssertionError, match="not symmetric"):
            check(skew.numpy())


@pytest.mark.parametrize("how", ["slot_plus_one", "swapped_columns",
                                 "diag_pos_off_by_one"])
def test_debug_validators_fail_as_the_reference(how):
    from tpufem.utils import debug as jdebug

    from tpufem_torch.utils import debug

    mesh, pat, jpat, _ = _pattern_pair()
    messages = []
    for validate, p in ((debug.validate_ell_pattern, _corrupt(pat, how)),
                        (jdebug.validate_ell_pattern, _corrupt(jpat, how))):
        with pytest.raises(AssertionError) as err:
            validate(p, mesh.conn, mesh.num_nodes)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_assembly_agreement_catches_a_broken_sort_plan():
    from tpufem_torch.utils import debug

    _, pat, _, Ke = _pattern_pair()
    perm = pat.perm.copy()
    perm[[0, 5]] = perm[[5, 0]]
    with pytest.raises(AssertionError, match="disagree"):
        debug.check_assembly_agreement(dataclasses.replace(pat, perm=perm),
                                       Ke)


def test_trace_writes_the_annotated_region(tmp_path):
    from tpufem_torch.utils.profiling import annotate, trace

    with trace(str(tmp_path)) as where:
        with annotate("tpufem_region"):
            torch.ones(64).cumsum(0)
    assert where == str(tmp_path)
    files = glob.glob(str(tmp_path / "*.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    assert any(e.get("name") == "tpufem_region" for e in events)
    with pytest.raises(ValueError, match="create_perfetto_link"):
        with trace(str(tmp_path), create_perfetto_link=True):
            pass


def _systems(kind):
    """(port matrix, JAX matrix, b) of one kind, from the same arrays."""
    from tpufem.sparse.ell import ELLMatrix as JaxELL
    from tpufem.sparse.stencil import StencilMatrix as JaxStencil

    from tpufem_torch.sparse.ell import ELLMatrix
    from tpufem_torch.sparse.stencil import StencilMatrix

    rng = np.random.default_rng(5)
    if kind == "stencil":
        data = rng.standard_normal((3, 12)).astype(np.float32)
        return (StencilMatrix(torch.as_tensor(data), (-1, 0, 1)),
                JaxStencil(jnp.asarray(data), (-1, 0, 1)))
    data = rng.standard_normal((6, 4))
    cols = rng.integers(0, 6, (6, 4)).astype(np.int32)
    extra = ((rng.integers(1, 5, 6).astype(np.int32),
              rng.integers(0, 4, 6).astype(np.int32)) if kind == "ell_full"
             else (None, None))
    return (ELLMatrix(torch.as_tensor(data), torch.as_tensor(cols),
                      *[None if a is None else torch.as_tensor(a)
                        for a in extra]),
            JaxELL(jnp.asarray(data), jnp.asarray(cols),
                   *[None if a is None else jnp.asarray(a) for a in extra]))


def _same(ours, ref):
    if ours is None or ref is None:
        assert ours is None and ref is None
        return
    ours = np.asarray(ours.numpy() if isinstance(ours, torch.Tensor)
                      else ours)
    ref = np.asarray(ref)
    assert ours.dtype == ref.dtype
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("with_b", [False, True], ids=["no_b", "b"])
@pytest.mark.parametrize("kind", ["ell_full", "ell_bare", "stencil"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_npz_systems_cross_read(writer, kind, with_b, tmp_path):
    from tpufem.io import checkpoint as jck

    from tpufem_torch.io import checkpoint as ck

    A, jA = _systems(kind)
    b = np.arange(A.shape[0], dtype=A.data.numpy().dtype) if with_b else None
    extra = dict(level=np.int64(3), coords=np.linspace(0, 1, 5))
    path = str(tmp_path / "sys.npz")
    if writer == "port":
        ck.save_system(path, A, None if b is None else torch.as_tensor(b),
                       **extra)
    else:
        jck.save_system(path, jA, None if b is None else jnp.asarray(b),
                        **extra)
    assert sorted(glob.glob(str(tmp_path / "*"))) == [path]   # renamed
    (A1, b1, ex1), (A2, b2, ex2) = (ck.load_system(path, device="cpu"),
                                    jck.load_system(path))
    for f in (("data", "offsets") if kind == "stencil" else
              ("data", "cols", "row_lengths", "diag_pos")):
        _same(getattr(A1, f), getattr(A2, f))
    assert type(A1).__name__ == type(A2).__name__
    _same(b1, b2)
    assert ex1.keys() == ex2.keys() == extra.keys()
    for k in extra:
        _same(ex1[k], ex2[k])
    if kind != "stencil":
        x = torch.arange(A.shape[0], dtype=A1.dtype)
        np.testing.assert_allclose(A1.matvec(x).numpy(),
                                   np.asarray(A2.matvec(jnp.asarray(
                                       x.numpy()))), rtol=1e-12)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_npz_solutions_cross_read(writer, tmp_path):
    from tpufem.io import checkpoint as jck

    from tpufem_torch.io import checkpoint as ck

    x = np.linspace(-1, 1, 11).astype(np.float32)
    path = str(tmp_path / "sol.npz")
    save = ck.save_solution if writer == "port" else jck.save_solution
    save(path, torch.as_tensor(x) if writer == "port" else jnp.asarray(x),
         iterations=42, residual_norm=2.5e-7, step=np.int32(7))
    (x1, i1), (x2, i2) = ck.load_solution(path, device="cpu"), \
        jck.load_solution(path)
    _same(x1, x2)
    assert x1.dtype == torch.float32
    assert i1.keys() == i2.keys() == {"iterations", "residual_norm", "step"}
    assert (i1["iterations"], i1["residual_norm"]) == (
        i2["iterations"], i2["residual_norm"]) == (42, 2.5e-7)
    _same(i1["step"], i2["step"])


def test_load_places_on_the_card_by_default(tmp_path):
    import inspect

    from tpufem_torch.io import checkpoint as ck

    for fn in (ck.load_system, ck.load_solution):
        p = inspect.signature(fn).parameters["device"]
        assert (p.kind, p.default) == (inspect.Parameter.KEYWORD_ONLY,
                                       "cuda")
    path = str(tmp_path / "s.npz")
    ck.save_solution(path, torch.ones(3))
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            ck.load_solution(path)


def test_sharded_state_round_trip(tmp_path):
    from tpufem_torch.io.checkpoint import orbax_restore, orbax_save

    tree = {"x": torch.arange(6.0), "levels": {
        "A": torch.ones(2, 3, dtype=torch.float64),
        "cols": torch.arange(4, dtype=torch.int32)}}
    path = str(tmp_path / "ckpt")
    orbax_save(path, tree)
    orbax_save(path, tree)                       # replaces what was there
    for got in (orbax_restore(path), orbax_restore(path, tree)):
        assert got.keys() == tree.keys()
        assert got["levels"].keys() == tree["levels"].keys()
        for a, b in ((got["x"], tree["x"]),
                     (got["levels"]["A"], tree["levels"]["A"]),
                     (got["levels"]["cols"], tree["levels"]["cols"])):
            assert a.dtype == b.dtype and torch.equal(a, b)
    ref = {"x": torch.zeros(6), "levels": {
        "A": torch.zeros(2, 3, dtype=torch.float64),
        "cols": torch.zeros(4, dtype=torch.int32)}}
    orbax_restore(path, ref)
    assert float(ref["x"].sum()) == 0.0          # the reference is not filled


@pytest.mark.parametrize("argv", [[], ["--dim", "3", "--cells", "3", "4",
                                       "5", "--format", "ell", "--tol",
                                       "1e-6", "--preconditioner", "none"],
                                  ["--cells", "6", "--degree", "2",
                                   "--dtype", "float64", "--maxiter", "9"]])
def test_config_from_cli_matches(argv):
    from tpufem import config as jconfig

    from tpufem_torch import config

    ours, ref = [], []
    for mod, out in ((config, ours), (jconfig, ref)):
        parser = argparse.ArgumentParser()
        mod.add_cli_args(parser)
        out.extend(mod.from_cli(parser.parse_args(argv)))
    for a, b in zip(ours, ref):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert [f.name for f in dataclasses.fields(config.ProblemConfig)] == \
        [f.name for f in dataclasses.fields(jconfig.ProblemConfig)]


@pytest.mark.parametrize("dim,cells", [(2, (5,)), (2, (3, 4)), (3, (2,)),
                                       (3, (2, 3, 1))])
def test_config_make_mesh_matches(dim, cells):
    from tpufem import config as jconfig

    from tpufem_torch import config

    m = config.ProblemConfig(dim=dim, cells=cells).make_mesh()
    jm = jconfig.ProblemConfig(dim=dim, cells=cells).make_mesh()
    np.testing.assert_array_equal(m.coords, jm.coords)
    np.testing.assert_array_equal(m.conn, jm.conn)
    with pytest.raises(ValueError, match="dim 4"):
        config.ProblemConfig(dim=4).make_mesh()
