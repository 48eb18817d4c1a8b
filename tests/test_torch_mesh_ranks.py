"""The port's mesh backend across ranks: spawned processes, gloo, on the
CPU.

Each case spawns its ranks (``torch.multiprocessing``, ``spawn``: the
children import torch, numpy and repro_torch only, and this module,
which imports nothing else at its top) with a deadline of
``DEADLINE`` seconds that kills them and fails.  Every rank writes its
results to an ``.npz``, and they must be the same on all of them
(states and results have global shapes on every rank).  The parent
holds them against the reference's LOCAL backend (its mesh cannot run on
JAX 0.9.0, ROADMAP C0) with the contract of tests/test_mesh_backend.py:
x to rtol 1e-8 / atol 1e-10, histories to rtol 1e-6 / atol 1e-12,
``iters_to_tol`` equal; the kernel path to 1e-6 relative.  The cases:
2 x 2 (data x model, world 4) for all eight solvers, the twin of
tests/test_mesh_backend.py's subprocess parity, and two worker axes (pod
x data, one group built from the rank grid); 1 x 2, the kernel path's
split gather -> all_reduce -> scatter on column shards; the sparse
kernels with the model axis forced off; validation before any
collective; the engine verdict measured on rank 0 and broadcast in the
mesh's step loop, and a rank's own outside it; and the
solve CLI with ``--use-mesh`` under a torchrun-style environment.
Redundant execution and the elastic runtime at world 4 on a 2 x 2 mesh
(twins of tests/test_redundant.py's and tests/test_elastic.py's
subprocess parity cases), held to the reference's plain local run; and
mesh serving at world 2 (1 x 2, the kernel path on column shards): rank
0 admits and answers, the follower serves every batch and stops on the
stop flag, for the sync and the async server and ``serve_linsys
--backend mesh``, held to the reference's local servers.
"""
import contextlib
import io
import os
import socket
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

DEADLINE = 180.0
ITERS = 150
KITERS = 20
ALL = ["apc", "cimmino", "consensus", "dgd", "dhbm", "dnag", "madmm",
       "pdhbm"]
PROJ = ["apc", "consensus", "cimmino"]
X_TOL = dict(rtol=1e-8, atol=1e-10)
H_TOL = dict(rtol=1e-6, atol=1e-12)
SYS = dict(n=64, m=4, cond=10.0, seed=3)
SPARSE = dict(n=192, m=4, bandwidth=6, seed=0)
CLI_ARGS = ["--problem", "ash608", "--workers", "4", "--iters", "30",
            "--use-kernel"]
SERVE_SYS = dict(n=48, m=4, cond=10.0, seed=0)
SERVE_PRM = {"gamma": 1.0, "eta": 1.0}
SERVE_ITERS = 40


# ---------------------------------------------------------------------------
# the children (torch, numpy and repro_torch only)
# ---------------------------------------------------------------------------


def _child(rank, world, out, case, params):
    torch.set_num_threads(1)
    warnings.simplefilter("ignore")
    if case != "cli":
        store = dist.FileStore(os.path.join(out, "store"), world)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world)
    try:
        got = CASES[case](rank, out, params)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if got is not None:
        np.savez(os.path.join(out, f"rank{rank}.npz"), **got)


def _solve(name, sys_, mesh, params, iters=ITERS, **plan):
    from repro_torch import solvers
    return solvers.get(name).solve(
        sys_, iters=iters, plan=solvers.ExecutionPlan(
            backend="mesh", mesh=mesh, **plan), **params[name])


def _record(got, key, r):
    got[f"{key}/x"] = r.x.numpy()
    got[f"{key}/res"] = r.residuals.numpy()
    if r.errors is not None:
        got[f"{key}/err"] = r.errors.numpy()
    got[f"{key}/itt"] = np.asarray(r.iters_to_tol)
    got[f"{key}/t"] = np.asarray(r.state.t)


def _case_2x2(rank, out, params):
    from repro_torch import solvers
    from repro_torch.data import linsys
    from repro_torch.launch import mesh as mesh_lib
    sys_ = linsys.conditioned_gaussian(**SYS, device="cpu")
    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), device="cpu")
    got = {}
    for name in ALL:
        _record(got, name, _solve(name, sys_, mesh, params))
    B = np.random.default_rng(4).standard_normal((3, sys_.N))
    many = solvers.get("apc").solve_many(
        sys_, B, iters=100, plan=solvers.ExecutionPlan(backend="mesh",
                                                       mesh=mesh),
        **params["apc"])
    got["many/x"], got["many/res"] = many.x.numpy(), many.residuals.numpy()
    # two worker axes: one group over pod x data, built from the grid
    pods = mesh_lib.make_mesh((2, 2, 1), ("pod", "data", "model"),
                              device="cpu")
    r = _solve("apc", sys_, pods, params, worker_axes=("pod", "data"))
    _record(got, "pods", r)
    return got


def _case_kernel_1x2(rank, out, params):
    from repro_torch import solvers
    from repro_torch.data import linsys
    from repro_torch.kernels import block_projection as bp
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.solvers import mesh as mesh_backend
    sys_ = linsys.conditioned_gaussian(**SYS, device="cpu")
    mesh = mesh_lib.make_mesh((1, 2), ("data", "model"), device="cpu")
    ctx = mesh_backend.make_context(mesh, sys_)
    assert (ctx.workers, ctx.model_shards) == (1, 2)
    got = {}
    for name in PROJ:
        _record(got, name, _solve(name, sys_, mesh, params, iters=KITERS,
                                  kernel=True))
        _record(got, f"{name}/unfused", _solve(name, sys_, mesh, params,
                                               iters=KITERS))
    B = np.random.default_rng(5).standard_normal((3, sys_.N))
    many = solvers.get("apc").solve_many(
        sys_, B, iters=KITERS, plan=solvers.ExecutionPlan(
            backend="mesh", mesh=mesh, kernel=True), **params["apc"])
    got["many/x"], got["many/res"] = many.x.numpy(), many.residuals.numpy()
    # the column shards the kernels take: contiguous, so the card's ring
    # admits them where it admits the whole block
    fpl, _ = solvers.get("apc").mesh_placements(use_kernel=True)
    f = solvers.get("apc").kernel_factors(solvers.get("apc").prepare(
        sys_.A_blocks, {}))
    A = mesh_backend._shard(f.A, fpl.A, ctx, torch.device("cpu"))
    B_ = mesh_backend._shard(f.B, fpl.B, ctx, torch.device("cpu"))
    assert A.is_contiguous() and B_.is_contiguous()
    assert A.shape == (sys_.m, sys_.p, sys_.n // 2)
    k = 8
    X = torch.zeros(sys_.m, k, sys_.n // 2, dtype=A.dtype)
    U = torch.zeros(sys_.m, k, sys_.p, dtype=A.dtype)
    got["instances"] = np.asarray([bp.gather_instance(A, X, X[0]),
                                   bp.gather_instance(B_, U,
                                                      scatter="apc_scatter")])
    return got


def _case_sparse(rank, out, params):
    from repro_torch.data import linsys
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.solvers import mesh as mesh_backend
    sys_ = linsys.banded_system(**SPARSE, device="cpu")
    got = {}
    for shape in ((2, 1), (1, 2)):
        mesh = mesh_lib.make_mesh(shape, ("data", "model"), device="cpu")
        assert mesh_backend.make_context(mesh, sys_).model_axis is None
        tag = "x".join(map(str, shape))
        _record(got, f"apc/{tag}", _solve("apc", sys_, mesh, params,
                                          iters=KITERS, kernel=True))
    _record(got, "cimmino/2x1", _solve("cimmino", sys_, mesh_lib.make_mesh(
        (2, 1), ("data", "model"), device="cpu"), params, iters=KITERS,
        kernel=True))
    return got


def _case_validate(rank, out, params):
    """Every check of a solve raises on every rank before its first
    collective (the deadline catches a hang)."""
    from repro_torch import solvers
    from repro_torch.core.partition import partition
    from repro_torch.data import linsys
    from repro_torch.launch import mesh as mesh_lib
    mesh = mesh_lib.make_mesh((2, 1), ("data", "model"), device="cpu")
    A = torch.as_tensor(np.random.default_rng(0).standard_normal((12, 12)))
    odd = partition(A, torch.ones(12, dtype=A.dtype), 3)
    msgs = []
    plan = solvers.ExecutionPlan(backend="mesh", mesh=mesh)
    for call in (
            lambda: solvers.get("apc").solve(odd, iters=2, plan=plan,
                                             gamma=1.0, eta=1.0),
            lambda: solvers.get("dgd").solve(
                linsys.conditioned_gaussian(**SYS, device="cpu"), iters=2,
                plan=plan.replace(kernel=True)),
            lambda: solvers.get("dgd").solve(
                linsys.conditioned_gaussian(n=63, m=3, cond=10.0,
                                            device="cpu"), iters=2,
                plan=solvers.ExecutionPlan(
                    backend="mesh", mesh=mesh_lib.make_mesh(
                        (1, 2), ("data", "model"), device="cpu")),
                alpha=0.1)):
        try:
            call()
        except ValueError as e:
            msgs.append(str(e))
    dist.barrier()                  # every rank is still in step
    return {"msgs": np.asarray(msgs)}


def _case_engine(rank, out, params):
    """A measured engine verdict in the mesh's step loop: measured on rank
    0, broadcast."""
    from repro_torch.kernels import ops
    os.environ["REPRO_KERNEL_AUTOTUNE"] = "1"
    os.environ.pop("REPRO_KERNEL_ENGINE", None)
    ops.engine_cache_clear()
    with ops.rank0_decides("cpu"):
        verdict = ops.use_fused("cimmino", 8, 128, 1, torch.float64,
                                device="cpu")
    key = ops.engine_key("cimmino", 8, 128, 1, torch.float64)
    return {"verdict": np.asarray(verdict),
            "times": np.asarray(ops.engine_times[key])}


def _case_engine_alone(rank, out, params):
    """A measured engine verdict outside the mesh's step loop, asked by
    rank 1 alone (a local solve of its own), with the group up: measured
    there, no collective (a broadcast would wait for rank 0 forever)."""
    from repro_torch.kernels import ops
    os.environ["REPRO_KERNEL_AUTOTUNE"] = "1"
    os.environ.pop("REPRO_KERNEL_ENGINE", None)
    ops.engine_cache_clear()
    if rank == 1:
        ops.use_fused("cimmino", 8, 128, 1, torch.float64, device="cpu")
    dist.barrier()
    return {"measured": np.asarray(len(ops.engine_times))}


def _case_cli(rank, out, params):
    """``launch/solve.py --use-mesh`` under torchrun's environment."""
    from repro_torch.launch import solve as cli
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(params["port"]))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(CLI_ARGS + ["--device", "cpu", "--use-mesh"]) == 0
    return {"lines": np.asarray(buf.getvalue().splitlines(), dtype=object)}


def _case_redundant(rank, out, params):
    """r = 2 under the rotating straggler on a 2 x 2 mesh, and the
    schedule lowered on rank 0 alone: a schedule each rank would read
    differently (uncoverable on rank 0 only) raises on every rank."""
    from repro_torch import solvers
    from repro_torch.data import linsys
    from repro_torch.launch import mesh as mesh_lib
    sys_ = linsys.conditioned_gaussian(**SYS, device="cpu")
    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), device="cpu")
    got = {}
    for name in PROJ:
        _record(got, name, _solve(name, sys_, mesh, params, redundancy=2,
                                  alive_schedule=_rotating))
    alive = np.array([rank != 0, rank != 0, True, True])
    try:
        _solve("apc", sys_, mesh, params, iters=5, redundancy=2,
               alive_schedule=alive)
        got["raised"] = np.asarray("")
    except RuntimeError as e:
        got["raised"] = np.asarray(str(e))
    dist.barrier()
    return got


def _rotating(t):
    return np.array([i != (t % 4) for i in range(4)])


def _case_elastic(rank, out, params):
    """A death mid-run on a 2 x 2 mesh: marked on rank 0's monitor alone
    (the membership is rank 0's, broadcast)."""
    from repro_torch import solvers
    from repro_torch.data import linsys
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.runtime.fault import HeartbeatMonitor
    sys_ = linsys.conditioned_gaussian(**SYS, device="cpu")
    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), device="cpu")
    got = {}
    for name in PROJ:
        mon = HeartbeatMonitor(n_workers=4)
        rt = solvers.ElasticRuntime(
            solvers.get(name), sys_, monitor=mon, segment=25,
            plan=solvers.ExecutionPlan(redundancy=2, backend="mesh",
                                       mesh=mesh), **params[name])
        r1 = rt.run(iters=50)
        if rank == 0:
            mon.mark_dead(2)
        r2 = rt.run(iters=100)
        got[f"{name}/x"] = r2.x.numpy()
        got[f"{name}/res"] = torch.cat([r1.residuals, r2.residuals]).numpy()
        got[f"{name}/books"] = np.asarray([r2.relowerings, r2.iters,
                                           r2.segments, len(r2.events)])
        got[f"{name}/caches"] = np.asarray(list(
            rt.engine_cache_sizes().items()))
    return got


def _case_serve(rank, out, params):
    """Mesh serving at world 2 on a 1 x 2 mesh (the kernel path's split
    gather -> all_reduce -> scatter on column shards, the plain versions
    here): the sync server, the async one, then serve_linsys."""
    from repro_torch.data import linsys
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import serve_linsys as serve_cli
    from repro_torch.solvers.pipeline import AsyncLinsysServer
    from repro_torch.solvers.serve import LinsysServer
    from repro_torch.solvers.store import FactorStore
    sys_ = linsys.conditioned_gaussian(**SERVE_SYS, device="cpu")
    mesh = mesh_lib.make_mesh((1, 2), ("data", "model"), device="cpu")
    got = {}
    for tag, cls in (("sync", LinsysServer), ("async", AsyncLinsysServer)):
        srv = cls(FactorStore(), solver="apc", iters=SERVE_ITERS, batch=2,
                  backend="mesh", mesh=mesh, use_kernel=True,
                  **SERVE_PRM)
        fp = srv.register(sys_)
        if rank == 0:
            with srv:
                for b in params["rhs"]:
                    srv.submit(fp, b)
                res = srv.drain()
            got[f"{tag}/x"] = np.stack([r.x for r in res])
            got[f"{tag}/res"] = np.asarray([r.residual for r in res])
            got[f"{tag}/batches"] = np.asarray(srv.stats.batches)
        else:
            try:
                srv.submit(fp, params["rhs"][0])
                got[f"{tag}/refused"] = np.asarray("")
            except RuntimeError as e:
                got[f"{tag}/refused"] = np.asarray(str(e))
            got[f"{tag}/batches"] = np.asarray(srv.serve_follower())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert serve_cli.main(["--backend", "mesh", "--device", "cpu",
                               "--requests", "5", "--systems", "1",
                               "--batch", "2", "--n", "32", "--iters", "60",
                               "--use-kernel"]) == 0
    got["cli"] = np.asarray(buf.getvalue().splitlines(), dtype=object)
    return got


CASES = {"2x2": _case_2x2, "kernel_1x2": _case_kernel_1x2,
         "sparse": _case_sparse, "validate": _case_validate,
         "engine": _case_engine, "engine_alone": _case_engine_alone,
         "cli": _case_cli, "redundant": _case_redundant,
         "elastic": _case_elastic, "serve": _case_serve}


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------


def _run(case, world, tmp_path, params=None):
    """Spawn ``world`` ranks of ``case`` and wait for all of them, for at
    most ``DEADLINE`` seconds: past it every child is killed and the test
    fails (a rank that fails before a collective leaves the others
    waiting on it); a child that raises fails it too.  Every rank's
    results."""
    import torch.multiprocessing as mp
    out = str(tmp_path)
    ctx = mp.start_processes(_child, args=(world, out, case, params or {}),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + DEADLINE
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks of {case!r} did not "
                                   f"finish within {DEADLINE:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    return [dict(np.load(os.path.join(out, f"rank{r}.npz"),
                         allow_pickle=True)) for r in range(world)]


def _same_on_every_rank(got):
    for other in got[1:]:
        assert other.keys() == got[0].keys()
        for k in got[0]:
            np.testing.assert_array_equal(other[k], got[0][k], err_msg=k)


def _ref_params(names, sys_):
    from repro import solvers as ref_solvers
    return {n: ref_solvers.get(n).resolve_params(sys_) for n in names}


def _match(got, key, r_ref, *, errors=True):
    np.testing.assert_allclose(got[f"{key}/x"], np.asarray(r_ref.x),
                               **X_TOL)
    np.testing.assert_allclose(got[f"{key}/res"],
                               np.asarray(r_ref.residuals), **H_TOL)
    if errors:
        np.testing.assert_allclose(got[f"{key}/err"],
                                   np.asarray(r_ref.errors), **H_TOL)
    np.testing.assert_array_equal(got[f"{key}/itt"],
                                  np.asarray(r_ref.iters_to_tol))


def _kernel_match(got, key, x, res):
    x = np.asarray(x)
    assert np.linalg.norm(got[f"{key}/x"] - x) / np.linalg.norm(x) <= 1e-6
    np.testing.assert_allclose(got[f"{key}/res"], np.asarray(res),
                               rtol=1e-6, atol=1e-12)


@pytest.fixture(scope="module")
def ref_sys():
    from repro.data import linsys as ref_linsys
    return ref_linsys.conditioned_gaussian(**SYS)


@pytest.fixture(scope="module")
def run_2x2(ref_sys, tmp_path_factory):
    got = _run("2x2", 4, tmp_path_factory.mktemp("r2x2"),
               _ref_params(ALL, ref_sys))
    _same_on_every_rank(got)
    return got[0]


@pytest.mark.parametrize("name", ALL)
def test_2x2_matches_local(run_2x2, ref_sys, name):
    """Every solver on a 2 x 2 (data x model) mesh of four ranks against
    the reference's local solve."""
    from repro import solvers as ref_solvers
    s = ref_solvers.get(name)
    r_ref = s.solve(ref_sys, iters=ITERS, **s.resolve_params(ref_sys))
    _match(run_2x2, name, r_ref)
    assert int(run_2x2[f"{name}/t"]) == ITERS


def test_2x2_solve_many_and_two_worker_axes(run_2x2, ref_sys):
    from repro import solvers as ref_solvers
    s = ref_solvers.get("apc")
    prm = s.resolve_params(ref_sys)
    B = np.random.default_rng(4).standard_normal((3, ref_sys.N))
    rl = s.solve_many(ref_sys, B, iters=100, **prm)
    np.testing.assert_allclose(run_2x2["many/x"], np.asarray(rl.x), **X_TOL)
    np.testing.assert_allclose(run_2x2["many/res"],
                               np.asarray(rl.residuals), **H_TOL)
    _match(run_2x2, "pods", s.solve(ref_sys, iters=ITERS, **prm))


@pytest.fixture(scope="module")
def run_kernel(ref_sys, tmp_path_factory):
    got = _run("kernel_1x2", 2, tmp_path_factory.mktemp("rk"),
               _ref_params(PROJ, ref_sys))
    _same_on_every_rank(got)
    return got[0]


@pytest.fixture
def fused(monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_ENGINE", "fused")


@pytest.mark.parametrize("name", PROJ)
def test_1x2_kernel_path_matches_local(run_kernel, ref_sys, fused, name):
    """The split gather -> all_reduce over the model axis -> scatter on
    column shards n/2, against the reference's local kernel path and the
    port's unfused mesh path."""
    from repro import solvers as ref_solvers
    s = ref_solvers.get(name)
    r_ref = s.solve(ref_sys, iters=KITERS,
                    plan=ref_solvers.ExecutionPlan(kernel=True),
                    **s.resolve_params(ref_sys))
    _kernel_match(run_kernel, name, r_ref.x, r_ref.residuals)
    _kernel_match(run_kernel, name, run_kernel[f"{name}/unfused/x"],
                  run_kernel[f"{name}/unfused/res"])


def test_1x2_kernel_solve_many_and_shards(run_kernel, ref_sys, fused):
    from repro import solvers as ref_solvers
    s = ref_solvers.get("apc")
    B = np.random.default_rng(5).standard_normal((3, ref_sys.N))
    rl = s.solve_many(ref_sys, B, iters=KITERS,
                      plan=ref_solvers.ExecutionPlan(kernel=True),
                      **s.resolve_params(ref_sys))
    _kernel_match(run_kernel, "many", rl.x, rl.residuals)
    # n/2 = 32 float64 columns: 16-byte rows, the ring on the card
    assert list(run_kernel["instances"]) == ["ring", "ring"]


@pytest.fixture(scope="module")
def run_sparse(tmp_path_factory):
    from repro.data import linsys as ref_linsys
    ref = ref_linsys.banded_system(**SPARSE)
    got = _run("sparse", 2, tmp_path_factory.mktemp("rs"),
               _ref_params(["apc", "cimmino"], ref))
    _same_on_every_rank(got)
    return ref, got[0]


@pytest.mark.parametrize("name", ["apc", "cimmino"])
def test_sparse_kernels_model_axis_off(run_sparse, fused, name):
    """Sparse APC and Cimmino on the sparse kernels per worker: a 2 x 1
    mesh, and for APC a 1 x 2 one, whose model axis is forced off."""
    from repro import solvers as ref_solvers
    ref, got = run_sparse
    s = ref_solvers.get(name)
    r_ref = s.solve(ref, iters=KITERS,
                    plan=ref_solvers.ExecutionPlan(kernel=True),
                    **s.resolve_params(ref))
    for tag in (("2x1", "1x2") if name == "apc" else ("2x1",)):
        _kernel_match(got, f"{name}/{tag}", r_ref.x, r_ref.residuals)


def test_validation_raises_on_every_rank_before_collectives(tmp_path):
    got = _run("validate", 2, tmp_path)
    _same_on_every_rank(got)
    msgs = list(got[0]["msgs"])
    assert len(msgs) == 3
    assert "does not divide m=3" in msgs[0]
    assert "kernel" in msgs[1]
    assert "does not divide n=63" in msgs[2]


def test_engine_verdict_is_rank0s(tmp_path):
    """In the mesh's step loop with a group of several ranks, a measured
    engine verdict is measured on rank 0 and broadcast: every rank holds
    rank 0's times."""
    got = _run("engine", 2, tmp_path)
    _same_on_every_rank(got)
    assert got[0]["times"].shape == (2,) and (got[0]["times"] > 0).all()


def test_local_verdict_is_the_ranks_own(tmp_path):
    """Outside the mesh's step loop a rank measures for itself: rank 1's
    lone measurement returns, and rank 0 measured nothing."""
    got = _run("engine_alone", 2, tmp_path)
    assert [int(g["measured"]) for g in got] == [0, 1]


def test_cli_use_mesh_world_2(tmp_path):
    """``launch/solve.py --use-mesh`` at world 2 (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR/PORT as torchrun sets them): rank 0 prints
    the reference CLI's lines (held to its local run), the others
    nothing."""
    import contextlib as cl
    from repro.launch import solve as ref_cli
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    got = _run("cli", 2, tmp_path, {"port": port})
    lines = list(got[0]["lines"])
    assert list(got[1]["lines"]) == []
    buf = io.StringIO()
    with cl.redirect_stdout(buf), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert ref_cli.main(CLI_ARGS) == 0
    ref_lines = buf.getvalue().splitlines()
    assert "mesh backend: (('data', 2), ('model', 1)) over 2 rank(s)" \
        in lines
    lines = [ln for ln in lines if not ln.startswith("mesh backend")]
    assert lines[:-1] == ref_lines[:-1]
    assert lines[-1].startswith("done in") and "rel-error" in lines[-1]


# ---------------------------------------------------------------------------
# redundancy, the elastic runtime and mesh serving across ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_plain(ref_sys):
    """The reference's plain local solve of the projection family."""
    from repro import solvers as ref_solvers
    out = {}
    for name in PROJ:
        s = ref_solvers.get(name)
        out[name] = s.solve(ref_sys, iters=ITERS, **s.resolve_params(ref_sys))
    return out


def test_redundant_mesh_parity_2x2(ref_sys, ref_plain, tmp_path):
    """r = 2 with a rotating straggler on a 2 x 2 (data x model) mesh of
    four ranks against the reference's plain local run (twin of
    tests/test_redundant.py's subprocess parity); an uncoverable schedule
    read on rank 0 alone raises on every rank."""
    got = _run("redundant", 4, tmp_path, _ref_params(PROJ, ref_sys))
    _same_on_every_rank([{k: v for k, v in g.items() if k != "raised"}
                         for g in got])
    for name in PROJ:
        _match(got[0], name, ref_plain[name])
        assert int(got[0][f"{name}/t"]) == ITERS
    for g in got:
        assert "unrecoverable" in str(g["raised"]), g["raised"]


def test_elastic_death_parity_2x2(ref_sys, ref_plain, tmp_path):
    """Death -> re-lower -> continue on a 2 x 2 mesh, the death marked on
    rank 0's monitor alone, against the reference's uninterrupted local
    run (twin of tests/test_elastic.py's subprocess parity)."""
    got = _run("elastic", 4, tmp_path, _ref_params(PROJ, ref_sys))
    _same_on_every_rank(got)
    for name in PROJ:
        np.testing.assert_allclose(got[0][f"{name}/res"],
                                   np.asarray(ref_plain[name].residuals),
                                   **H_TOL)
        np.testing.assert_allclose(got[0][f"{name}/x"],
                                   np.asarray(ref_plain[name].x), **X_TOL)
        assert got[0][f"{name}/books"].tolist() == [1, ITERS, 4, 1]
        assert got[0][f"{name}/caches"].tolist() == [[4, 1]]


def test_mesh_serving_world_2(tmp_path):
    """Rank 0 admits, announces and answers; the follower serves every
    batch, answers nothing, refuses to admit, and stops on the stop flag;
    the answers are the reference's local servers' (x rtol 1e-8 / atol
    1e-10, the residual 1e-6 relative)."""
    from repro.data import linsys as ref_linsys
    from repro.solvers.pipeline import AsyncLinsysServer as RefAsync
    from repro.solvers.serve import LinsysServer as RefServer
    from repro.solvers.store import FactorStore as RefStore
    rhs = np.random.default_rng(11).standard_normal((5, 48))
    got = _run("serve", 2, tmp_path, {"rhs": rhs})
    ref_sys = ref_linsys.conditioned_gaussian(**SERVE_SYS)
    for tag, cls in (("sync", RefServer), ("async", RefAsync)):
        srv = cls(RefStore(), solver="apc", iters=SERVE_ITERS, batch=2,
                  use_kernel=True, **SERVE_PRM)
        fp = srv.register(ref_sys)
        for b in rhs:
            srv.submit(fp, b)
        ref = srv.drain()
        if tag == "async":
            srv.close()
        np.testing.assert_allclose(got[0][f"{tag}/x"],
                                   np.stack([np.asarray(r.x) for r in ref]),
                                   **X_TOL)
        np.testing.assert_allclose(got[0][f"{tag}/res"],
                                   [r.residual for r in ref], rtol=1e-6)
        assert int(got[0][f"{tag}/batches"]) == 3
        assert int(got[1][f"{tag}/batches"]) == 3
        assert "rank 0 admits" in str(got[1][f"{tag}/refused"])
    lines = list(got[0]["cli"])
    assert "mesh backend over 2 rank(s), gloo: rank 0 admits" in lines
    assert any(ln.startswith("served 5 requests") for ln in lines), lines
    assert list(got[1]["cli"]) == []
