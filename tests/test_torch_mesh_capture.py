"""The mesh's step loops through the compile-once drivers (ROADMAP A14c),
on the CPU.

Every mesh history (a solve, ``solve_many``, a mesh-served batch, the
redundant runner) runs through the drivers of ``solvers.executor``:
``run_history``'s chunks, ``LocalExecutor``'s programs, ``StepProgram``'s
one step.  They capture CUDA graphs only where ``executor.capturable``
finds the tensors on the card and every group of the mesh on NCCL; here
(gloo, the CPU) the same chunked bodies run through the same static
buffers eagerly, and must be ``torch.equal`` to the plain eager loop
(``executor.disable_capture``) at every iteration count around the
chunk (0, 1, 15, 16, 17, 35 against CHUNK = 16), on one rank in-process
and on two spawned gloo ranks (1 x 2 and 2 x 1, each case under a
deadline of ``DEADLINE`` seconds).  With the card and NCCL faked
(``test_torch_smoke.fake_cuda_graphs``: a capture records the body's
tensor operations and refuses a host sync, a replay re-runs them) the
captured loops are ``torch.equal`` to the eager ones, capture once, and
leave no graph alive after their owner.  The mesh stays held to the
reference's local backend at tests/test_mesh_backend.py's tolerances
(x rtol 1e-8 / atol 1e-10, histories rtol 1e-6 / atol 1e-12), as
tests/test_torch_mesh.py holds it.
"""
import contextlib
import gc
import os
import time
import warnings
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

from repro import solvers as ref_solvers  # noqa: E402
from repro.data import linsys as ref_linsys  # noqa: E402
from repro_torch import solvers  # noqa: E402
from repro_torch.analysis import tracecheck  # noqa: E402
from repro_torch.data import linsys  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.solvers import executor, redundant  # noqa: E402
from repro_torch.solvers import mesh as mesh_backend  # noqa: E402
from repro_torch.solvers.capability import ExecutionPlan  # noqa: E402

torch.set_num_threads(1)

ALL = ["apc", "cimmino", "consensus", "dgd", "dhbm", "dnag", "madmm",
       "pdhbm"]
PROJ = ["apc", "consensus", "cimmino"]
ITERS = (0, 1, 15, 16, 17, 35)
K = 3
X_TOL = dict(rtol=1e-8, atol=1e-10)
H_TOL = dict(rtol=1e-6, atol=1e-12)
DEADLINE = 180.0
SYS = dict(n=64, m=4, cond=10.0, seed=3)
SPARSE = dict(n=192, m=4, bandwidth=6, seed=0)


@pytest.fixture(scope="module", autouse=True)
def group(tmp_path_factory):
    """A one-rank gloo group from a FileStore, for this module alone."""
    if dist.is_initialized():
        dist.destroy_process_group()
    store = dist.FileStore(str(tmp_path_factory.mktemp("group") / "store"),
                           1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def systems():
    return {"dense": (ref_linsys.conditioned_gaussian(**SYS),
                      linsys.conditioned_gaussian(**SYS, device="cpu")),
            "sparse": (ref_linsys.banded_system(**SPARSE),
                       linsys.banded_system(**SPARSE, device="cpu"))}


@pytest.fixture(scope="module")
def mesh(group):
    return mesh_lib.solver_mesh(1, 1, device="cpu")


@pytest.fixture
def fused(monkeypatch):
    """The local kernel path pinned fused, as tests/test_torch_mesh.py
    pins it (the mesh's asks no verdict)."""
    monkeypatch.setenv("REPRO_KERNEL_ENGINE", "fused")


@pytest.fixture
def driver(monkeypatch):
    """The contexts of every ``executor.run_history`` call, in order, and
    the number of static-buffer chunk loops (``executor._Loop``) built."""
    seen, loops = [], []
    real = executor.run_history

    def spy(h, state, iters, **kw):
        seen.append(h.ctx)
        return real(h, state, iters, **kw)

    class Loop(executor._Loop):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            loops.append(self)
    monkeypatch.setattr(executor, "run_history", spy)
    monkeypatch.setattr(executor, "_Loop", Loop)
    return seen, loops


@pytest.fixture
def nccl(monkeypatch):
    """The card and NCCL, faked: CUDA tensors and NCCL groups for the
    capture predicate, and the faked card's CUDA graphs."""
    from test_torch_smoke import fake_cuda_graphs
    fake_cuda_graphs(monkeypatch)
    monkeypatch.setattr(executor, "_capturing", lambda b: True)
    monkeypatch.setattr(executor, "_cuda_backend", lambda group: "nccl")


def _plan(mesh, **kw):
    return ExecutionPlan(backend="mesh", mesh=mesh, **kw)


def _rhs(sys_, k, seed=5):
    return np.random.default_rng(seed).standard_normal((k, sys_.N))


class _Many:
    """What ``solve_many_mesh`` computes, without its ``SolveResult``
    (whose ``iters_to_tol`` needs one record at least)."""

    def __init__(self, s, sys_, plan, iters, k, prm):
        ctx = mesh_backend.make_context(plan.mesh, sys_)
        A, _, _, _, f = mesh_backend._place(s, sys_, ctx, prm, None,
                                            use_kernel=plan.kernel)
        runner = mesh_backend.batched_runner(
            s, ctx, prm, iters, use_kernel=plan.kernel,
            a_placement=mesh_backend.operand_placement(sys_),
            fused_residual=plan.kernel)
        Bb = mesh_backend._shard(
            torch.as_tensor(_rhs(sys_, k)).reshape(k, sys_.m, sys_.p),
            runner.Bb_placement, ctx, torch.device("cpu"))
        self.state, self.x, self.residuals = runner.run(
            A, Bb, f, runner.init(f, Bb))
        self.errors = None


def _run(s, sys_, plan, iters, k, prm):
    if k == 1:
        return s.solve(sys_, iters=iters, plan=plan, **prm)
    if iters == 0:
        return _Many(s, sys_, plan, iters, k, prm)
    return s.solve_many(sys_, _rhs(sys_, k), iters=iters, plan=plan, **prm)


def _equal(a, b) -> bool:
    same = torch.equal(a.x, b.x) and torch.equal(a.residuals, b.residuals)
    if a.errors is not None or b.errors is not None:
        same = same and torch.equal(a.errors, b.errors)
    return same and a.state.t == b.state.t


# ---------------------------------------------------------------------------
# the capture predicate
# ---------------------------------------------------------------------------


class _Ctx:
    """A psum context over ``n`` stand-in process groups."""

    def __init__(self, n):
        self._groups = tuple(object() for _ in range(n))

    def groups(self):
        return self._groups


@pytest.mark.parametrize("disabled", [False, True])
@pytest.mark.parametrize("backend", ["nccl", "gloo", "cpu:gloo,cuda:nccl",
                                     "cpu:nccl,cuda:gloo"])
@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_capture_predicate(monkeypatch, device, backend, disabled):
    """Captured iff the tensors are on the card, capture is on, and every
    group carries CUDA collectives over NCCL; the local context has no
    group."""
    monkeypatch.setattr(executor.ops, "on_cuda",
                        lambda op, *t: device == "cuda")
    monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
    nccl = backend in ("nccl", "cpu:gloo,cuda:nccl")
    b = torch.zeros(2)
    with (executor.disable_capture() if disabled
          else contextlib.nullcontext()):
        on = device == "cuda" and not disabled
        assert executor.capturable(_Ctx(2), b) is (on and nccl)
        assert executor.capturable(executor.LOCAL_PSUM, b) is on


def test_capture_predicate_needs_every_group(monkeypatch):
    """One gloo group among NCCL ones keeps the history eager."""
    ctx = _Ctx(2)
    names = dict(zip(ctx.groups(), ("nccl", "gloo")))
    monkeypatch.setattr(executor.ops, "on_cuda", lambda op, *t: True)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: names[group])
    assert not executor.capturable(ctx, torch.zeros(2))
    names[ctx.groups()[1]] = "nccl"
    assert executor.capturable(ctx, torch.zeros(2))


def test_mesh_context_groups_are_read(systems, mesh, monkeypatch):
    """A real ``MeshContext`` names its worker and model groups; on this
    gloo group even tensors on the card would run eagerly."""
    sys_ = systems["dense"][1]
    ctx = mesh_backend.make_context(mesh, sys_)
    assert len(ctx.groups()) == 2 and {executor._cuda_backend(g)
                                       for g in ctx.groups()} == {"gloo"}
    monkeypatch.setattr(executor, "_capturing", lambda b: True)
    assert not executor.capturable(ctx, sys_.b_blocks)
    sparse = mesh_backend.make_context(mesh, systems["sparse"][1])
    assert len(sparse.groups()) == 1        # the model axis forced off


# ---------------------------------------------------------------------------
# one rank: the chunked driver against the eager loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("iters", ITERS)
@pytest.mark.parametrize("k", [1, K])
@pytest.mark.parametrize("kernel", [True, False],
                         ids=["kernel", "unfused"])
@pytest.mark.parametrize("structure", ["dense", "sparse"])
@pytest.mark.parametrize("name", ["apc", "cimmino"])
def test_one_rank_chunked_driver_equals_eager(systems, mesh, fused, driver,
                                              name, structure, kernel, k,
                                              iters):
    """A mesh solve (k = 1) or ``solve_many`` (k = 3) goes through
    ``run_history`` with its ``MeshContext`` — the eager head, a
    static-buffer chunk where one fits after it (35 = 16 + 16 + 3), the
    tail — and is bit-equal to the plain eager loop, which the same call
    runs under ``disable_capture``; the kernel path runs its plain
    versions here."""
    seen, loops = driver
    sys_ = systems[structure][1]
    s = solvers.get(name)
    prm = s.resolve_params(sys_)
    plan = _plan(mesh, kernel=kernel)
    r = _run(s, sys_, plan, iters, k, prm)
    assert len(seen) == 1 and isinstance(seen[0], mesh_backend.MeshContext)
    assert len(loops) == (1 if iters >= 2 * executor.CHUNK else 0)
    with executor.disable_capture():
        e = _run(s, sys_, plan, iters, k, prm)
    assert len(seen) == 2 and len(loops) == (iters >= 2 * executor.CHUNK)
    assert _equal(r, e)
    assert r.residuals.shape[-1] == iters


@pytest.mark.parametrize("k", [1, K])
@pytest.mark.parametrize("structure", ["dense", "sparse"])
@pytest.mark.parametrize("name", ["apc", "cimmino"])
def test_one_rank_driver_held_to_reference_local(systems, mesh, name,
                                                 structure, k):
    """The chunked mesh history (35 iterations: head, one replay-sized
    chunk, tail) against the reference's local backend."""
    ref_sys, sys_ = systems[structure]
    prm = ref_solvers.get(name).resolve_params(ref_sys)
    r = _run(solvers.get(name), sys_, _plan(mesh), 35, k, prm)
    ref = ref_solvers.get(name)
    rl = (ref.solve(ref_sys, iters=35, **prm) if k == 1 else
          ref.solve_many(ref_sys, _rhs(sys_, k), iters=35, **prm))
    np.testing.assert_allclose(r.x.numpy(), np.asarray(rl.x), **X_TOL)
    np.testing.assert_allclose(r.residuals.numpy(),
                               np.asarray(rl.residuals), **H_TOL)


# ---------------------------------------------------------------------------
# one rank, the card and NCCL faked: the captured loops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, K])
@pytest.mark.parametrize("structure", ["dense", "sparse"])
@pytest.mark.parametrize("name", PROJ)
def test_faked_nccl_kernel_path_captured_equals_eager(systems, mesh, fused,
                                                      nccl, name, structure,
                                                      k):
    """On NCCL the kernel path's history is one capture, bit-equal to the
    eager loop."""
    sys_ = systems[structure][1]
    s = solvers.get(name)
    prm = s.resolve_params(sys_)
    plan = _plan(mesh, kernel=True)
    with tracecheck() as tc:
        r = _run(s, sys_, plan, 35, k, prm)
    label = f"{name}.mesh" if k == 1 else f"{name}.mesh_many"
    assert [e.fun for e in tc.traces()] == [f"capture {label}"]
    with executor.disable_capture():
        e = _run(s, sys_, plan, 35, k, prm)
    assert _equal(r, e)


@pytest.mark.parametrize("name", ALL)
def test_faked_nccl_unfused_captured_equals_eager(systems, mesh, nccl, name):
    """Every solver's unfused mesh step captures (no host sync in its
    ``mesh_*`` hooks: the faked capture refuses one) and replays to the
    eager loop's bits."""
    sys_ = systems["dense"][1]
    s = solvers.get(name)
    prm = s.resolve_params(sys_)
    with tracecheck() as tc:
        r = s.solve(sys_, iters=35, plan=_plan(mesh), **prm)
    assert len(tc.traces("capture *")) == 1
    with executor.disable_capture():
        e = s.solve(sys_, iters=35, plan=_plan(mesh), **prm)
    assert _equal(r, e)


def _served(srv, fp, B):
    for b in B:
        srv.submit(fp, b)
    return srv.drain()


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel",
                                                       "unfused"])
def test_mesh_executor_one_program_a_key(systems, mesh, fused, kernel):
    """Three batches of one key on the mesh server: one build, one
    program; each batch through ``LocalExecutor`` with the mesh's
    context; ``close`` frees the program."""
    sys_ = systems["dense"][1]
    s = solvers.get("apc")
    prm = s.resolve_params(sys_)
    srv = solvers.LinsysServer(solvers.FactorStore(), solver="apc",
                               iters=20, batch=2, backend="mesh", mesh=mesh,
                               use_kernel=kernel, **prm)
    fp = srv.register(sys_)
    out = _served(srv, fp, _rhs(sys_, 6))
    (ex,) = srv._executors.values()
    assert isinstance(ex.local, executor.LocalExecutor)
    assert ex.local.ctx is ex.ctx
    assert (ex.builds, ex.captures, ex.cache_size()) == (1, 0, 1)
    assert srv.stats.batches == 3 and srv.jit_cache_size() == 1
    want = s.solve_many(sys_, _rhs(sys_, 6)[:2], iters=20,
                        plan=ExecutionPlan(kernel=kernel), **prm)
    np.testing.assert_allclose(np.stack([r.x for r in out[:2]]),
                               want.x.numpy(), **X_TOL)
    srv.close()
    assert srv.jit_cache_size() == 0


@pytest.mark.parametrize("iters", [i for i in ITERS if i])
def test_mesh_server_program_equals_eager(systems, mesh, fused, iters):
    """A mesh-served batch (``LocalExecutor``'s static-buffer program with
    the mesh's context) is bit-equal to the same server under
    ``disable_capture()`` at every iteration count (a served answer needs
    one record at least), cold and then warm."""
    sys_ = systems["dense"][1]
    prm = solvers.get("apc").resolve_params(sys_)
    kw = dict(solver="apc", iters=iters, batch=2, use_kernel=True,
              warm_start=True, backend="mesh", mesh=mesh, **prm)
    B = np.concatenate([_rhs(sys_, 2)] * 2)
    srv = solvers.LinsysServer(solvers.FactorStore(), **kw)
    out = _served(srv, srv.register(sys_), B)
    with executor.disable_capture():
        eager = solvers.LinsysServer(solvers.FactorStore(), **kw)
        e_out = _served(eager, eager.register(sys_), B)
    assert [r.warm for r in out] == [False, False, True, True]
    for got, e in zip(out, e_out):
        assert np.array_equal(got.x, e.x) and got.residual == e.residual


@pytest.mark.parametrize("iters", ITERS)
def test_redundant_runner_equals_eager_at_every_length(systems, mesh,
                                                       iters):
    """The redundant mesh runner's step program against its eager loop,
    a segment of every length around the chunk."""
    sys_ = systems["dense"][1]
    s = solvers.get("apc")
    eng = redundant.RedundantEngine(s, sys_, r=2, backend="mesh", mesh=mesh,
                                    **s.resolve_params(sys_))
    W = eng.lower(np.ones((iters, sys_.m), bool))
    st0 = eng.init_state()
    got = eng.run(st0, W)
    with executor.disable_capture():
        want = eng.run(st0, W)
    assert torch.equal(got[0].x, want[0].x) and got[0].t == want[0].t
    assert torch.equal(got[1], want[1]) and got[1].shape == (iters,)


def test_faked_nccl_mesh_server_captures_once(systems, mesh, fused, nccl):
    """On NCCL a mesh server captures one graph a key at its first batch;
    later batches are quiet under ``tracecheck(steady_state=True)`` and
    bit-equal to the eager mesh server's; x within the mesh contract of
    the local server's."""
    sys_ = systems["dense"][1]
    prm = solvers.get("apc").resolve_params(sys_)
    B = _rhs(sys_, 6)
    kw = dict(solver="apc", iters=20, batch=2, use_kernel=True, **prm)
    srv = solvers.LinsysServer(solvers.FactorStore(), backend="mesh",
                               mesh=mesh, **kw)
    fp = srv.register(sys_)
    for b in B:
        srv.submit(fp, b)
    with tracecheck() as tc:
        out = srv.step()
    assert [e.fun for e in tc.traces()] == ["build apc.cold",
                                            "capture apc.cold"]
    with tracecheck(steady_state=True):
        out += srv.step() + srv.step()
    (ex,) = srv._executors.values()
    assert (ex.builds, ex.captures, ex.cache_size()) == (1, 1, 1)
    with executor.disable_capture():
        eager = solvers.LinsysServer(solvers.FactorStore(), backend="mesh",
                                     mesh=mesh, **kw)
        e_out = _served(eager, eager.register(sys_), B)
    local = solvers.LinsysServer(solvers.FactorStore(), **kw)
    l_out = _served(local, local.register(sys_), B)
    for got, e, loc in zip(out, e_out, l_out):
        assert np.array_equal(got.x, e.x) and got.residual == e.residual
        np.testing.assert_allclose(got.x, loc.x, **X_TOL)
    srv.close()
    assert ex.cache_size() == 0


@pytest.mark.parametrize("faked", [False, True], ids=["gloo", "nccl"])
@pytest.mark.parametrize("name", PROJ)
def test_redundant_runner_segments_equal_one_run(systems, mesh, request,
                                                 name, faked):
    """The redundant mesh runner's one step program: a history split into
    segments is bit-equal to one run and to the eager loop; one capture
    on NCCL, none on gloo; one program, flat across segments."""
    if faked:
        request.getfixturevalue("nccl")
    sys_ = systems["dense"][1]
    s = solvers.get(name)
    eng = redundant.RedundantEngine(s, sys_, r=2, backend="mesh", mesh=mesh,
                                    **s.resolve_params(sys_))
    alive = np.ones((30, sys_.m), bool)
    alive[np.arange(30), np.arange(30) % sys_.m] = False
    W = eng.lower(alive)
    st0 = eng.init_state()
    one = eng.run(st0, W)
    first = eng.run(st0, W[:13])
    second = eng.run(first[0], W[13:])
    with executor.disable_capture():
        eager = eng.run(st0, W)
    for got in (second, eager):
        assert torch.equal(s.extract(got[0]), s.extract(one[0]))
        assert got[0].t == one[0].t
    assert torch.equal(torch.cat([first[1], second[1]]), one[1])
    assert torch.equal(eager[1], one[1])
    assert (eng.captures, eng.cache_size()) == (int(faked), 1)


def test_faked_nccl_graphs_die_with_their_owners(systems, mesh, fused,
                                                 monkeypatch):
    """No mesh graph outlives its owner by more than reference counting:
    a solve's dies with the call, a server's at ``close``, a redundant
    runner's with the engine.  A graph left to the cyclic collector could
    die inside a later capture, or after its process group."""
    from test_torch_smoke import _Graph, fake_cuda_graphs
    alive = weakref.WeakSet()

    class Tracked(_Graph):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            alive.add(self)

    fake_cuda_graphs(monkeypatch)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Tracked)
    monkeypatch.setattr(executor, "_capturing", lambda b: True)
    monkeypatch.setattr(executor, "_cuda_backend", lambda group: "nccl")
    sys_ = systems["dense"][1]
    s = solvers.get("apc")
    prm = s.resolve_params(sys_)
    s.solve(sys_, iters=35, plan=_plan(mesh, kernel=True), **prm)
    gc.collect()
    gc.disable()
    try:
        s.solve(sys_, iters=35, plan=_plan(mesh, kernel=True), **prm)
        assert len(alive) == 0
        srv = solvers.LinsysServer(solvers.FactorStore(), solver="apc",
                                   iters=20, batch=2, backend="mesh",
                                   mesh=mesh, use_kernel=True, **prm)
        _served(srv, srv.register(sys_), _rhs(sys_, 2))
        assert len(alive) == 1
        srv.close()
        assert len(alive) == 0
        eng = redundant.RedundantEngine(s, sys_, r=2, backend="mesh",
                                        mesh=mesh, **prm)
        eng.run(eng.init_state(), eng.lower(np.ones((3, sys_.m), bool)))
        assert len(alive) == 1 and eng.captures == 1
        del eng
        assert len(alive) == 0
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# two spawned gloo ranks
# ---------------------------------------------------------------------------


def _child(rank, world, out):
    torch.set_num_threads(1)
    warnings.simplefilter("ignore")
    store = dist.FileStore(os.path.join(out, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        got = _ranks_case(rank)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out, f"rank{rank}.npz"), **got)


def _ranks_case(rank):
    """On meshes 1 x 2 and 2 x 1: every mesh history through its driver,
    bit-equal to the eager loop at every iteration count, with no capture
    (gloo); the mesh server's one program a key; the redundant runner's
    segments."""
    os.environ["REPRO_KERNEL_ENGINE"] = "fused"
    seen = []
    real = executor.run_history

    def spy(h, state, iters, **kw):
        seen.append(type(h.ctx).__name__)
        return real(h, state, iters, **kw)
    executor.run_history = spy
    dense = linsys.conditioned_gaussian(**SYS, device="cpu")
    sparse = linsys.banded_system(**SPARSE, device="cpu")
    got = {}
    with tracecheck() as tc:
        for shape in ((1, 2), (2, 1)):
            mesh = mesh_lib.make_mesh(shape, ("data", "model"),
                                      device="cpu")
            tag = "x".join(map(str, shape))
            cases = (("apc", dense, True, 1), ("cimmino", dense, False, K),
                     ("consensus", dense, True, K),
                     ("apc", sparse, True, K), ("cimmino", sparse, True, 1))
            same = []
            for name, sys_, kernel, k in cases:
                s = solvers.get(name)
                prm = s.resolve_params(sys_)
                for iters in ITERS:
                    r = _run(s, sys_, _plan(mesh, kernel=kernel), iters, k,
                             prm)
                    with executor.disable_capture():
                        e = _run(s, sys_, _plan(mesh, kernel=kernel), iters,
                                 k, prm)
                    same.append(_equal(r, e))
            got[f"{tag}/same"] = np.asarray(same)
            srv = solvers.LinsysServer(
                solvers.FactorStore(), solver="apc", iters=20, batch=2,
                backend="mesh", mesh=mesh, use_kernel=True,
                **solvers.get("apc").resolve_params(dense))
            fp = srv.register(dense)
            if rank == 0:
                with srv:
                    out = _served(srv, fp, _rhs(dense, 6))
                got[f"{tag}/served_x"] = np.stack([r.x for r in out])
            else:
                got[f"{tag}/batches"] = np.asarray(srv.serve_follower())
            (ex,) = srv._executors.values()
            got[f"{tag}/programs"] = np.asarray(
                [ex.builds, ex.captures, ex.cache_size()])
            s = solvers.get("apc")
            eng = redundant.RedundantEngine(s, dense, r=2, backend="mesh",
                                            mesh=mesh,
                                            **s.resolve_params(dense))
            W = eng.lower(np.ones((30, dense.m), bool))
            st0 = eng.init_state()
            one = eng.run(st0, W)
            a = eng.run(st0, W[:13])
            b = eng.run(a[0], W[13:])
            got[f"{tag}/red"] = np.asarray([
                torch.equal(b[0].x, one[0].x),
                torch.equal(torch.cat([a[1], b[1]]), one[1]),
                eng.cache_size() == 1, eng.captures == 0])
    got["captures"] = np.asarray(len(tc.traces("capture *")))
    got["driver"] = np.asarray(seen)
    return got


def test_two_gloo_ranks_run_the_drivers_eagerly(tmp_path):
    """Two spawned gloo ranks: every mesh history on 1 x 2 and 2 x 1
    through ``run_history`` (the ranks' contexts), bit-equal to the eager
    loop, zero captures; the server's one program a key on both ranks,
    freed at the stop flag; the redundant runner's segments."""
    import torch.multiprocessing as mp
    out = str(tmp_path)
    ctx = mp.start_processes(_child, args=(2, out), nprocs=2, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + DEADLINE
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"2 ranks did not finish within "
                                   f"{DEADLINE:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    ranks = [dict(np.load(os.path.join(out, f"rank{r}.npz"),
                          allow_pickle=True)) for r in range(2)]
    for g in ranks:
        assert int(g["captures"]) == 0
        # 5 cases x 6 iteration counts x (the run, its eager twin) on
        # each of the two meshes
        assert list(g["driver"]) == ["MeshContext"] * 120
        for tag in ("1x2", "2x1"):
            assert g[f"{tag}/same"].all() and g[f"{tag}/same"].size == 30
            assert g[f"{tag}/programs"].tolist() == [1, 0, 0], tag
            assert g[f"{tag}/red"].all(), tag
    for tag in ("1x2", "2x1"):
        assert int(ranks[1][f"{tag}/batches"]) == 3
        assert ranks[0][f"{tag}/served_x"].shape == (6, SYS["n"])
