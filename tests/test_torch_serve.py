"""The port's serving path against the reference's contracts.

``repro_torch.solvers.serve.LinsysServer`` and ``.pipeline
.AsyncLinsysServer`` are held to the local cases of
tests/test_linsys_server.py and tests/test_pipeline_server.py (the mesh
cases wait for ROADMAP A14b): FIFO coalescing and padding, true no-op
``step``/``drain``, the validation messages, served x ``array_equal`` to
the port's ``solve_many``, the steady state quiet under
``tracecheck(steady_state=True)``, warm-start gating, async ≡ sync bit
for bit, backpressure and shedding.  Beyond them: served x against the
reference server's at the parity tolerances; ``precision="mixed"``
through the async server caches the bf16 entry the sync server caches
(the reference's async server caches float64 factors under the mixed
key, ROADMAP C); a store eviction releases the evicted system's
placement and programs; only a build and its capture hold cuSOLVER; a
default-built executor places on the card; the pipeline passes the reference's lock-discipline checker;
and the ``serve_linsys`` CLI prints the reference's lines.  Two tests run
the captured path itself through the faked card's CUDA graphs of
tests/test_torch_smoke.py, one of them with two executors capturing on
two pool threads at once.
"""
import contextlib
import io
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import solvers as ref_solvers  # noqa: E402
from repro.analysis import check_locks  # noqa: E402
from repro.analysis.lint import SourceFile  # noqa: E402
from repro.data import linsys as ref_linsys  # noqa: E402
from repro.launch import serve_linsys as ref_cli  # noqa: E402
from repro.solvers import pipeline as ref_pipeline  # noqa: E402
from repro.solvers import serve as ref_serve  # noqa: E402
from repro.solvers import store as ref_store  # noqa: E402
from repro_torch import interop, solvers  # noqa: E402
from repro_torch.analysis import tracecheck  # noqa: E402
from repro_torch.data import linsys  # noqa: E402
from repro_torch.launch import serve_linsys as cli  # noqa: E402
from repro_torch.solvers import executor  # noqa: E402
from repro_torch.solvers.pipeline import AsyncLinsysServer, Shed  # noqa: E402
from repro_torch.solvers.serve import LinsysServer  # noqa: E402
from repro_torch.solvers.store import FactorStore  # noqa: E402

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
PRM = {"gamma": 1.0, "eta": 1.0}     # shared explicit params: one
                                     # executor across same-shape systems
HIST = dict(rtol=0, atol=1e-9)       # tests/test_torch_executor.py
X_TOL = dict(rtol=1e-9, atol=1e-12)


@pytest.fixture(scope="module")
def sys_a():
    return linsys.conditioned_gaussian(n=48, m=4, cond=10.0, seed=0,
                                       device="cpu")


@pytest.fixture(scope="module")
def sys_b():
    return linsys.conditioned_gaussian(n=48, m=4, cond=10.0, seed=1,
                                       device="cpu")


def _server(**kw):
    kw = {"solver": "apc", "iters": 5, "batch": 2, **PRM, **kw}
    return LinsysServer(FactorStore(), **kw)


def _async(**kw):
    kw = {"solver": "apc", "iters": 5, "batch": 2, **PRM, **kw}
    return AsyncLinsysServer(FactorStore(), **kw)


def _drive(srv, fps, order, rhs):
    """Submit everything, then drain: with the full backlog queued before
    the pipeline starts, the grouping is the sync step() loop's."""
    tickets = [srv.submit(fps[i], b) for i, b in zip(order, rhs)]
    out = srv.drain()
    srv.close()
    return tickets, out


# ---------------------------------------------------------------------------
# queue semantics
# ---------------------------------------------------------------------------


def test_fifo_coalescing_and_padding(sys_a, sys_b):
    srv = _server()
    fa, fb = srv.register(sys_a), srv.register(sys_b)
    rng = np.random.default_rng(0)
    # a0 a1 b2 a3: [a0,a1], then the OLDEST pending (b2, padded), then
    # [a3, pad]; a3 must NOT jump b2
    for fp in (fa, fa, fb, fa):
        srv.submit(fp, rng.standard_normal(48))
    batches = []
    while True:
        served = srv.step()
        if not served:
            break
        batches.append([r.rid for r in served])
    assert batches == [[0, 1], [2], [3]]
    assert srv.stats.served == 4                 # padding is NOT traffic
    assert srv.stats.padded == 2
    assert srv.stats.batches == 3


def test_same_system_requests_coalesce_past_arrival_gaps(sys_a, sys_b):
    srv = _server(batch=3)
    fa, fb = srv.register(sys_a), srv.register(sys_b)
    rng = np.random.default_rng(0)
    for fp in (fa, fb, fa, fa):
        srv.submit(fp, rng.standard_normal(48))
    assert [r.rid for r in srv.step()] == [0, 2, 3]
    assert [r.rid for r in srv.step()] == [1]


def test_step_and_drain_with_zero_pending_are_true_noops(sys_a):
    srv = _server()
    srv.register(sys_a)
    cache0 = srv.jit_cache_size()
    assert srv.step() == []
    assert srv.drain() == []
    assert srv.stats.executor_builds == 0 and srv.stats.batches == 0
    assert srv.jit_cache_size() == cache0 == 0
    assert len(srv.store) == 0                   # no store traffic either
    srv.submit(srv.register(sys_a), np.zeros(48))
    srv.drain()
    builds, cache1 = srv.stats.executor_builds, srv.jit_cache_size()
    assert srv.step() == [] and srv.drain() == []
    assert srv.stats.executor_builds == builds
    assert srv.jit_cache_size() == cache1 == 1


def test_submit_unknown_fingerprint_names_it(sys_a):
    srv = _server()
    srv.register(sys_a)
    bogus = "cafe" * 16
    with pytest.raises(KeyError, match=bogus):
        srv.submit(bogus, np.zeros(48))


def test_submit_validation(sys_a):
    srv = _server()
    fp = srv.register(sys_a)
    with pytest.raises(KeyError, match="register"):
        srv.submit("deadbeef", np.zeros(48))
    with pytest.raises(ValueError, match="shape"):
        srv.submit(fp, np.zeros(7))
    with pytest.raises(ValueError, match="backend"):
        LinsysServer(FactorStore(), backend="pod")
    with pytest.raises(ValueError, match="batch"):
        LinsysServer(FactorStore(), batch=0)


def test_unported_and_unservable_plans_are_refused():
    # mesh serving is ported (A14b, tests/test_torch_mesh_serve.py): the
    # servers take backend="mesh", loose or on the plan; a mesh with the
    # local backend is the reference's ValueError
    for srv in (LinsysServer(FactorStore(), backend="mesh"),
                LinsysServer(FactorStore(),
                             plan=solvers.ExecutionPlan(backend="mesh")),
                AsyncLinsysServer(FactorStore(), backend="mesh")):
        assert srv.backend == "mesh" and srv.pending() == 0
    with pytest.raises(ValueError, match="backend='mesh'"):
        AsyncLinsysServer(FactorStore(), mesh=object())
    with pytest.raises(ValueError, match="EITHER"):
        LinsysServer(FactorStore(), plan=solvers.ExecutionPlan(),
                     model_axis=None)
    with pytest.raises(ValueError, match="not servable"):
        LinsysServer(FactorStore(),
                     plan=solvers.ExecutionPlan(redundancy=2))
    with pytest.raises(ValueError, match="EITHER"):
        LinsysServer(FactorStore(), plan=solvers.ExecutionPlan(),
                     use_kernel=True)
    with pytest.raises(ValueError, match="warm_state"):
        LinsysServer(FactorStore(),
                     plan=solvers.ExecutionPlan(factors=object()))
    with pytest.raises(ValueError, match="kernel path"):
        LinsysServer(FactorStore(), solver="dgd", use_kernel=True)
    with pytest.raises(ValueError, match="use_kernel=True"):
        LinsysServer(FactorStore(), precision="mixed")


def test_register_checks_capability():
    ls = linsys.tall_gaussian(N=96, n=48, m=4, noise=0.05, seed=0,
                              device="cpu")
    with pytest.raises(solvers.CapabilityError, match="register"):
        _server().register(ls)
    # a sparse system keeps APC's kernel path, so a mixed server takes it
    sp = linsys.banded_system(n=64, m=4, bandwidth=4, seed=0, device="cpu")
    srv = _server(use_kernel=True, precision="mixed")
    fp = srv.register(sp)
    srv.submit(fp, np.ones(64))
    srv.drain()
    assert srv.store._mem[fp].A.vals.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# correctness: served results match the drivers and the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel,precision", [
    (False, "default"), (True, "default"), (True, "mixed")])
def test_served_results_match_solve_many(sys_a, kernel, precision):
    srv = _server(iters=60, use_kernel=kernel, precision=precision)
    fp = srv.register(sys_a)
    B = np.random.default_rng(3).standard_normal((2, sys_a.N))
    for b in B:
        srv.submit(fp, b)
    served = srv.drain()
    ref = solvers.get("apc").solve_many(
        sys_a, B, iters=60,
        plan=solvers.ExecutionPlan(kernel=kernel, precision=precision),
        **PRM)
    for i, r in enumerate(served):
        assert isinstance(r.x, np.ndarray)
        assert np.array_equal(r.x, ref.x[i].numpy())
        assert r.residual == float(ref.residuals[i, -1])
    if precision == "mixed":
        assert srv.store._mem[fp].A.dtype == torch.bfloat16


@pytest.mark.parametrize("name,kind", [
    ("apc", "dense"), ("cimmino", "dense"), ("cimmino", "ls"),
    ("apc", "sparse")])
def test_served_results_match_reference_server(name, kind):
    """The same traffic through the reference's server and the port's:
    x at the parity tolerances, the same fingerprints, the same store
    traffic and the same grouping."""
    rsys = {"dense": lambda: ref_linsys.conditioned_gaussian(
                n=48, m=4, cond=10.0, seed=0),
            "sparse": lambda: ref_linsys.banded_system(
                n=96, m=4, bandwidth=6, seed=0),
            "ls": lambda: ref_linsys.tall_gaussian(
                N=96, n=48, m=4, noise=0.05, seed=0)}[kind]()
    psys = interop.system_from_numpy(
        np.asarray(rsys.A_blocks), np.asarray(rsys.b_blocks),
        None if rsys.x_true is None else np.asarray(rsys.x_true),
        mode=rsys.mode,
        cols=None if rsys.cols is None else np.asarray(rsys.cols),
        device="cpu")
    prm = {k: float(v) for k, v in
           ref_solvers.get(name).resolve_params(rsys).items()}
    rhs = np.random.default_rng(4).standard_normal((3, rsys.N))
    rsrv = ref_serve.LinsysServer(ref_store.FactorStore(), solver=name,
                                  iters=37, batch=2, **prm)
    psrv = LinsysServer(FactorStore(), solver=name, iters=37, batch=2, **prm)
    rfp, pfp = rsrv.register(rsys), psrv.register(psys)
    assert rfp == pfp
    for b in rhs:
        rsrv.submit(rfp, b)
        psrv.submit(pfp, b)
    rout, pout = rsrv.drain(), psrv.drain()
    assert [r.rid for r in pout] == [r.rid for r in rout] == [0, 1, 2]
    tol = HIST if kind != "sparse" else dict(rtol=1e-6, atol=1e-12)
    for r, p in zip(rout, pout):
        np.testing.assert_allclose(p.x, np.asarray(r.x), **X_TOL)
        np.testing.assert_allclose(p.residual, r.residual, **tol)
        assert p.iters_to_tol == r.iters_to_tol
    assert (psrv.store.stats.misses, psrv.store.stats.hits) == \
        (rsrv.store.stats.misses, rsrv.store.stats.hits) == (1, 1)
    assert (psrv.stats.served, psrv.stats.padded) == \
        (rsrv.stats.served, rsrv.stats.padded) == (3, 1)


def test_residuals_converge_and_store_amortizes(sys_a, sys_b):
    store = FactorStore()
    srv = LinsysServer(store, solver="apc", iters=300, tol=1e-6, batch=1)
    fps = [srv.register(sys_a), srv.register(sys_b)]
    rng = np.random.default_rng(0)
    for i in range(6):
        srv.submit(fps[i % 2], rng.standard_normal(48))
    out = srv.drain()
    assert all(r.residual < 1e-6 and r.iters_to_tol != -1 for r in out)
    assert store.stats.misses == 2 and store.stats.hits == 4


# ---------------------------------------------------------------------------
# compile-once executors
# ---------------------------------------------------------------------------


def test_executor_shared_across_same_shape_systems(sys_a, sys_b):
    srv = _server(iters=10)
    fps = [srv.register(sys_a), srv.register(sys_b)]
    rng = np.random.default_rng(0)
    for i in range(8):
        srv.submit(fps[i % 2], rng.standard_normal(48))
    srv.drain()
    assert srv.stats.executor_builds == 1        # same (shapes, params) key
    # one program per placed system
    assert srv.jit_cache_size() == 2


def test_executor_key_is_the_references(sys_a):
    srv = _server(iters=10, use_kernel=True)
    fp = srv.register(sys_a)
    key = srv._systems[fp].executor_key
    ref_sig = ref_solvers.ExecutionPlan(kernel=True).signature()
    assert key == ("apc", 4, 12, 48, "torch.float64", "dense", "square",
                   tuple(sorted(PRM.items())), ref_sig, 2, 10)


def test_steady_state_never_retraces(sys_a, sys_b):
    srv = _server(iters=10)
    fps = [srv.register(sys_a), srv.register(sys_b)]
    rng = np.random.default_rng(0)
    for fp in fps:
        srv.submit(fp, rng.standard_normal(48))
        srv.submit(fp, rng.standard_normal(48))
        srv.step()
    with tracecheck(steady_state=True):
        for i in range(5):
            srv.submit(fps[i % 2], rng.standard_normal(48))
            srv.submit(fps[i % 2], rng.standard_normal(48))
            srv.step()


def test_distinct_params_get_distinct_executors(sys_a, sys_b):
    srv = LinsysServer(FactorStore(), solver="apc", iters=10, batch=2)
    fps = [srv.register(sys_a), srv.register(sys_b)]
    rng = np.random.default_rng(0)
    for fp in fps:
        srv.submit(fp, rng.standard_normal(48))
    srv.drain()
    assert srv.stats.executor_builds == 2


def test_eviction_drops_the_replaced_placement(sys_a, sys_b):
    """A store of capacity 1 over two systems: every batch evicts the
    other system's entry, and the server releases that system's placement
    and the executor's program that reads it at once, whether or not the
    system is requested again.  The executor (shared: same key) holds the
    one LIVE placement's program, and no program holds an evicted
    entry."""
    store = FactorStore(capacity=1)
    srv = LinsysServer(store, solver="apc", iters=5, batch=1, **PRM)
    fps = [srv.register(sys_a), srv.register(sys_b)]
    rng = np.random.default_rng(1)
    for i in range(6):
        srv.submit(fps[i % 2], rng.standard_normal(48))
        srv.step()
        (ex,) = srv._executors.values()
        live, gone = srv._systems[fps[i % 2]], srv._systems[fps[1 - i % 2]]
        assert ex.cache_size() == 1, i
        (prog,) = ex._programs.values()
        assert prog.factors is live.factors_placed
        assert live.factors_placed is store._mem[fps[i % 2]]
        assert gone.placed_src is None and gone.factors_placed is None
    assert store.stats.evictions == 5 and store.stats.misses == 6
    assert ex.builds == 6                     # every re-placement rebuilds


def test_evicted_system_never_requested_again_is_released(sys_a, sys_b):
    """A system whose entry the LRU evicts and which gets no more
    requests keeps nothing: its placement and its program go at the next
    batch of any system, also across executors (distinct parameters)."""
    store = FactorStore(capacity=1)
    srv = LinsysServer(store, solver="apc", iters=5, batch=1)
    fa = srv.register(sys_a, **PRM)
    fb = srv.register(sys_b, gamma=1.0, eta=0.5)
    rng = np.random.default_rng(2)
    srv.submit(fa, rng.standard_normal(48))
    srv.step()
    ex_a = srv._executors[srv._systems[fa].executor_key]
    assert ex_a.cache_size() == 1
    for _ in range(2):
        srv.submit(fb, rng.standard_normal(48))
        srv.step()
        assert ex_a.cache_size() == 0
        assert srv._systems[fa].placed_src is None
        assert fa not in store
    ex_b = srv._executors[srv._systems[fb].executor_key]
    assert ex_b is not ex_a and ex_b.cache_size() == 1
    assert srv.jit_cache_size() == 1


def test_default_executor_places_on_the_card(sys_a, monkeypatch):
    """``LocalExecutor`` takes no device: a batch goes where the placed A
    lies, and without an A to the port's default device, the card (on a
    host without one, ``device.resolve`` refuses)."""
    ex = executor.LocalExecutor(solvers.get("apc"), PRM, 3)
    Bb = np.zeros((2, sys_a.m, sys_a.p))
    A, _ = ex.place_system(sys_a, None)
    assert ex.place_B(Bb, A).device == sys_a.device
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ex.place_B(Bb)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    asked = []
    as_tensor = torch.as_tensor
    monkeypatch.setattr(torch, "as_tensor", lambda x, device=None: (
        asked.append(device), as_tensor(x))[1])
    ex.place_B(Bb)
    assert asked == [torch.device("cuda")]


def test_only_captures_hold_cusolver(sys_a, monkeypatch):
    """The cuSOLVER preference is held around a build and its capture,
    never around ``init`` (eager, outside the graph, as ``solve_many``'s)
    or a replay; and a section on the process's own preference (a store
    miss on the assembly thread) waits while another thread captures, so
    a factorization's library never depends on the schedule."""
    import threading
    from test_torch_smoke import _Graph, fake_cuda_graphs
    fake_cuda_graphs(monkeypatch)
    monkeypatch.setattr(executor, "_capturing", lambda b: True)
    lib = torch.backends.cuda.preferred_linalg_library
    seen = []
    s = solvers.get("apc")
    init, replay = s.init, _Graph.replay
    monkeypatch.setattr(s, "init", lambda *a: (seen.append(("init", lib())),
                                               init(*a))[1])
    monkeypatch.setattr(_Graph, "replay", lambda g: (
        seen.append(("replay", lib())), replay(g))[1])
    srv = _server(iters=20, batch=2, use_kernel=True)
    fp = srv.register(sys_a)
    rng = np.random.default_rng(3)
    for _ in range(3):
        for _ in range(2):
            srv.submit(fp, rng.standard_normal(48))
        srv.drain()
    assert seen == [("init", "default"), ("replay", "default")] * 3, seen

    entered, release = threading.Event(), threading.Event()
    order = []

    def capture():
        with executor._linalg("cusolver"):
            entered.set()
            release.wait(10)
            order.append(("capture", lib()))

    t = threading.Thread(target=capture)
    t.start()
    entered.wait(10)
    threading.Timer(0.2, release.set).start()
    with executor.default_linalg():
        order.append(("store miss", lib()))
    t.join()
    assert order == [("capture", "cusolver"), ("store miss", "default")]


def test_served_through_captured_graphs(sys_a, monkeypatch):
    """The card's path with the faked card's CUDA graphs: one build and
    one capture for the first batch, replays after, x equal to
    solve_many's eager loop."""
    from test_torch_smoke import fake_cuda_graphs
    fake_cuda_graphs(monkeypatch)
    monkeypatch.setattr(executor, "_capturing", lambda b: True)
    srv = _server(iters=37, batch=3, use_kernel=True)
    fp = srv.register(sys_a)
    rng = np.random.default_rng(5)
    batches = [rng.standard_normal((3, 48)) for _ in range(3)]
    with tracecheck() as tc:
        for b in batches[0]:
            srv.submit(fp, b)
        first = srv.drain()
    assert [e.fun for e in tc.traces()] == ["build apc.cold",
                                            "capture apc.cold"]
    outs = [first]
    with tracecheck(steady_state=True):
        for B in batches[1:]:
            for b in B:
                srv.submit(fp, b)
            outs.append(srv.drain())
    (ex,) = srv._executors.values()
    assert (ex.builds, ex.captures, ex.cache_size()) == (1, 1, 1)
    with executor.disable_capture():
        for B, out in zip(batches, outs):
            ref = solvers.get("apc").solve_many(
                sys_a, B, iters=37, plan=solvers.ExecutionPlan(kernel=True),
                **PRM)
            for i, r in enumerate(out):
                assert np.array_equal(r.x, ref.x[i].numpy())


# ---------------------------------------------------------------------------
# warm starts
# ---------------------------------------------------------------------------


def test_warm_start_repeated_rhs_resumes(sys_a):
    srv = _server(iters=40, batch=1, warm_start=True)
    fp = srv.register(sys_a)
    b = np.random.default_rng(5).standard_normal(48)
    srv.submit(fp, b)
    cold = srv.drain()[0]
    srv.submit(fp, b)
    warm = srv.drain()[0]
    assert not cold.warm and warm.warm
    assert warm.residual < cold.residual
    assert srv.stats.warm_batches == 1


def test_warm_start_perturbed_rhs_gated_by_solver(sys_a):
    rng = np.random.default_rng(6)
    b = rng.standard_normal(48)
    db = 1e-3 * rng.standard_normal(48)
    srv = _server(iters=40, batch=1, warm_start=True)
    fp = srv.register(sys_a)
    srv.submit(fp, b)
    srv.drain()
    srv.submit(fp, b + db)
    assert not srv.drain()[0].warm
    srvg = LinsysServer(FactorStore(), solver="dhbm", iters=250, batch=1,
                        warm_start=True)
    fpg = srvg.register(sys_a)
    srvg.submit(fpg, b)
    srvg.drain()
    srvg.submit(fpg, b + db)
    warm = srvg.drain()[0]
    assert warm.warm and warm.residual < 1e-6


def test_warm_mixed_traffic_apc_cold_solves_bit_equal(sys_a):
    rng = np.random.default_rng(8)
    b0 = rng.standard_normal(48)
    b1 = b0 + 1e-3 * rng.standard_normal(48)
    srv = _server(iters=30, batch=1, warm_start=True)
    fp = srv.register(sys_a)
    out = []
    for b in [b0, b0, b1, b1, b0]:
        srv.submit(fp, b)
        out.append(srv.drain()[0])
    assert [r.warm for r in out] == [False, True, False, True, False]
    cold = _server(iters=30, batch=1)
    fpc = cold.register(sys_a)
    for b, r in [(b0, out[0]), (b1, out[2]), (b0, out[4])]:
        cold.submit(fpc, b)
        c = cold.drain()[0]
        assert np.array_equal(r.x, c.x) and r.residual == c.residual


def test_warm_mixed_traffic_cimmino_perturbed_stays_warm(sys_a):
    rng = np.random.default_rng(9)
    b0 = rng.standard_normal(48)
    b1 = b0 + 1e-3 * rng.standard_normal(48)
    srv = LinsysServer(FactorStore(), solver="cimmino", iters=400, batch=1,
                       warm_start=True, tol=1e-8)
    fp = srv.register(sys_a)
    out = []
    for b in [b0, b0, b1]:
        srv.submit(fp, b)
        out.append(srv.drain()[0])
    assert [r.warm for r in out] == [False, True, True]
    assert out[2].residual < 1e-8
    A_dense, _ = sys_a.dense()
    x_direct = np.linalg.solve(A_dense.numpy(), b1)
    assert np.allclose(out[2].x, x_direct, rtol=1e-5, atol=1e-7)


def test_solve_stream_reports_warm_hit_rate(sys_a):
    rng = np.random.default_rng(10)
    b = rng.standard_normal(48)
    stream = [(None, b + 1e-3 * i * rng.standard_normal(48))
              for i in range(4)]
    for solver, rate in (("cimmino", 0.75), ("apc", 0.0)):
        srv = LinsysServer(FactorStore(), solver=solver, iters=20, batch=1,
                           warm_start=True)
        fp = srv.register(sys_a)
        rep = solvers.solve_stream(srv, [(fp, r) for _, r in stream])
        assert rep.batches == 4 and len(rep.served) == 4
        assert rep.warm_hit_rate == rate
    with pytest.raises(ValueError, match="drain_every"):
        solvers.solve_stream(srv, [], drain_every=0)


def test_register_merges_server_level_params(sys_a):
    srv = LinsysServer(FactorStore(), solver="apc", iters=5, batch=1,
                       gamma=1.25, eta=1.5)
    fp = srv.register(sys_a, eta=1.1)
    prm = srv._systems[fp].prm
    assert prm["gamma"] == 1.25 and prm["eta"] == 1.1


def test_warm_rhs_ok_flags():
    for name in ref_solvers.available():
        assert solvers.get(name).warm_rhs_ok is \
            ref_solvers.get(name).warm_rhs_ok, name


# ---------------------------------------------------------------------------
# the async pipeline: tests/test_pipeline_server.py
# ---------------------------------------------------------------------------


def test_async_matches_sync_bit_equal(sys_a, sys_b):
    rng = np.random.default_rng(0)
    order = [0, 0, 1, 0, 1, 1, 0, 1]
    rhs = [rng.standard_normal(48) for _ in order]
    sync = _server(iters=40)
    fps = [sync.register(sys_a), sync.register(sys_b)]
    for i, b in zip(order, rhs):
        sync.submit(fps[i], b)
    ref = {r.rid: r for r in sync.drain()}
    asrv = _async(iters=40, pipeline_depth=2)
    afps = [asrv.register(sys_a), asrv.register(sys_b)]
    _, out = _drive(asrv, afps, order, rhs)
    assert [r.rid for r in out] == list(range(len(order)))
    for r in out:
        assert np.array_equal(r.x, ref[r.rid].x)
        assert r.residual == ref[r.rid].residual and r.fp == ref[r.rid].fp
    assert asrv.stats.served == len(order) and asrv.stats.shed == 0


def test_ticket_futures_stream_results(sys_a):
    srv = _async(iters=20)
    fp = srv.register(sys_a)
    rng = np.random.default_rng(1)
    with srv:
        tickets = [srv.submit(fp, rng.standard_normal(48))
                   for _ in range(4)]
        results = [t.result(timeout=60) for t in tickets]
    for t, r in zip(tickets, results):
        assert r.rid == t.rid and r.fp == fp and np.isfinite(r.residual)
    rep = srv.latency_report()
    assert rep["count"] == 4 and rep["p99_ms"] >= rep["p50_ms"] > 0


def test_backpressure_sheds_exactly_beyond_capacity(sys_a):
    srv = _async(iters=10, admit_capacity=4)
    fp = srv.register(sys_a)
    rng = np.random.default_rng(2)
    tickets = [srv.submit(fp, rng.standard_normal(48)) for _ in range(10)]
    for t in tickets[4:]:
        assert t.future.done() and isinstance(t.result(), Shed)
    assert srv.stats.admitted == 4 and srv.stats.shed == 6
    out = srv.drain()
    srv.close()
    assert [r.rid for r in out] == list(range(10))
    assert all(not isinstance(r, Shed) for r in out[:4])
    assert all(isinstance(r, Shed) for r in out[4:])
    assert srv.stats.served == 4 and srv.latency_report()["count"] == 4


def test_capacity_frees_as_requests_complete(sys_a):
    srv = _async(iters=10, admit_capacity=2)
    fp = srv.register(sys_a)
    rng = np.random.default_rng(3)
    with srv:
        first = [srv.submit(fp, rng.standard_normal(48)) for _ in range(2)]
        for t in first:
            assert not isinstance(t.result(timeout=60), Shed)
        again = srv.submit(fp, rng.standard_normal(48))
        assert not isinstance(again.result(timeout=60), Shed)
    assert srv.stats.shed == 0 and srv.stats.served == 3


def test_on_membership_scales_admission_and_reset_metrics(sys_a):
    srv = _async(iters=5, admit_capacity=8)
    assert srv.on_membership(2, 4) == 4 and srv.admit_capacity == 4
    assert srv.on_membership(0, 4) == 1            # never below 1
    assert srv.on_membership(4, 4) == 8
    with pytest.raises(ValueError, match="total"):
        srv.on_membership(1, 0)
    with pytest.raises(ValueError, match="within"):
        srv.on_membership(5, 4)
    fp = srv.register(sys_a)
    with srv:
        srv.submit(fp, np.ones(48)).result(timeout=60)
    builds = srv.stats.executor_builds
    srv.reset_metrics()
    assert srv.latency_report()["count"] == 0 and srv.stats.served == 0
    assert srv.stats.executor_builds == builds == 1


def test_async_validation_shares_sync_guards(sys_a):
    srv = _async()
    fp = srv.register(sys_a)
    with pytest.raises(KeyError, match="deadbeef"):
        srv.submit("deadbeef", np.zeros(48))
    with pytest.raises(ValueError, match="shape"):
        srv.submit(fp, np.zeros(7))
    with pytest.raises(ValueError, match="pipeline_depth"):
        AsyncLinsysServer(FactorStore(), pipeline_depth=0)
    with pytest.raises(ValueError, match="admit_capacity"):
        AsyncLinsysServer(FactorStore(), admit_capacity=0)


def test_empty_drain_and_close_are_noops():
    srv = _async()
    assert srv.drain() == []
    srv.close()
    assert srv._assembler is None and srv.stats.executor_builds == 0


def test_step_is_not_part_of_the_async_surface():
    with pytest.raises(RuntimeError, match="submit"):
        _async().step()


def test_context_manager_drains_on_exit(sys_a):
    srv = _async(iters=10)
    fp = srv.register(sys_a)
    rng = np.random.default_rng(4)
    with srv:
        tickets = [srv.submit(fp, rng.standard_normal(48))
                   for _ in range(3)]
    assert all(t.future.done() for t in tickets)
    assert srv.stats.served == 3


def test_async_zero_retrace_steady_state(sys_a, sys_b):
    srv = _async(iters=10, pipeline_depth=2)
    fps = [srv.register(sys_a), srv.register(sys_b)]
    rng = np.random.default_rng(5)
    with srv:
        for fp in fps:
            for t in [srv.submit(fp, rng.standard_normal(48))
                      for _ in range(2)]:
                t.result(timeout=60)
        with tracecheck(steady_state=True):
            for i in range(5):
                for t in [srv.submit(fps[i % 2], rng.standard_normal(48))
                          for _ in range(2)]:
                    t.result(timeout=60)
    assert srv.stats.executor_builds == 1


def test_async_warm_chaining_repeated_rhs(sys_a):
    srv = _async(iters=30, batch=1, warm_start=True)
    fp = srv.register(sys_a)
    b = np.random.default_rng(6).standard_normal(48)
    with srv:
        first = srv.submit(fp, b).result(timeout=60)
        second = srv.submit(fp, b).result(timeout=60)
    assert not first.warm and second.warm
    assert second.residual < first.residual
    assert srv.stats.warm_batches == 1


def test_async_warm_mixed_traffic_matches_sync(sys_a):
    rng = np.random.default_rng(7)
    b0 = rng.standard_normal(48)
    b1 = b0 + 1e-3 * rng.standard_normal(48)
    seq = [b0, b0, b1, b1, b0]
    sync = _server(iters=30, batch=1, warm_start=True)
    fs = sync.register(sys_a)
    ref = []
    for b in seq:
        sync.submit(fs, b)
        ref.append(sync.drain()[0])
    asrv = _async(iters=30, batch=1, warm_start=True)
    fa = asrv.register(sys_a)
    with asrv:
        out = [asrv.submit(fa, b).result(timeout=60) for b in seq]
    assert [r.warm for r in out] == [r.warm for r in ref] == \
        [False, True, False, True, False]
    for r, e in zip(out, ref):
        assert np.array_equal(r.x, e.x) and r.residual == e.residual


@pytest.mark.parametrize("precision", ["default", "mixed"])
def test_async_use_kernel_matches_sync(sys_a, precision):
    """Async ≡ sync bit for bit on the kernel path; under mixed the async
    server's store entry is the bf16 one the sync server caches (the
    reference's async server passes no precision to its store: a miss
    there caches float64 factors under the mixed key, ROADMAP C)."""
    rng = np.random.default_rng(9)
    rhs = [rng.standard_normal(48) for _ in range(4)]
    sync = _server(iters=40, use_kernel=True, precision=precision)
    fp = sync.register(sys_a)
    for b in rhs:
        sync.submit(fp, b)
    ref = sync.drain()
    asrv = _async(iters=40, use_kernel=True, precision=precision)
    afp = asrv.register(sys_a)
    assert afp == fp
    _, out = _drive(asrv, [afp] * 4, [0] * 4, rhs)
    for r, e in zip(out, ref):
        assert np.array_equal(r.x, e.x) and r.residual == e.residual
    want = torch.bfloat16 if precision == "mixed" else torch.float64
    for srv in (sync, asrv):
        f = srv.store._mem[fp]
        assert f.A.dtype == f.B.dtype == want
    assert asrv.store.stats.misses == 1


def test_reference_async_mixed_caches_full_precision():
    """The deviation recorded in ROADMAP C, shown on the reference: its
    async server's mixed entry is float64, its sync server's bf16."""
    import jax.numpy as jnp
    rsys = ref_linsys.conditioned_gaussian(n=48, m=4, cond=10.0, seed=0)
    b = np.random.default_rng(11).standard_normal(48)
    dtypes = {}
    for cls in (ref_serve.LinsysServer, ref_pipeline.AsyncLinsysServer):
        srv = cls(ref_store.FactorStore(), solver="apc", iters=2, batch=1,
                  use_kernel=True, precision="mixed", **PRM)
        fp = srv.register(rsys)
        srv.submit(fp, b)
        srv.drain()
        if cls is ref_pipeline.AsyncLinsysServer:
            srv.close()
        dtypes[cls.__name__] = srv.store._mem[fp].A.dtype
    assert dtypes == {"LinsysServer": jnp.bfloat16,
                      "AsyncLinsysServer": jnp.float64}


def test_failed_batch_sets_its_exception_on_its_tickets(sys_a, sys_b,
                                                        monkeypatch):
    """Nothing retried, nothing served from elsewhere: the batch's
    tickets raise, and the pipeline goes on serving other batches."""
    srv = AsyncLinsysServer(FactorStore(), solver="apc", iters=5, batch=2)
    fa, fb = srv.register(sys_a, **PRM), srv.register(sys_b)
    run = executor.LocalExecutor.run

    def flaky(self, A, factors, Bb, states=None):
        if self.prm != PRM:
            raise RuntimeError("replay failed")
        return run(self, A, factors, Bb, states)

    monkeypatch.setattr(executor.LocalExecutor, "run", flaky)
    rng = np.random.default_rng(12)
    with srv:
        bad = [srv.submit(fb, rng.standard_normal(48)) for _ in range(2)]
        good = srv.submit(fa, rng.standard_normal(48))
        for t in bad:
            with pytest.raises(RuntimeError, match="replay failed"):
                t.result(timeout=60)
        assert np.isfinite(good.result(timeout=60).residual)
    assert srv.stats.served == 1 and srv.in_system() == 0


def test_concurrent_captures_on_two_pool_threads(sys_a, sys_b,
                                                 monkeypatch):
    """Two systems with distinct parameters (two executors) whose first
    batches capture on the two pool threads at once, with the faked
    card's graphs: each capture is its own thread's, and the served x
    equal the sync server's."""
    from test_torch_smoke import fake_cuda_graphs
    fake_cuda_graphs(monkeypatch)
    monkeypatch.setattr(executor, "_capturing", lambda b: True)
    rng = np.random.default_rng(13)
    order = [0, 1, 0, 1, 0, 1]
    rhs = [rng.standard_normal(48) for _ in order]
    out = {}
    for cls in (LinsysServer, AsyncLinsysServer):
        srv = cls(FactorStore(), solver="apc", iters=20, batch=2,
                  use_kernel=True)
        fps = [srv.register(sys_a), srv.register(sys_b, gamma=1.0, eta=1.0)]
        for i, b in zip(order, rhs):
            srv.submit(fps[i], b)
        out[cls] = srv.drain()
        if cls is AsyncLinsysServer:
            srv.close()
        assert srv.stats.executor_builds == 2
        assert sum(ex.captures for ex in srv._executors.values()) == 2
    for r, e in zip(out[AsyncLinsysServer],
                    sorted(out[LinsysServer], key=lambda r: r.rid)):
        assert r.rid == e.rid and np.array_equal(r.x, e.x)


def test_pipeline_passes_the_lock_discipline_checker():
    path = REPO / "src" / "repro_torch" / "solvers" / "pipeline.py"
    assert check_locks(SourceFile(path)) == []


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _mask(line: str) -> str:
    line = re.sub(r"[0-9a-f]{8,}", "<hex>", line)
    return re.sub(r" +", " ", re.sub(r"\d+(\.\d+)?(e[+-]\d+)?", "#", line))


@pytest.mark.parametrize("extra", [[], ["--async"]])
def test_serve_linsys_cli_prints_the_references_lines(extra, tmp_path):
    args = ["--requests", "5", "--systems", "2", "--batch", "2", "--n", "32",
            "--iters", "60"] + extra
    outs = {}
    for name, main, more in (("ref", ref_cli.main, []),
                             ("port", cli.main, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(args + more) == 0
        outs[name] = buf.getvalue().splitlines()
    port = [x.replace(" on cpu (", " (") for x in outs["port"]]
    assert any(" on cpu (" in x for x in outs["port"])
    assert [_mask(x) for x in port] == [_mask(x) for x in outs["ref"]]
    # (the fingerprints differ here: the auto-tuned parameters enter the
    # digest, and the two packages' eigensolvers differ in the last bits;
    # with the same parameters they are equal, tests/test_torch_store.py)


def test_serve_linsys_cli_store_dir_and_mesh(tmp_path, capsys):
    args = ["--requests", "4", "--systems", "1", "--batch", "2", "--n", "32",
            "--iters", "30", "--device", "cpu", "--use-kernel",
            "--store-dir", str(tmp_path)]
    assert cli.main(args) == 0
    assert "misses=1" in capsys.readouterr().out
    assert cli.main(args + ["--async"]) == 0
    out = capsys.readouterr().out
    assert "disk_hits=1" in out and "misses=0" in out
    # --backend mesh serves (A14b): alone, on a one-rank group, with the
    # same store's disk tier
    import torch.distributed as dist
    had_group = dist.is_initialized()
    try:
        assert cli.main(args + ["--backend", "mesh"]) == 0
    finally:
        if not had_group and dist.is_initialized():
            dist.destroy_process_group()
    out = capsys.readouterr().out
    assert "mesh backend over 1 rank(s), gloo: rank 0 admits" in out
    assert "disk_hits=1" in out and "served 4 requests" in out


# ---------------------------------------------------------------------------
# shared state under threads
# ---------------------------------------------------------------------------


def test_executor_and_launch_counts_under_thread_stress(sys_a):
    """More threads than cores run ONE executor at once, each with its own
    right-hand sides, with a short switch interval: a race on the static
    buffers (Cimmino reads b at every step) would hand a thread another's
    result.  And every thread counts launches at once: a lost update
    would show in the total."""
    import os
    import sys
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import block_projection as bp

    s, prm = solvers.get("cimmino"), {"nu": 0.25}
    factors = s.kernel_factors(s.prepare(sys_a.A_op, prm))
    ex = executor.LocalExecutor(s, prm, 40, use_kernel=True)
    rng = np.random.default_rng(14)
    n = 2 * (os.cpu_count() or 4) + 2
    batches = [torch.as_tensor(rng.standard_normal((2, 4, 12)))
               for _ in range(n)]
    want = [s.solve_many(sys_a, B.reshape(2, -1), iters=40,
                         plan=solvers.ExecutionPlan(kernel=True,
                                                    factors=factors),
                         **prm).x for B in batches]
    before = bp.launch_counts()["apc_gather"]
    barrier = threading.Barrier(n, timeout=60)

    def work(i):
        barrier.wait()
        for _ in range(50):
            bp.count_launch("apc_gather", "f64")
        return [ex.run(sys_a.A_op, factors, batches[i])[1]
                for _ in range(4)]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=n) as pool:
            got = [f.result(timeout=120)
                   for f in [pool.submit(work, i) for i in range(n)]]
    finally:
        sys.setswitchinterval(old)
    for runs, w in zip(got, want):
        assert all(torch.equal(g, w) for g in runs)
    assert ex.builds == 1 and ex.cache_size() == 1
    assert bp.launch_counts()["apc_gather"] - before == 50 * n
