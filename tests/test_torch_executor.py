"""Compile-once execution of the port (``solvers.executor``) on the CPU.

On the card ``solve``/``solve_many`` capture their step loop into a CUDA
graph (an eager head of ``CHUNK`` steps, replays of one CHUNK-step
graph, an eager tail) and ``LocalExecutor`` captures its whole program;
on the CPU both run the same bodies through the same static buffers and
chunks, eagerly.  Held here: those chunked histories are ``torch.equal``
to the plain eager loops (``api._history_scan``/``_history_scan_many``)
for every solver family and system class the capability matrix allows,
at iteration counts below, at and across the chunk, from a cold and a
warm state; they match the JAX reference at the parity tolerances of
the other ``test_torch_*`` files; ``ExecutionPlan.signature()`` and the
executor's key are the reference's; and ``repro_torch.analysis
.tracecheck`` behaves as ``repro.analysis.tracecheck`` does in
tests/test_analysis_lint.py.  Two tests run the captured path itself
through the faked card's CUDA graphs of tests/test_torch_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import solvers as ref_solvers  # noqa: E402
from repro.data import linsys as ref_linsys  # noqa: E402
from repro_torch import solvers  # noqa: E402
from repro_torch.analysis import TraceError, tracecheck  # noqa: E402
from repro_torch.data import linsys  # noqa: E402
from repro_torch.kernels import block_projection as bp  # noqa: E402
from repro_torch.solvers import api, executor  # noqa: E402
from repro_torch.solvers.capability import resolve_plan  # noqa: E402

torch.set_num_threads(1)

GENERATORS = {
    "dense": ("conditioned_gaussian", dict(n=64, m=4, cond=20.0, seed=3)),
    "sparse": ("banded_system", dict(n=64, m=4, bandwidth=4, seed=0)),
    "ls": ("tall_gaussian", dict(N=96, n=48, m=4, noise=0.05, seed=0)),
}
# (solver, kernel) on each system class its capability allows
CASES = [(name, kernel, sysname)
         for name, kernels, classes in (
             ("apc", (False, True), ("dense", "sparse")),
             ("consensus", (False, True), ("dense", "sparse")),
             ("cimmino", (False, True), ("dense", "sparse", "ls")),
             ("dgd", (False,), ("dense", "sparse", "ls")),
             ("madmm", (False,), ("dense", "sparse")))
         for kernel in kernels for sysname in classes]
ITERS = (0, 5, executor.CHUNK, 37)     # none, below, at and across chunks
K = 3
HIST = dict(rtol=0, atol=1e-9)         # tests/test_torch_apc.py


def _id(case):
    name, kernel, sysname = case
    return f"{name}-{'kernel' if kernel else 'unfused'}-{sysname}"


@pytest.fixture(scope="module")
def systems():
    return {key: getattr(linsys, fn)(**kw, device="cpu")
            for key, (fn, kw) in GENERATORS.items()}


@pytest.fixture(scope="module")
def ref_systems():
    return {key: getattr(ref_linsys, fn)(**kw)
            for key, (fn, kw) in GENERATORS.items()}


@pytest.fixture(scope="module")
def rhs(systems):
    """K seeded right-hand sides of each system."""
    return {key: torch.as_tensor(np.random.default_rng(7).standard_normal(
        (K, s.N))) for key, s in systems.items()}


def _params(s, sys_):
    return {k: float(v) for k, v in s.resolve_params(sys_).items()}


def _eager(s, sys_, plan, prm, iters, *, B=None, state=None):
    """What ``solve`` (``solve_many`` with ``B``) computes, through the
    plain eager loop: (state, residuals, errors)."""
    plan = resolve_plan(s, sys_, plan)
    factors = s._factors(sys_, plan, prm)
    b = sys_.b_blocks if B is None else B.reshape(B.shape[0], sys_.m, sys_.p)
    if state is None:
        state = s.init(factors, b, prm)
    residual_fn = s._ls_residual_fn(sys_, factors, prm, b)
    fused = (plan.kernel and s.supports_fused_residual and residual_fn is None
             and iters > 0)
    if B is not None:
        return (*api._history_scan_many(
            lambda f, bb, st: s.step_many(f, bb, st, prm,
                                          use_kernel=plan.kernel),
            s.extract, factors, b, state, sys_.A_op, iters,
            residual_fn=residual_fn,
            step_many_residual=(lambda f, bb, st: s.step_many_residual(
                f, bb, st, prm)) if fused else None), None)
    xt = sys_.x_true
    if xt is None and sys_.mode == "least_squares":
        xt = s.ls_reference(sys_)
    return api._history_scan(
        lambda f, bb, st: s.step(f, bb, st, prm, use_kernel=plan.kernel),
        s.extract, factors, b, state, sys_.A_op, xt, iters,
        residual_fn=residual_fn,
        step_residual=(lambda f, bb, st: s.step_residual(f, bb, st, prm))
        if fused else None)


def _equal_states(a, b):
    assert type(a) is type(b) and a.t == b.t
    for u, v in zip(a, b):
        if isinstance(u, torch.Tensor):
            assert torch.equal(u, v)


# ------------------------------------------------------------ signature
@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("precision", ["default", "mixed"])
def test_signature_matches_reference(kernel, precision):
    assert solvers.ExecutionPlan(
        kernel=kernel, precision=precision).signature() == \
        ref_solvers.ExecutionPlan(kernel=kernel,
                                  precision=precision).signature()


def test_signature_excludes_payload(systems):
    plain = solvers.ExecutionPlan(kernel=True)
    loaded = solvers.ExecutionPlan(kernel=True, warm_state=object(),
                                   factors=object())
    assert plain.signature() == loaded.signature()
    assert hash(plain.signature()) == hash(loaded.signature())


# ------------------------------------------- chunked == the eager loop
@pytest.mark.parametrize("iters", ITERS)
@pytest.mark.parametrize("case", CASES, ids=_id)
def test_solve_history_equals_eager_loop(systems, case, iters):
    name, kernel, sysname = case
    s, sys_ = solvers.get(name), systems[sysname]
    prm, plan = _params(s, sys_), solvers.ExecutionPlan(kernel=kernel)
    r = s.solve(sys_, iters=iters, plan=plan, **prm)
    state, res, err = _eager(s, sys_, plan, prm, iters)
    assert torch.equal(r.residuals, res) and torch.equal(r.errors, err)
    _equal_states(r.state, state)
    assert r.state.t == iters                       # advanced on the host
    # warm: the same again from the state reached
    w = s.solve(sys_, iters=iters, plan=solvers.ExecutionPlan(
        kernel=kernel, warm_state=r.state), **prm)
    state2, res2, _ = _eager(s, sys_, plan, prm, iters, state=state)
    assert torch.equal(w.residuals, res2)
    _equal_states(w.state, state2)
    assert w.state.t == 2 * iters


@pytest.mark.parametrize("iters", ITERS[1:])
@pytest.mark.parametrize("case", CASES, ids=_id)
def test_solve_many_history_equals_eager_loop(systems, rhs, case, iters):
    name, kernel, sysname = case
    s, sys_ = solvers.get(name), systems[sysname]
    prm, plan = _params(s, sys_), solvers.ExecutionPlan(kernel=kernel)
    r = s.solve_many(sys_, rhs[sysname], iters=iters, plan=plan, **prm)
    state, res, _ = _eager(s, sys_, plan, prm, iters, B=rhs[sysname])
    assert r.residuals.shape == (K, iters)
    assert torch.equal(r.residuals, res)
    _equal_states(r.state, state)


@pytest.mark.parametrize("iters", ITERS)
@pytest.mark.parametrize("case", CASES, ids=_id)
def test_executor_equals_eager_loop(systems, rhs, case, iters):
    """Cold, then warm from the states it returned: the executor's
    (states, X, res) against the eager loop's; t advances by iters."""
    name, kernel, sysname = case
    s, sys_ = solvers.get(name), systems[sysname]
    prm, plan = _params(s, sys_), solvers.ExecutionPlan(kernel=kernel)
    rplan = resolve_plan(s, sys_, plan)
    factors = s._factors(sys_, rplan, prm)
    ex = executor.LocalExecutor(s, prm, iters, use_kernel=rplan.kernel,
                                ls_mode=sys_.mode == "least_squares")
    Bb = rhs[sysname].reshape(K, sys_.m, sys_.p)
    states, X, res = ex.run(sys_.A_op, factors, Bb)
    want, want_res, _ = _eager(s, sys_, plan, prm, iters, B=rhs[sysname])
    _equal_states(states, want)
    assert torch.equal(X, s.extract(want)) and torch.equal(res, want_res)
    states2, X2, res2 = ex.run(sys_.A_op, factors, Bb, states)
    want2, want_res2, _ = _eager(s, sys_, plan, prm, iters, B=rhs[sysname],
                                 state=want)
    _equal_states(states2, want2)
    assert torch.equal(res2, want_res2) and states2.t == 2 * iters
    # returned results are copies: the second run left the first intact
    assert torch.equal(X, s.extract(want))
    assert (ex.builds, ex.captures, ex.cache_size()) == (2, 0, 2)


def test_executor_runs_through_a_captured_graph(systems, rhs, monkeypatch):
    """The card's path, with the faked card's CUDA graph: the warm-up
    head, one capture, replays equal to the eager loop, launches counted
    by the replays, and a new right-hand side reaching the graph."""
    from test_torch_smoke import fake_cuda_graphs
    fake_cuda_graphs(monkeypatch)
    monkeypatch.setattr(executor, "_capturing", lambda b: True)
    s, sys_ = solvers.get("apc"), systems["sparse"]
    prm, iters = _params(s, sys_), 37
    plan = solvers.ExecutionPlan(kernel=True)
    factors = s._factors(sys_, plan, prm)
    ex = executor.LocalExecutor(s, prm, iters, use_kernel=True)
    events = []
    for B in (rhs["sparse"], 2 * rhs["sparse"] + 1):
        bp.reset_launch_counts()
        with tracecheck() as tc:
            X, res = ex.run(sys_.A_op, factors,
                            B.reshape(K, sys_.m, sys_.p))[1:]
        events.append([e.fun for e in tc.traces()])
        want, want_res, _ = _eager(s, sys_, plan, prm, iters, B=B)
        assert torch.equal(X, s.extract(want)) and torch.equal(res, want_res)
    assert events == [["build apc.cold", "capture apc.cold"], []]
    assert (ex.builds, ex.captures) == (1, 1)
    # the plain versions ran (CPU tensors): no launch, captured or not
    assert bp.launch_counts() == dict.fromkeys(bp.KERNELS, 0)
    r = s.solve(sys_, iters=iters, plan=plan, **prm)
    state, res, err = _eager(s, sys_, plan, prm, iters)
    assert torch.equal(r.residuals, res) and torch.equal(r.errors, err)


def test_captured_graphs_leave_no_reference_cycle(systems, monkeypatch):
    """A solve's graph is freed when the solve returns, and an executor's
    with the executor, by reference counting alone: a graph left to the
    cyclic collector can be destroyed inside a later capture, which
    invalidates that capture on the card."""
    import gc
    import weakref
    from test_torch_smoke import _Graph, fake_cuda_graphs
    alive = weakref.WeakSet()

    class Tracked(_Graph):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            alive.add(self)

    fake_cuda_graphs(monkeypatch)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Tracked)
    monkeypatch.setattr(executor, "_capturing", lambda b: True)
    s, sys_ = solvers.get("apc"), systems["dense"]
    prm = _params(s, sys_)
    plan = solvers.ExecutionPlan(kernel=True)
    # a first capture: the imports the faked capture makes lazily hold
    # their callers' frames once
    s.solve(sys_, iters=40, plan=plan, **prm)
    gc.collect()
    gc.disable()
    try:
        s.solve(sys_, iters=40, plan=plan, **prm)
        assert len(alive) == 0
        ex = executor.LocalExecutor(s, prm, 20)
        ex.run(sys_.A_op, s.prepare(sys_.A_op, prm), sys_.b_blocks[None])
        assert len(alive) == 1 and ex.captures == 1
        del ex
        assert len(alive) == 0
    finally:
        gc.enable()


# --------------------------------------------------------------- the key
def test_executor_key_builds_once_per_key(systems, rhs):
    """A server's executors keyed by ``executor_key``: the same key is one
    build; a change of k, iters, precision or params is a new one."""
    s, sys_ = solvers.get("apc"), systems["dense"]
    prm = _params(s, sys_)
    cache, placed = {}, {}

    def serve(k, iters, plan, p):
        key = executor.executor_key(s, sys_, p, plan, k, iters)
        rplan = resolve_plan(s, sys_, plan)
        ex = cache.setdefault(key, executor.LocalExecutor(
            s, p, iters, use_kernel=rplan.kernel))
        # one placement of the factors per (precision, params), as a
        # server holds them: a new placement would be a new build
        factors = placed.setdefault((plan.precision, tuple(p.items())),
                                    s._factors(sys_, rplan, p))
        ex.run(sys_.A_op, factors,
               rhs["dense"][:k].reshape(k, sys_.m, sys_.p))
        return key

    kplan = solvers.ExecutionPlan(kernel=True)
    base = serve(2, 5, kplan, prm)
    assert serve(2, 5, kplan, prm) == base
    assert sum(ex.builds for ex in cache.values()) == 1
    others = [serve(3, 5, kplan, prm), serve(2, 6, kplan, prm),
              serve(2, 5, solvers.ExecutionPlan(kernel=True,
                                                precision="mixed"), prm),
              serve(2, 5, kplan, {**prm, "gamma": prm["gamma"] * 0.5})]
    assert len({base, *others}) == 5
    assert sum(ex.builds for ex in cache.values()) == 5
    assert base[:8] == (s.name, sys_.m, sys_.p, sys_.n, "torch.float64",
                        "dense", "square", tuple(sorted(prm.items())))
    assert base[8] == kplan.signature() and base[9:] == (2, 5)


# ------------------------------------------------- against the reference
@pytest.mark.parametrize("name,kernel,sysname", [
    ("apc", True, "dense"), ("apc", False, "sparse"),
    ("cimmino", False, "dense"), ("cimmino", False, "ls"),
    ("dgd", False, "dense"), ("madmm", False, "sparse")])
def test_chunked_history_matches_reference(systems, ref_systems, name,
                                           kernel, sysname):
    """37 iterations (head, a replay of the chunk, a tail) of the port
    against the JAX reference's solve, at tests/test_torch_apc.py's
    parity tolerance."""
    ref = ref_solvers.get(name)
    prm = {k: float(v) for k, v in
           ref.resolve_params(ref_systems[sysname]).items()}
    r_ref = ref.solve(ref_systems[sysname], iters=37,
                      plan=ref_solvers.ExecutionPlan(kernel=kernel), **prm)
    r = solvers.get(name).solve(systems[sysname], iters=37,
                                plan=solvers.ExecutionPlan(kernel=kernel),
                                **prm)
    np.testing.assert_allclose(r.residuals.numpy(),
                               np.asarray(r_ref.residuals), **HIST)
    np.testing.assert_allclose(r.x.numpy(), np.asarray(r_ref.x), rtol=1e-9,
                               atol=1e-12)
    assert r.state.t == int(r_ref.state.t) == 37


# ------------------------------------------------------------ tracecheck
def _executor(systems):
    s, sys_ = solvers.get("cimmino"), systems["dense"]
    prm = _params(s, sys_)
    Bb, factors = sys_.b_blocks[None], s.prepare(sys_.A_op, prm)
    return (executor.LocalExecutor(s, prm, 3),
            lambda ex: ex.run(sys_.A_op, factors, Bb))


def test_tracecheck_attributes_deliberate_build_to_call_site(systems):
    ex, run = _executor(systems)
    with pytest.raises(TraceError) as ei:
        with tracecheck(steady_state=True):
            run(ex)  # deliberate: the first build lands inside the window
    msg = str(ei.value)
    assert "test_torch_executor.py" in msg, msg
    assert "build cimmino.cold" in msg


def test_tracecheck_quiet_on_cached_runs(systems):
    ex, run = _executor(systems)
    run(ex)  # build OUTSIDE the window
    with tracecheck(steady_state=True):
        run(ex)
        run(ex)
    assert ex.builds == 1


def test_tracecheck_records_events_with_signature(systems):
    ex, run = _executor(systems)
    with tracecheck() as tc:
        run(ex)
    evs = tc.traces()
    assert evs, "no trace events recorded"
    assert all(e.signature for e in evs)
    assert "trace event" in tc.summary()
    assert all(e.line > 0 for e in evs)
    assert tc.traces("build *") == evs


def test_tracecheck_allow_patterns(systems):
    ex, run = _executor(systems)
    with tracecheck(steady_state=True, allow=("*",)):
        run(ex)  # every event allowed: must not raise
