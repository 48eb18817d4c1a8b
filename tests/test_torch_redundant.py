"""The port's redundant, straggler-tolerant execution
(``repro_torch.solvers.redundant``), held against the reference.

Twins of the local cases of tests/test_redundant.py, on its system
(``conditioned_gaussian(n=64, m=4, cond=10.0, seed=3)``, 150 iterations):
``solve(plan=ExecutionPlan(redundancy=r, alive_schedule=...))`` against
the reference's PLAIN local solve (the contract: an iteration under any
covering mask is the plain iteration) — x to rtol 1e-8 / atol 1e-10,
histories to rtol 1e-6 / atol 1e-12, ``iters_to_tol`` equal — locally
and on a one-rank gloo mesh in-process (the reference's own mesh cannot
run on JAX 0.9.0, ROADMAP C0: the mesh cases are held to its local run);
tests/test_torch_mesh_ranks.py runs world 4.  The ``red_*`` and
``lift_state`` hooks are held one by one against the reference's, called
with its identity context ``redundant._LocalContext()``, within 1e-12 of
max|ref| + 1 (float64).  The bit-equality cases (captured program ≡
eager loop, a history split into segments ≡ one run) are the port's
own.
"""
import contextlib
import io
import warnings

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

from repro import solvers as ref_solvers  # noqa: E402
from repro.data import linsys as ref_linsys  # noqa: E402
from repro.launch import solve as ref_cli  # noqa: E402
from repro.solvers import redundant as ref_red  # noqa: E402
from repro_torch import solvers  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.data import linsys  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import solve as cli  # noqa: E402
from repro_torch.runtime import fault  # noqa: E402
from repro_torch.solvers import executor, redundant  # noqa: E402
from repro_torch.solvers.capability import (CapabilityError,  # noqa: E402
                                            ExecutionPlan)

torch.set_num_threads(1)

PROJ = ["apc", "consensus", "cimmino"]
ITERS = 150
X_TOL = dict(rtol=1e-8, atol=1e-10)
H_TOL = dict(rtol=1e-6, atol=1e-12)
HOOK_TOL = 1e-12       # max|Δ| / (max|ref| + 1), float64
SYS = dict(n=64, m=4, cond=10.0, seed=3)


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
    return (ref_linsys.conditioned_gaussian(**SYS),
            linsys.conditioned_gaussian(**SYS, device="cpu"))


@pytest.fixture(scope="module")
def mesh(group):
    return mesh_lib.solver_mesh(1, 1, device="cpu")


@pytest.fixture(scope="module")
def ref_runs(systems):
    """The reference's plain local solve of each solver, and its params."""
    ref_sys, _ = systems
    out = {}
    for name in PROJ:
        s = ref_solvers.get(name)
        prm = s.resolve_params(ref_sys)
        out[name] = (prm, s.solve(ref_sys, iters=ITERS, **prm))
    return out


def rotating_straggler(m):
    """Covering schedule: worker t mod m stalls at iteration t."""
    return lambda t: np.array([i != (t % m) for i in range(m)])


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _match(r_port, r_ref, *, errors=True):
    np.testing.assert_allclose(_np(r_port.x), _np(r_ref.x), **X_TOL)
    np.testing.assert_allclose(_np(r_port.residuals),
                               _np(r_ref.residuals), **H_TOL)
    if errors:
        np.testing.assert_allclose(_np(r_port.errors), _np(r_ref.errors),
                                   **H_TOL)
    assert np.array_equal(np.asarray(r_port.iters_to_tol),
                          np.asarray(r_ref.iters_to_tol))


def _red(sys_, name, prm, iters=ITERS, **plan):
    return solvers.get(name).solve(sys_, iters=iters,
                                   plan=ExecutionPlan(**plan), **prm)


# ---------------------------------------------------------------------------
# redundant == plain, locally and on a one-rank mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", PROJ)
def test_redundant_local_matches_reference(systems, ref_runs, name):
    """Exactness: a covered straggler every iteration changes nothing."""
    _, sys_ = systems
    prm, r_ref = ref_runs[name]
    r = _red(sys_, name, prm, redundancy=2,
             alive_schedule=rotating_straggler(sys_.m))
    assert r.name == name and r.residuals.shape == (ITERS,)
    assert r.errors is not None and r.state.t == ITERS
    _match(r, r_ref)


@pytest.mark.parametrize("name", PROJ)
def test_redundant_mesh_matches_reference(systems, ref_runs, mesh, name):
    _, sys_ = systems
    prm, r_ref = ref_runs[name]
    r = _red(sys_, name, prm, redundancy=2, backend="mesh", mesh=mesh,
             alive_schedule=rotating_straggler(sys_.m))
    _match(r, r_ref)
    assert r.state.t == ITERS


@pytest.mark.parametrize("name", PROJ)
def test_redundant_loose_kwargs(systems, ref_runs, name):
    """The deprecated loose kwargs reach the same path, with one warning
    (the reference's test drives redundancy= this way)."""
    _, sys_ = systems
    prm, r_ref = ref_runs[name]
    with pytest.warns(DeprecationWarning):
        r = solvers.get(name).solve(
            sys_, iters=ITERS, redundancy=2,
            alive_schedule=rotating_straggler(sys_.m), **prm)
    _match(r, r_ref)


@pytest.mark.parametrize("name", PROJ)
def test_redundant_state_is_global_shaped(systems, name):
    """The state has the PLAIN structure and shapes (the reference's
    plain state's), so it is interchangeable with plain states."""
    ref_sys, sys_ = systems
    r_plain = ref_solvers.get(name).solve(ref_sys, iters=10)
    r_red = _red(sys_, name, {}, iters=10, redundancy=3)
    assert type(r_red.state).__name__ == type(r_plain.state).__name__
    for f in r_red.state._fields:
        if f != "t":
            assert tuple(getattr(r_red.state, f).shape) == \
                np.shape(getattr(r_plain.state, f)), f


def test_warm_start_roundtrips_across_redundancy(systems, ref_runs):
    """plain -> redundant and redundant -> plain resume exactly."""
    ref_sys, sys_ = systems
    prm = ref_runs["apc"][0]
    s = solvers.get("apc")
    sched = rotating_straggler(sys_.m)
    full = ref_solvers.get("apc").solve(ref_sys, iters=100, **prm)
    half = s.solve(sys_, iters=50, **prm)
    res = _red(sys_, "apc", prm, iters=50, redundancy=2,
               alive_schedule=sched, warm_state=half.state)
    np.testing.assert_allclose(_np(res.x), _np(full.x), **X_TOL)
    assert res.state.t == 100
    half_r = _red(sys_, "apc", prm, iters=50, redundancy=2,
                  alive_schedule=sched)
    res2 = s.solve(sys_, iters=50,
                   plan=ExecutionPlan(warm_state=half_r.state), **prm)
    np.testing.assert_allclose(_np(res2.x), _np(full.x), **X_TOL)


def test_warm_start_roundtrips_across_backends(systems, ref_runs, mesh):
    """redundant mesh <-> plain local warm starts agree with the
    reference's uninterrupted plain run."""
    ref_sys, sys_ = systems
    prm = ref_runs["apc"][0]
    s = solvers.get("apc")
    sched = rotating_straggler(sys_.m)
    full = ref_solvers.get("apc").solve(ref_sys, iters=100, **prm)
    half_m = _red(sys_, "apc", prm, iters=50, redundancy=2,
                  alive_schedule=sched, backend="mesh", mesh=mesh)
    res_l = s.solve(sys_, iters=50,
                    plan=ExecutionPlan(warm_state=half_m.state), **prm)
    np.testing.assert_allclose(_np(res_l.x), _np(full.x), **X_TOL)
    half_l = s.solve(sys_, iters=50, **prm)
    res_m = _red(sys_, "apc", prm, iters=50, redundancy=2,
                 alive_schedule=sched, backend="mesh", mesh=mesh,
                 warm_state=half_l.state)
    np.testing.assert_allclose(_np(res_m.x), _np(full.x), **X_TOL)
    assert res_m.state.t == 100


def test_checkpoint_roundtrips_across_redundancy(systems, ref_runs,
                                                 tmp_path):
    ref_sys, sys_ = systems
    prm = ref_runs["apc"][0]
    r1 = _red(sys_, "apc", prm, iters=40, redundancy=2,
              alive_schedule=rotating_straggler(sys_.m))
    ckpt.save(str(tmp_path), 40, r1.state)
    restored = ckpt.restore(str(tmp_path), r1.state)
    r2 = _red(sys_, "apc", prm, iters=40, redundancy=3,
              warm_state=restored)
    full = ref_solvers.get("apc").solve(ref_sys, iters=80, **prm)
    np.testing.assert_allclose(_np(r2.x), _np(full.x), **X_TOL)


def test_heartbeat_monitor_drives_alive_mask(systems, ref_runs):
    """A HeartbeatMonitor as the schedule: its drop_set() is the mask,
    and a dead worker still yields the exact solution."""
    import time
    _, sys_ = systems
    prm, r_ref = ref_runs["apc"]
    mon = fault.HeartbeatMonitor(n_workers=sys_.m, timeout=60.0)
    now = time.monotonic()
    for w in range(sys_.m):
        mon.beat(w, now=now, duration=1.0)
    mon.mark_dead(2)
    _match(_red(sys_, "apc", prm, redundancy=2, alive_schedule=mon), r_ref)
    with pytest.raises(ValueError, match="HeartbeatMonitor"):
        _red(sys_, "apc", {}, iters=5, redundancy=2,
             alive_schedule=fault.HeartbeatMonitor(n_workers=sys_.m + 1))


def test_array_schedules(systems):
    """Static (m,) and per-iteration (T, m) mask arrays."""
    ref_sys, sys_ = systems
    s = ref_solvers.get("apc")
    prm = s.resolve_params(ref_sys)
    r_ref = s.solve(ref_sys, iters=60, **prm)
    static = np.array([True, False, True, True])
    _match(_red(sys_, "apc", prm, iters=60, redundancy=2,
                alive_schedule=static), r_ref)
    per_t = np.stack([np.roll(static, t) for t in range(60)])
    _match(_red(sys_, "apc", prm, iters=60, redundancy=2,
                alive_schedule=per_t), r_ref)
    with pytest.raises(ValueError, match="shape"):
        _red(sys_, "apc", prm, iters=60, redundancy=2,
             alive_schedule=np.ones((10, sys_.m), bool))


@pytest.mark.parametrize("backend", ["local", "mesh"])
def test_uncoverable_mask_raises_before_any_work(systems, backend,
                                                 monkeypatch):
    """r = 2 with two adjacent workers dead, and r = 1 with any straggler:
    the reference's RuntimeError, before the factors or any placement."""
    _, sys_ = systems
    s = solvers.get("apc")

    def no_work(*a, **k):
        raise AssertionError("work before the schedule was lowered")
    monkeypatch.setattr(redundant, "RedundantEngine", no_work)
    monkeypatch.setattr(s, "prepare", no_work)
    dead_pair = np.array([False, False, True, True])
    with pytest.raises(RuntimeError, match="unrecoverable"):
        _red(sys_, "apc", {"gamma": 1.0, "eta": 1.0}, iters=10,
             redundancy=2, alive_schedule=dead_pair, backend=backend)
    with pytest.raises(RuntimeError, match="unrecoverable"):
        _red(sys_, "apc", {"gamma": 1.0, "eta": 1.0}, iters=10,
             redundancy=1, alive_schedule=rotating_straggler(sys_.m),
             backend=backend)


def test_validation_errors(systems):
    """The reference's errors, with the messages its test matches."""
    _, sys_ = systems
    s = solvers.get("apc")
    with pytest.raises(ValueError, match="redundancy"):
        _red(sys_, "apc", {}, iters=5, redundancy=sys_.m + 1)
    with pytest.raises(CapabilityError, match="use_kernel"):
        _red(sys_, "apc", {}, iters=5, redundancy=2, kernel=True)
    with pytest.raises(CapabilityError, match="use_kernel"):
        _red(sys_, "apc", {}, iters=5, kernel=True,
             alive_schedule=np.ones(sys_.m, bool))
    for name in ("dgd", "madmm", "pdhbm"):
        with pytest.raises(ValueError, match="redundant"):
            _red(sys_, name, {}, iters=5, redundancy=2)
    B = np.ones((2, sys_.N))
    with pytest.raises(ValueError, match="solve_many"):
        s.solve_many(sys_, B, iters=5, plan=ExecutionPlan(redundancy=2))
    with pytest.raises(ValueError, match="solve_many"):
        s.solve_many(sys_, B, iters=5, plan=ExecutionPlan(
            alive_schedule=rotating_straggler(sys_.m)))
    sparse = linsys.banded_system(n=64, m=4, bandwidth=4, seed=0,
                                  device="cpu")
    ls = linsys.tall_gaussian(N=96, n=48, m=4, seed=0, noise=0.1,
                              device="cpu")
    for system, name in ((sparse, "apc"), (ls, "cimmino")):
        with pytest.raises(ValueError, match="dense-square"):
            _red(system, name, {}, iters=5, redundancy=2)


def test_selection_weights_match_reference():
    """The lowering is the reference's, bit for bit, on random masks and
    schedules; each block exactly once, the dead contributing nothing."""
    m, r = 6, 3
    holder = redundant.Assignment(m=m, r=r).holder
    np.testing.assert_array_equal(holder,
                                  ref_red.Assignment(m=m, r=r).holder)
    for trial in range(20):
        rng = np.random.default_rng(trial)
        alive = rng.random((5, m)) > 0.3
        if not all(fault.covering_ok(a, r) for a in alive):
            with pytest.raises(RuntimeError, match="unrecoverable"):
                redundant.schedule_weights(alive, r)
            continue
        W = redundant.schedule_weights(alive, r)
        np.testing.assert_array_equal(W, ref_red.schedule_weights(alive, r))
        for t in range(5):
            per_block = np.zeros(m)
            np.add.at(per_block, holder.ravel(), W[t].ravel())
            np.testing.assert_allclose(per_block, 1.0)
            assert W[t][~alive[t]].sum() == 0.0


# ---------------------------------------------------------------------------
# the hooks, one by one, against the reference's
# ---------------------------------------------------------------------------


def _close_tree(port, ref):
    """Every tensor field of ``port`` within HOOK_TOL of ``ref``'s."""
    for f in port._fields:
        p, r = getattr(port, f), getattr(ref, f)
        if p is None:
            assert r is None, f
            continue
        if not isinstance(p, torch.Tensor):
            assert int(np.asarray(r)) == p, f
            continue
        r = np.asarray(r, dtype=np.float64)
        d = float(np.abs(p.double().numpy() - r).max()) if r.size else 0.0
        assert d <= HOOK_TOL * (float(np.abs(r).max()) + 1.0), (f, d)


@pytest.mark.parametrize("name", PROJ)
def test_red_hooks_match_reference_hooks(systems, ref_runs, name):
    """red_factors, red_init, three red_steps under changing weights,
    red_collapse, red_expand and lift_state, the port's with its local
    context against the reference's with ``redundant._LocalContext()``."""
    ref_sys, sys_ = systems
    prm = ref_runs[name][0]
    ref, s = ref_solvers.get(name), solvers.get(name)
    ctx_r, ctx = ref_red._LocalContext(), redundant._LOCAL
    a_r, a = ref_red.Assignment(m=4, r=2), redundant.Assignment(m=4, r=2)
    f_r = ref.red_factors(ref.mesh_factors(ref.prepare(ref_sys.A_blocks,
                                                       prm)), a_r)
    f = s.red_factors(s.mesh_factors(s.prepare(sys_.A_blocks, prm)), a)
    _close_tree(f, f_r)
    _, b_r = ref_red.replicate_system(ref_sys, a_r)
    _, b = redundant.replicate_system(sys_, a)
    W0 = ref_red.selection_weights(np.ones(4, bool), 4, 2)
    st_r = ref.red_init(f_r, b_r, prm, jnp.asarray(W0), ctx_r)
    st = s.red_init(f, b, prm, torch.as_tensor(W0), ctx)
    _close_tree(st, st_r)
    for t in range(3):
        W = ref_red.selection_weights(rotating_straggler(4)(t), 4, 2)
        st_r = ref.red_step(f_r, b_r, st_r, prm, jnp.asarray(W), ctx_r)
        st = s.red_step(f, b, st, prm, torch.as_tensor(W), ctx)
        _close_tree(st, st_r)
    plain_r, plain = ref.red_collapse(st_r, a_r), s.red_collapse(st, a)
    _close_tree(plain, plain_r)
    _close_tree(s.red_expand(plain, a), ref.red_expand(plain_r, a_r))
    # the lift onto a five-block partition of the same rows
    A5_r, b5_r = ref_sys.dense()
    from repro.core import partition as ref_part
    from repro_torch.core import partition as part
    A5_r, b5_r = ref_part.pad_to_blocks(np.asarray(A5_r), np.asarray(b5_r),
                                        5)
    s5_r = ref_part.partition(A5_r, b5_r, 5)
    s5 = part.partition(torch.as_tensor(A5_r), torch.as_tensor(b5_r), 5)
    f5_r, f5 = ref.prepare(s5_r.A_blocks, prm), s.prepare(s5.A_blocks, prm)
    x = np.array(ref.extract(plain_r))
    _close_tree(s.lift_state(f5, s5.b_blocks, prm, torch.as_tensor(x)),
                ref.lift_state(f5_r, s5_r.b_blocks, prm, jnp.asarray(x)))
    assert s.supports_redundancy and s.supports_lift
    assert s.supports_block_store


def test_other_solvers_have_no_red_hooks():
    for name in ("dgd", "dnag", "dhbm", "madmm", "pdhbm"):
        s, ref = solvers.get(name), ref_solvers.get(name)
        assert s.supports_redundancy is ref.supports_redundancy is False
        assert s.supports_lift is ref.supports_lift
        with pytest.raises(NotImplementedError):
            s.lift_state(None, None, {}, None)


# ---------------------------------------------------------------------------
# the engine: compile-once segments, bit-equality
# ---------------------------------------------------------------------------


def test_engine_segments_bit_equal_one_run(systems, ref_runs):
    """A 150-step history split into segments of 25, 50 and 75 under a
    changing schedule is bit-equal to one run; the engine builds one
    program, ``executor.disable_capture()`` runs the same steps eagerly,
    bit for bit, and a repeat is bit-identical."""
    _, sys_ = systems
    prm = ref_runs["apc"][0]
    sched = redundant.resolve_schedule(rotating_straggler(4), 4, ITERS)
    one = redundant.RedundantEngine(solvers.get("apc"), sys_, r=2, **prm)
    W = one.lower(sched)
    s1, res1, err1 = one.run(one.init_state(), W)
    assert one.cache_size() == 1 and one.captures == 0     # the CPU
    again = one.run(one.init_state(), W)
    assert torch.equal(again[0].x, s1.x) and torch.equal(again[1], res1)
    seg = redundant.RedundantEngine(solvers.get("apc"), sys_, r=2, **prm)
    st, parts = seg.init_state(), []
    for a, b in ((0, 25), (25, 75), (75, 150)):
        st, res, _ = seg.run(st, seg.lower(sched[a:b]))
        parts.append(res)
    assert seg.cache_size() == 1
    assert torch.equal(torch.cat(parts), res1) and torch.equal(st.x, s1.x)
    assert st.t == s1.t == ITERS
    with executor.disable_capture():
        s2, res2, err2 = one.run(one.init_state(), W)
    assert torch.equal(s2.x, s1.x) and torch.equal(s2.xbar, s1.xbar)
    assert torch.equal(res2, res1) and torch.equal(err2, err1)
    r = solvers.get("apc").solve(sys_, iters=ITERS, plan=ExecutionPlan(
        redundancy=2, alive_schedule=rotating_straggler(4)), **prm)
    assert torch.equal(r.residuals, res1)


def test_store_factors_and_iters_zero(systems, ref_runs):
    """``plan.store`` supplies the factors (a miss, then a hit); zero
    iterations return the initial state and empty histories."""
    _, sys_ = systems
    prm = ref_runs["cimmino"][0]
    store = solvers.FactorStore()
    for _ in range(2):
        r = _red(sys_, "cimmino", prm, iters=20, redundancy=2, store=store)
    assert (store.stats.misses, store.stats.hits) == (1, 1)
    r0 = _red(sys_, "cimmino", prm, iters=0, redundancy=2)
    assert r0.residuals.shape == (0,) and r0.state.t == 0
    assert torch.equal(r0.x, torch.zeros_like(r.x))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("extra", [[], ["--use-mesh"]])
def test_cli_redundancy_prints_the_reference_lines(extra):
    """``--redundancy 2 --straggler-sim 0.5``: the reference CLI's lines
    (its local run: C0), but the times."""
    argv = ["--problem", "ash608", "--workers", "4", "--iters", "60",
            "--redundancy", "2", "--straggler-sim", "0.5"]
    outs = []
    for main, more in ((ref_cli.main, []),
                       (cli.main, ["--device", "cpu"] + extra)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert main(argv + more) == 0
        outs.append(buf.getvalue().splitlines())
    ref_lines, lines = outs
    assert "redundant execution: r=2, straggler rate 0.5" in lines
    lines = [ln for ln in lines if not ln.startswith("mesh backend")]
    assert lines[:-1] == ref_lines[:-1]
    assert lines[-1].startswith("done in") and "rel-error" in lines[-1]
    for bad in (["--redundancy", "2", "--method", "dgd"],
                ["--straggler-sim", "0.5"]):
        with pytest.raises(SystemExit):
            cli.main(["--workers", "4", "--iters", "5", "--device", "cpu"]
                     + bad)

