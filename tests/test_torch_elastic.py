"""The port's elastic runtime (``repro_torch.solvers.ElasticRuntime``),
held against the reference.

Twins of the local cases of tests/test_elastic.py, on its system
(``conditioned_gaussian(n=64, m=4, cond=10.0, seed=3)``, 150 iterations,
segments of 25): each port run is held to the reference's uninterrupted
plain local solve (x to rtol 1e-8 / atol 1e-10, histories to rtol 1e-6 /
atol 1e-12), and its bookkeeping (events, relowerings, repartitions,
fleet, reused and prepared blocks) to the reference's ``ElasticRuntime``
driven through the same membership changes.  The death path's bit
equality with the fixed-schedule solve is the port's own.  The mesh cases
run on a one-rank gloo group in-process, held to the reference's local
runs (its mesh cannot run on JAX 0.9.0, ROADMAP C0);
tests/test_torch_mesh_ranks.py runs world 4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

from repro import solvers as ref_solvers  # noqa: E402
from repro.data import linsys as ref_linsys  # noqa: E402
from repro.runtime.fault import HeartbeatMonitor as RefMonitor  # noqa: E402
from repro.solvers.capability import \
    ExecutionPlan as RefPlan  # noqa: E402
from repro_torch import solvers  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.data import linsys  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.runtime.fault import HeartbeatMonitor  # noqa: E402
from repro_torch.solvers.capability import (CapabilityError,  # noqa: E402
                                            ExecutionPlan)
from repro_torch.solvers.store import FactorStore  # noqa: E402

torch.set_num_threads(1)

PROJ = ["apc", "consensus", "cimmino"]
ITERS = 150
X_TOL = dict(rtol=1e-8, atol=1e-10)
H_TOL = dict(rtol=1e-6, atol=1e-12)
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
def oracle(systems):
    """The reference's uninterrupted plain local solve, and its params."""
    ref_sys, _ = systems
    out = {}
    for name in PROJ:
        s = ref_solvers.get(name)
        prm = s.resolve_params(ref_sys)
        out[name] = (prm, s.solve(ref_sys, iters=ITERS, **prm))
    return out


def _runtime(name, sys_, prm, *, redundancy=2, segment=25, plan=None,
             **kw):
    monitor = HeartbeatMonitor(n_workers=sys_.m)
    plan = ExecutionPlan(redundancy=redundancy) if plan is None else plan
    return solvers.ElasticRuntime(solvers.get(name), sys_, plan=plan,
                                  monitor=monitor, segment=segment, **prm,
                                  **kw), monitor


def _ref_runtime(name, ref_sys, prm, *, plan=None, **kw):
    monitor = RefMonitor(n_workers=ref_sys.m)
    plan = RefPlan(redundancy=2) if plan is None else plan
    return ref_solvers.ElasticRuntime(ref_solvers.get(name), ref_sys,
                                      plan=plan, monitor=monitor,
                                      segment=25, **prm, **kw), monitor


def _books(rep):
    """An ElasticReport's bookkeeping, whichever package made it."""
    return ([(e.kind, e.worker, e.alive) for e in rep.events], rep.iters,
            rep.segments, rep.reused_blocks, rep.prepared_blocks,
            rep.repartitions, rep.relowerings, rep.fleet)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _death(rt, mon):
    rep1 = rt.run(iters=50)
    mon.mark_dead(2)
    return rep1, rt.run(iters=ITERS - 50)


# ----------------------------------------------------------------- death
@pytest.mark.parametrize("backend", ["local", "mesh"])
@pytest.mark.parametrize("name", PROJ)
def test_death_relower_continues_exactly(systems, oracle, mesh, name,
                                         backend):
    """A death mid-run re-lowers the schedule over the survivors and the
    history is the uninterrupted run's; the bookkeeping is the
    reference's runtime's."""
    ref_sys, sys_ = systems
    prm, r_ref = oracle[name]
    plan = ExecutionPlan(redundancy=2, backend=backend,
                         mesh=mesh if backend == "mesh" else None)
    rt, mon = _runtime(name, sys_, prm, plan=plan)
    rep1, rep2 = _death(rt, mon)
    assert rep1.relowerings == 0 and rep1.segments == 2
    assert rep2.relowerings == 1 and rep2.iters == ITERS
    assert [e.kind for e in rep2.events] == ["died"]
    res = torch.cat([rep1.residuals, rep2.residuals])
    np.testing.assert_allclose(_np(res), _np(r_ref.residuals), **H_TOL)
    np.testing.assert_allclose(_np(rep2.x), _np(r_ref.x), **X_TOL)
    if backend == "local":
        ref_rt, ref_mon = _ref_runtime(name, ref_sys, prm)
        ref1, ref2 = _death(ref_rt, ref_mon)
        assert _books(rep1) == _books(ref1) and _books(rep2) == _books(ref2)


def test_death_bit_matches_fixed_schedule_path(systems, oracle):
    """The elastic death path and the one-shot solve(redundancy=2,
    alive_schedule=...) lower the same schedules: bit-equal x and
    histories, and the engine's programs stay flat across the death."""
    _, sys_ = systems
    prm = oracle["apc"][0]
    mask = np.array([True, True, False, True])
    sched = np.stack([np.ones(4, bool)] * 50 + [mask] * 100)
    ref = solvers.get("apc").solve(
        sys_, iters=ITERS,
        plan=ExecutionPlan(redundancy=2, alive_schedule=sched), **prm)
    rt, mon = _runtime("apc", sys_, prm)
    rep1 = rt.run(iters=50)
    sizes = rt.engine_cache_sizes()
    mon.mark_dead(2)
    rep = rt.run(iters=100)
    assert torch.equal(rep.x, ref.x)
    assert torch.equal(torch.cat([rep1.residuals, rep.residuals]),
                       ref.residuals)
    assert rt.engine_cache_sizes() == sizes == {4: 1}


def test_rejoin_same_size_is_pure_reassignment(systems, oracle):
    ref_sys, sys_ = systems
    prm, r_ref = oracle["apc"]
    reps = []
    for rt, mon in (_runtime("apc", sys_, prm),
                    _ref_runtime("apc", ref_sys, prm)):
        rt.run(iters=50)
        mon.mark_dead(1)
        rt.run(iters=50)
        mon.rejoin(1, resynced=True)
        reps.append((rt, rt.run(iters=50)))
    (rt, rep), (_, ref_rep) = reps
    assert rep.repartitions == 0 and rep.relowerings == 1
    assert rep.fleet == (0, 1, 2, 3)
    assert _books(rep) == _books(ref_rep)
    np.testing.assert_allclose(_np(rep.x), _np(r_ref.x), **X_TOL)
    assert list(rt.engine_cache_sizes()) == [4]


# ------------------------------------------------------------------ join
def test_join_repartitions_lifts_and_counts_factor_work(systems, oracle):
    """Fleet growth repartitions the rows, warm-starts through
    lift_state, and counts factor reuse and refactorization as the
    reference does; the x after the growth agrees with the reference
    runtime's."""
    ref_sys, sys_ = systems
    prm = oracle["apc"][0]
    rt, mon = _runtime("apc", sys_, prm)
    ref_rt, ref_mon = _ref_runtime("apc", ref_sys, prm)
    assert rt.prepared_blocks == sys_.m and rt.reused_blocks == 0
    for r_, m_ in ((rt, mon), (ref_rt, ref_mon)):
        r_.run(iters=100)
        assert m_.join(resynced=True) == sys_.m
    rep, ref_rep = rt.run(iters=200), ref_rt.run(iters=200)
    assert rep.repartitions == 1 and rep.fleet == (0, 1, 2, 3, 4)
    assert rt.sys.m == 5
    assert rep.prepared_blocks == 9 and rep.reused_blocks == 0
    assert _books(rep) == _books(ref_rep)
    np.testing.assert_allclose(_np(rep.x), _np(ref_rep.x), **X_TOL)
    np.testing.assert_allclose(_np(rep.residuals), _np(ref_rep.residuals),
                               **H_TOL)
    x, xt = _np(rep.x), _np(sys_.x_true)
    assert np.linalg.norm(x - xt) / np.linalg.norm(xt) <= 1e-6
    sizes = dict(rt.engine_cache_sizes())
    mon.mark_dead(4)
    rt.run(iters=25)
    mon.rejoin(4, resynced=True)
    rep2 = rt.run(iters=25)
    assert rep2.repartitions == 1
    assert dict(rt.engine_cache_sizes()) == sizes == {4: 1, 5: 1}


def test_return_to_a_seen_fleet_size_reuses_its_partition(systems,
                                                         oracle):
    """Grow to five, lose two, get one back: the fleet returns to four
    workers, whose partition, factors and engine are reused (no new
    factor work), with the reference runtime's bookkeeping."""
    ref_sys, sys_ = systems
    prm = oracle["cimmino"][0]
    books = []
    for make, plan in ((_runtime, ExecutionPlan(redundancy=2)),
                       (_ref_runtime, RefPlan(redundancy=2))):
        system = sys_ if make is _runtime else ref_sys
        rt, mon = make("cimmino", system, prm, plan=plan)
        rt.run(iters=25)
        mon.join(resynced=True)
        rt.run(iters=25)
        mon.mark_dead(4)
        mon.mark_dead(3)
        mon.rejoin(3, resynced=True)
        rep = rt.run(iters=25)
        books.append(_books(rep))
    assert books[0] == books[1]
    assert rep.repartitions == 2 and rep.prepared_blocks == 9
    assert rep.fleet == (0, 1, 2, 3)


# ------------------------------------------------- taskmaster loss
def test_taskmaster_recovery_from_disk_tier(systems, oracle, tmp_path):
    """A fresh runtime rebuilds from the store's disk tier (every block
    back as reuse) and the checkpointed iterate."""
    ref_sys, sys_ = systems
    prm = oracle["apc"][0]
    oracle300 = ref_solvers.get("apc").solve(ref_sys, iters=300, **prm)
    store_dir, ck_dir = str(tmp_path / "store"), str(tmp_path / "ck")
    rt, _ = _runtime("apc", sys_, prm, plan=ExecutionPlan(
        redundancy=2, store=FactorStore(directory=store_dir)),
        checkpoint_dir=ck_dir)
    rt.run(iters=150)
    del rt
    rt2 = solvers.ElasticRuntime.recover(
        solvers.get("apc"), sys_, ck_dir,
        plan=ExecutionPlan(redundancy=2,
                           store=FactorStore(directory=store_dir)),
        monitor=HeartbeatMonitor(n_workers=sys_.m), **prm)
    assert rt2.reused_blocks == sys_.m and rt2.prepared_blocks == 0
    rep = rt2.run(iters=150)
    assert rep.iters == 300
    np.testing.assert_allclose(_np(rep.x), _np(oracle300.x), rtol=1e-6,
                               atol=1e-10)
    assert float(rep.residuals[-1]) <= 1e-6


def test_checkpoint_roundtrips_across_membership_change(systems, oracle,
                                                        tmp_path):
    """checkpoint() after a join restores onto a fresh base-size fleet:
    the iterate is global-shaped, so the partition lifts it."""
    _, sys_ = systems
    prm = oracle["apc"][0]
    d = str(tmp_path)
    rt, mon = _runtime("apc", sys_, prm, checkpoint_dir=d)
    rt.run(iters=50)
    mon.join(resynced=True)
    rep = rt.run(iters=50)
    assert rep.repartitions == 1 and rt.sys.m == 5
    assert ckpt.latest_step(d) == 100
    rt2 = solvers.ElasticRuntime.recover(
        solvers.get("apc"), sys_, d, plan=ExecutionPlan(redundancy=2),
        monitor=HeartbeatMonitor(n_workers=sys_.m), **prm)
    assert rt2.sys.m == sys_.m
    rep2 = rt2.run(iters=200)
    assert rep2.iters == 300
    x, xt = _np(rep2.x), _np(sys_.x_true)
    assert np.linalg.norm(x - xt) / np.linalg.norm(xt) <= 1e-6


def test_mesh_checkpoint_crosses_to_local(systems, oracle, mesh, tmp_path):
    """A mesh runtime's checkpoint recovers onto the local backend and
    finishes the uninterrupted run's iterate."""
    _, sys_ = systems
    prm, r_ref = oracle["consensus"]
    d = str(tmp_path)
    rt, _ = _runtime("consensus", sys_, prm, checkpoint_dir=d,
                     plan=ExecutionPlan(redundancy=2, backend="mesh",
                                        mesh=mesh))
    rt.run(iters=75)
    rt2 = solvers.ElasticRuntime.recover(
        solvers.get("consensus"), sys_, d, plan=ExecutionPlan(redundancy=2),
        monitor=HeartbeatMonitor(n_workers=sys_.m), **prm)
    rep = rt2.run(iters=75)
    assert rep.iters == ITERS
    np.testing.assert_allclose(_np(rep.x), _np(r_ref.x), rtol=1e-6,
                               atol=1e-10)


# ------------------------------------------------------- loud failures
@pytest.mark.parametrize("backend", ["local", "mesh"])
def test_uncoverable_survivors_raise(systems, oracle, mesh, backend):
    _, sys_ = systems
    rt, mon = _runtime("apc", sys_, oracle["apc"][0], plan=ExecutionPlan(
        redundancy=2, backend=backend,
        mesh=mesh if backend == "mesh" else None))
    rt.run(iters=25)
    mon.mark_dead(0)
    mon.mark_dead(1)
    with pytest.raises(RuntimeError, match="uncoverable"):
        rt.run(iters=25)


def test_validation(systems):
    _, sys_ = systems
    s = solvers.get("apc")
    mon = HeartbeatMonitor(n_workers=sys_.m)
    with pytest.raises(TypeError, match="ExecutionPlan"):
        solvers.ElasticRuntime(s, sys_, plan={"redundancy": 2}, monitor=mon)
    with pytest.raises(ValueError, match="alive_schedule"):
        solvers.ElasticRuntime(
            s, sys_, monitor=mon,
            plan=ExecutionPlan(redundancy=2,
                               alive_schedule=np.ones(4, bool)))
    with pytest.raises(CapabilityError, match="kernel"):
        solvers.ElasticRuntime(s, sys_, monitor=mon,
                               plan=ExecutionPlan(redundancy=2, kernel=True))
    with pytest.raises(ValueError, match="monitor|workers"):
        solvers.ElasticRuntime(
            s, sys_, monitor=HeartbeatMonitor(n_workers=sys_.m + 1),
            plan=ExecutionPlan(redundancy=2))
    with pytest.raises(ValueError, match="segment"):
        solvers.ElasticRuntime(s, sys_, monitor=mon, segment=0,
                               plan=ExecutionPlan(redundancy=2))
    with pytest.raises(ValueError, match="checkpoint directory"):
        solvers.ElasticRuntime(s, sys_, monitor=mon,
                               plan=ExecutionPlan(redundancy=2)).checkpoint()
