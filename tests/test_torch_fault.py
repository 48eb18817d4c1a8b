"""The port's fault runtime (``repro_torch.runtime.fault``) and its
deprecated ``core.coding`` shim, held against the reference's.

Twins of tests/test_coding.py: each scenario runs on the reference's
``repro.runtime.fault`` and on the port's copy, and both must give the
same masks, events and plans, besides the reference's own assertions.
The shim's redundant APC solve (the coding system, n = 96, m = 6) is held
to the reference's shim: x to rtol 1e-8 / atol 1e-10, the residual
history to rtol 1e-6 / atol 1e-12.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import coding as ref_coding  # noqa: E402
from repro.data import linsys as ref_linsys  # noqa: E402
from repro.runtime import fault as ref_fault  # noqa: E402
from repro_torch.core import coding  # noqa: E402
from repro_torch.data import linsys  # noqa: E402
from repro_torch.runtime import fault  # noqa: E402

BOTH = [ref_fault, fault]
X_TOL = dict(rtol=1e-8, atol=1e-10)
H_TOL = dict(rtol=1e-6, atol=1e-12)
SYS = dict(n=96, m=6, cond=10.0, seed=11)


def _both(scenario):
    """``scenario(module)`` on the reference and on the port: the same
    result from each."""
    ref, port = (scenario(mod) for mod in BOTH)
    assert repr(port) == repr(ref), (port, ref)
    return port


@pytest.fixture(scope="module")
def systems():
    return (ref_linsys.conditioned_gaussian(**SYS),
            linsys.conditioned_gaussian(**SYS, device="cpu"))


def test_selection_weights_cover_each_block_once():
    m, r = 6, 3
    for trial in range(20):
        alive = np.random.default_rng(trial).random(m) > 0.3
        assert fault.covering_ok(alive, r) == ref_fault.covering_ok(alive, r)
        if not fault.covering_ok(alive, r):
            continue
        W = coding.selection_weights(alive, m, r)
        np.testing.assert_array_equal(
            W, ref_coding.selection_weights(alive, m, r))
        per_block = np.zeros(m)
        for i in range(m):
            for k in range(r):
                per_block[(i + k) % m] += W[i, k]
        np.testing.assert_allclose(per_block, 1.0)
        assert W[~alive].sum() == 0.0


def test_unrecoverable_raises():
    alive = np.array([False, False, True, True])
    assert not fault.covering_ok(alive, 2)
    with pytest.raises(RuntimeError, match="unrecoverable"):
        coding.selection_weights(alive, 4, 2)


def test_replicate_matches_reference(systems):
    rs, ps = systems
    ref, port = ref_coding.replicate(rs, 3), coding.replicate(ps, 3)
    np.testing.assert_array_equal(port.holder_of, ref.holder_of)
    np.testing.assert_array_equal(port.A_rep.numpy(), np.asarray(ref.A_rep))
    np.testing.assert_array_equal(port.b_rep.numpy(), np.asarray(ref.b_rep))
    with pytest.raises(ValueError, match="redundancy"):
        coding.replicate(ps, ps.m + 1)


def test_straggler_run_matches_reference(systems):
    """The shim's r = 2 APC solve under a random straggler schedule, as
    the reference's test drives it, against the reference's shim."""
    rs, ps = systems

    def sched_from(seed):
        rng = np.random.default_rng(seed)

        def sched(t):
            a = np.ones(6, bool)
            if t % 2 == 0:
                a[rng.integers(0, 6)] = False
            return a
        return sched

    x_ref, res_ref = ref_coding.solve_redundant(
        rs, r=2, iters=150, alive_schedule=sched_from(2))
    x1, res1 = coding.solve_redundant(ps, r=2, iters=150)
    x2, res2 = coding.solve_redundant(ps, r=2, iters=150,
                                      alive_schedule=sched_from(2))
    np.testing.assert_allclose(x2.numpy(), np.asarray(x_ref), **X_TOL)
    np.testing.assert_allclose(res2, np.asarray(res_ref), **H_TOL)
    np.testing.assert_allclose(x1.numpy(), x2.numpy(), rtol=1e-10)
    assert res2[-1] < 1e-8


def test_solve_redundant_seed_param_removed(systems):
    _, ps = systems
    assert "seed" not in inspect.signature(
        coding.solve_redundant).parameters
    with pytest.raises(TypeError):
        coding.solve_redundant(ps, 2, iters=1, seed=0)


def test_heartbeat_monitor():
    def scenario(mod):
        mon = mod.HeartbeatMonitor(n_workers=4, timeout=5.0)
        for w in range(4):
            mon.beat(w, now=100.0, duration=1.0)
        out = [mon.alive_mask(now=102.0).tolist(),
               mon.alive_mask(now=106.0).tolist()]
        with pytest.raises(RuntimeError):
            mon.rejoin(1, resynced=False)
        mon.rejoin(1, resynced=True)
        out.append(bool(mon.alive_mask()[1]))
        return out
    got = _both(scenario)
    assert all(got[0]) and not any(got[1]) and got[2]


def test_straggler_detection():
    def scenario(mod):
        mon = mod.HeartbeatMonitor(n_workers=4, straggler_factor=2.0)
        for w in range(4):
            mon.beat(w, duration=1.0 if w else 10.0)
        return mon.stragglers().tolist()
    assert _both(scenario) == [True, False, False, False]


def test_dead_worker_excluded_from_straggler_median():
    def scenario(mod):
        mon = mod.HeartbeatMonitor(n_workers=4, timeout=5.0,
                                   straggler_factor=3.0)
        mon.beat(0, now=100.0, duration=100.0)
        mon.beat(1, now=108.0, duration=5.0)
        mon.beat(2, now=108.0, duration=1.0)
        mon.beat(3, now=108.0, duration=1.0)
        return (mon.stragglers(now=110.0).tolist(),
                mon.drop_set(now=110.0).tolist())
    s, drop = _both(scenario)
    assert s == [False, True, False, False]
    assert drop == [True, True, False, False]


def test_straggler_quorum_counts_live_workers():
    def scenario(mod):
        mon = mod.HeartbeatMonitor(n_workers=8, timeout=5.0,
                                   straggler_factor=3.0)
        for w in range(5):
            mon.beat(w, now=0.0, duration=1.0)
        mon.beat(5, now=100.0, duration=1.0)
        mon.beat(6, now=100.0, duration=1.0)
        mon.beat(7, now=100.0, duration=50.0)
        return mon.stragglers(now=101.0).tolist()
    assert _both(scenario) == [False] * 7 + [True]


def test_alive_mask_reads_are_pure():
    def scenario(mod):
        mon = mod.HeartbeatMonitor(n_workers=2, timeout=5.0)
        mon.beat(0, now=0.0)
        mon.beat(1, now=8.0)
        out = [mon.alive_mask(now=10.0).tolist(),
               mon.alive_mask(now=10.0).tolist()]
        mon.beat(0, now=11.0)
        out.append(bool(mon.alive_mask(now=12.0)[0]))
        mon.sweep(now=20.0)
        mon.beat(0, now=21.0)
        mon.beat(1, now=21.0)
        out.append(mon.alive_mask(now=22.0).tolist())
        mon.rejoin(0, resynced=True)
        out.append((bool(mon.alive_mask()[0]), bool(mon.alive_mask()[1])))
        return out
    m1, m2, readmit, swept, rejoined = _both(scenario)
    assert m1 == m2 == [False, True] and readmit
    assert swept == [False, False] and rejoined == (True, False)


def test_mark_dead_is_explicit_and_sticky():
    def scenario(mod):
        mon = mod.HeartbeatMonitor(n_workers=3, timeout=5.0)
        for w in range(3):
            mon.beat(w, now=0.0)
        mon.mark_dead(2)
        out = [mon.alive_mask(now=1.0).tolist()]
        mon.beat(2, now=2.0)
        out.append(bool(mon.alive_mask(now=2.5)[2]))
        mon.rejoin(2, resynced=True)
        out.append(bool(mon.alive_mask()[2]))
        return out
    assert _both(scenario) == [[True, True, False], False, True]


def test_membership_events():
    """The event stream the elastic runtime polls: died once a worker
    (explicit or swept), rejoined, joined — each with the alive count."""
    def scenario(mod):
        mon = mod.HeartbeatMonitor(n_workers=3, timeout=60.0)
        for w in range(3):
            mon.beat(w)
        mon.mark_dead(1)
        mon.mark_dead(1)
        first = [tuple(e) for e in mon.poll_events()]
        mon.rejoin(1, resynced=True)
        w = mon.join()
        with pytest.raises(RuntimeError):
            mon.join(resynced=False)
        return first, [(e.kind, e.worker) for e in mon.poll_events()], w, \
            sorted(mon.dead), mon.n_workers
    first, later, w, dead, n = _both(scenario)
    assert first == [("died", 1, 2)]
    assert later == [("rejoined", 1), ("joined", 3)] and w == 3
    assert dead == [] and n == 4


def test_covering_ok_accepts_plain_lists():
    for alive, r, want in (([True, False, False], 3, True),
                           ([False, False, False], 3, False),
                           ([True, False, True, True], 2, True),
                           ([False, False, True, True], 2, False)):
        assert fault.covering_ok(alive, r=r) is want
        assert ref_fault.covering_ok(alive, r=r) is want


def test_elastic_plan():
    p = _both(lambda mod: mod.ElasticPlan.shrink(n_devices_left=200,
                                                 model=16))
    assert p.data == 12 and p.model == 16 and p.dropped_hosts == 8
    with pytest.raises(RuntimeError):
        fault.ElasticPlan.shrink(n_devices_left=8, model=16)
