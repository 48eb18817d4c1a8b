"""Fault tolerance & elasticity runtime (counterpart of
``repro.runtime.fault``: pure numpy and the standard library, so the port
keeps its own copy).

What runs where:

  * **Checkpoint/restart** — the driver loop (launch/solve.py, the
    elastic runtime) saves atomically via checkpoint/ckpt.py and resumes
    from ``latest_step`` on restart; the iterate is global-shaped, so
    restart is exact.

  * **Heartbeats / straggler detection** — `HeartbeatMonitor` tracks
    per-worker progress timestamps.  In a real deployment these arrive via
    the cluster control plane (GRPC/borglet); here the monitor is driven by
    the solver loop and by fault-injection tests.  Policy: a worker silent
    for > ``timeout`` is marked dead; one slower than ``straggler_factor``×
    median is a straggler.

  * **Straggler mitigation** — with r-redundant blocks
    (repro_torch.solvers.redundant) an iteration closes as soon as a covering
    subset of workers responded: the monitor produces the alive-mask,
    ``redundant.selection_weights`` reweights the master averaging.
    Semantically exact (see solvers/redundant.py docstring), so convergence
    is unaffected.  ``solve(..., alive_schedule=monitor)`` accepts a
    ``HeartbeatMonitor`` directly; its ``drop_set()`` is snapshotted when
    the schedule is lowered at launch, so a long-running deployment keeps
    masks fresh by solving in warm-started segments (one lowering each).

  * **Elastic re-mesh** — for LM training, device loss requires a new mesh:
    `ElasticPlan.shrink` computes the largest (data', model) mesh that fits
    the survivors, keeping the model axis intact (TP degree is a property
    of the checkpointed layout; the data axis is elastic).  The driver then
    restores the last checkpoint onto the new mesh — parameters are saved
    mesh-agnostically (full arrays per leaf), so any mesh can load them.

  * **Rejoin/resync** — a recovered APC worker must refresh its replicas'
    ``x_j`` from a live holder before re-entering the averaging set
    (coding.py invariant); `HeartbeatMonitor.rejoin` models that handshake.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np


class MembershipEvent(NamedTuple):
    """One fleet-membership transition, as observed by the monitor.

    ``kind`` is ``"died"`` (explicit ``mark_dead`` or a ``sweep`` timeout
    — emitted once per worker until it rejoins), ``"rejoined"`` (a
    previously-dead worker back after the resync handshake), or
    ``"joined"`` (a NEW worker grew the fleet via ``join``).  ``alive``
    is the post-transition alive count — consumers that repartition use
    it without re-deriving monitor state.
    """
    kind: str
    worker: int
    alive: int


@dataclasses.dataclass
class HeartbeatMonitor:
    n_workers: int
    timeout: float = 10.0            # seconds without progress => dead
    straggler_factor: float = 3.0    # x median iteration time => straggler
    _last: Dict[int, float] = dataclasses.field(default_factory=dict)
    _durations: Dict[int, float] = dataclasses.field(default_factory=dict)
    _dead: set = dataclasses.field(default_factory=set)
    _events: List[MembershipEvent] = dataclasses.field(default_factory=list)

    def _emit(self, kind: str, worker: int, now: Optional[float] = None):
        self._events.append(MembershipEvent(
            kind=kind, worker=worker,
            alive=int(self.alive_mask(now).sum())))

    @property
    def dead(self) -> frozenset:
        """Workers currently evicted (sticky until ``rejoin``) — the
        membership truth an in-process driver keys alive masks off
        (heartbeat timeouts need real workers beating; the elastic
        runtime drives beats itself and uses explicit deaths only)."""
        return frozenset(self._dead)

    def poll_events(self) -> List[MembershipEvent]:
        """Drain the membership-event stream (ordered, each transition
        exactly once).  The elastic runtime polls this between solve
        segments and reacts: died -> re-lower the selection weights over
        the survivors, joined/rejoined -> repartition + warm-start."""
        events, self._events = self._events, []
        return events

    def beat(self, worker: int, now: Optional[float] = None,
             duration: Optional[float] = None):
        """Record progress.  A beat never readmits an explicitly-dead
        worker — its replicas may be stale, so readmission goes through the
        ``rejoin`` resync handshake."""
        now = time.monotonic() if now is None else now
        self._last[worker] = now
        if duration is not None:
            self._durations[worker] = duration

    def mark_dead(self, worker: int):
        """Explicitly evict a worker (sticky until ``rejoin``)."""
        if worker not in self._dead:
            self._dead.add(worker)
            self._emit("died", worker)

    def sweep(self, now: Optional[float] = None) -> np.ndarray:
        """Mark every timed-out worker dead and return the alive mask.

        This is the explicit state transition that ``alive_mask`` used to
        perform as a read side effect: once swept, a timed-out worker stays
        dead (even if heartbeats resume) until it ``rejoin``s with a resync.
        """
        now = time.monotonic() if now is None else now
        for w in range(self.n_workers):
            last = self._last.get(w)
            if (last is None or now - last > self.timeout) \
                    and w not in self._dead:
                self._dead.add(w)
                self._emit("died", w, now)
        return self.alive_mask(now)

    def rejoin(self, worker: int, *, resynced: bool):
        """A dead worker may only rejoin after resyncing its block state."""
        if not resynced:
            raise RuntimeError(
                f"worker {worker} must resync replicas before rejoining")
        if worker in self._dead:
            self._dead.discard(worker)
            self._last[worker] = time.monotonic()
            self._emit("rejoined", worker)
        else:
            self._last[worker] = time.monotonic()

    def join(self, *, resynced: bool = True) -> int:
        """Grow the fleet by one NEW worker and return its id.

        Unlike ``rejoin`` (a known worker returning to its old slot), a
        join changes the fleet SIZE — consumers must repartition.  The
        newcomer still owes the resync handshake: it holds no block
        state at all, so admitting it without one would be worse than a
        stale rejoin.
        """
        if not resynced:
            raise RuntimeError(
                "a joining worker must sync block state before admission")
        worker = self.n_workers
        self.n_workers += 1
        self._last[worker] = time.monotonic()
        self._emit("joined", worker)
        return worker

    def alive_mask(self, now: Optional[float] = None) -> np.ndarray:
        """PURE read: alive = not explicitly dead AND beaten within timeout.

        Two consecutive reads (same ``now``) always agree; death becomes
        sticky only through the explicit ``mark_dead`` / ``sweep`` paths.
        """
        now = time.monotonic() if now is None else now
        mask = np.ones(self.n_workers, dtype=bool)
        for w in range(self.n_workers):
            last = self._last.get(w)
            if w in self._dead or last is None or now - last > self.timeout:
                mask[w] = False
        return mask

    def stragglers(self, now: Optional[float] = None) -> np.ndarray:
        """Live workers slower than ``straggler_factor`` x the live median.

        Dead workers' stale durations are excluded from the median — one
        dead-slow worker must not inflate it and mask live stragglers — and
        a dead worker is never itself flagged (it is already excluded via
        the alive mask).
        """
        now = time.monotonic() if now is None else now
        alive = self.alive_mask(now)
        mask = np.zeros(self.n_workers, dtype=bool)
        live = {w: d for w, d in self._durations.items() if alive[w]}
        # quorum over the LIVE fleet: a heavily degraded fleet must not
        # lose straggler detection just because most workers are dead
        if len(live) >= max(2, int(alive.sum()) // 2):
            med = float(np.median(list(live.values())))
            for w, d in live.items():
                if d > self.straggler_factor * med:
                    mask[w] = True
        return mask

    def drop_set(self, now: Optional[float] = None) -> np.ndarray:
        """Workers to exclude this iteration: dead OR straggling (pure).

        ``now`` is resolved ONCE so both terms see the same instant — a
        worker straddling the timeout boundary must not be alive in one
        term and dead in the other within a single read.
        """
        now = time.monotonic() if now is None else now
        return ~self.alive_mask(now) | self.stragglers(now)


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """Largest legal mesh after losing devices (model axis preserved)."""
    data: int
    model: int
    dropped_hosts: int

    @staticmethod
    def shrink(n_devices_left: int, model: int) -> "ElasticPlan":
        if n_devices_left < model:
            raise RuntimeError(
                f"{n_devices_left} devices cannot sustain TP={model}; "
                "restore needs a smaller-TP checkpoint layout")
        data = n_devices_left // model
        return ElasticPlan(data=data, model=model,
                           dropped_hosts=n_devices_left - data * model)


def covering_ok(alive: np.ndarray, r: int) -> bool:
    """Can an r-redundant cyclic assignment still cover all blocks?

    Block j is lost iff workers {j, j-1, ..., j-r+1 (mod m)} are all dead —
    i.e. r cyclically-consecutive failures.
    """
    alive = np.asarray(alive, dtype=bool)
    m = len(alive)
    dead = ~alive
    if r >= m:
        return bool(alive.any())
    run = 0
    # unwrap: scan 2m to catch wrap-around runs
    for i in range(2 * m):
        run = run + 1 if dead[i % m] else 0
        if run >= r:
            return False
    return True
