"""Async pipelined linear-system serving: overlapped admission → batch
assembly → execution → streaming result return.

Counterpart of ``repro.solvers.pipeline`` (local backend).
``LinsysServer`` is a synchronous ``step()``/``drain()`` loop;
``AsyncLinsysServer`` decomposes the same serving contract into pipeline
stages connected by bounded queues:

  1. **Admission with backpressure** — ``submit(fp, rhs)`` returns a
     ``Ticket`` whose future streams the result back.  At most
     ``admit_capacity`` requests are in the system (queued or in flight):
     beyond it the request is REJECTED with an explicit ``Shed`` result.
  2. **Batch assembly on a host thread** — the sync server's FIFO
     oldest-pending-system rule and ``take_group`` coalescing/padding,
     factor acquisition through the shared ``FactorStore`` (with the
     server's ``precision``), placement, and the host→device copy of the
     batch (``LocalExecutor.place_B``), so the copy of batch B+1 overlaps
     the execution of batch B.
  3. **A pool of in-flight executors** — up to ``pipeline_depth`` batches
     run concurrently on the compile-once executors of ``LinsysServer``
     (same keys, same zero-steady-state-rebuild invariant).  An executor
     serializes its own runs from copy-in to clone-out; the captured
     graphs of different executors replay side by side.
  4. **Streaming result return** — each request's future resolves to a
     ``Served`` (or ``Shed``) the moment its batch completes; per-request
     latency (submit → result) is recorded for the SLO report.

A failed batch sets its exception on its tickets; nothing is retried and
nothing falls back to the CPU.

``backend="mesh"`` keeps exactly one thread a rank issuing collectives:
on rank 0 the assembly thread announces each batch to the followers
(``LinsysServer._assemble``) and runs it itself, without the pool, and
``close()`` sends the followers the stop flag once that thread has
ended; the other ranks run ``serve_follower()`` on their main thread.
So the mesh executor's captures (NCCL) run on that thread alone, while
no other thread of the rank issues work on the group's stream: the
caller's thread only admits and waits.

    srv = AsyncLinsysServer(store, solver="apc", batch=4,
                            pipeline_depth=2, admit_capacity=64)
    fp = srv.register(sys)
    with srv:                                   # start()/close()
        tickets = [srv.submit(fp, b) for b in stream]
        for t in tickets:
            r = t.result()                      # Served or Shed
    srv.latency_report()                        # p50/p95/p99 ms, count
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, NamedTuple, Optional, Union

import numpy as np

from .serve import LinsysServer, Served, _Batch, take_group
from .store import FactorStore

__all__ = ["AsyncLinsysServer", "Shed", "Ticket"]


class Shed(NamedTuple):
    """Explicit overload result: the request was REJECTED at admission
    because ``admit_capacity`` requests were already in the pipeline."""
    rid: int
    fp: str


Result = Union[Served, Shed]


class Ticket(NamedTuple):
    """Admission receipt: the future resolves to ``Served`` (success) or
    ``Shed`` (rejected at admission — resolved immediately)."""
    rid: int
    fp: str
    future: Future
    t_submit: float

    def result(self, timeout: Optional[float] = None) -> Result:
        return self.future.result(timeout)


class _AsyncRequest(NamedTuple):
    rid: int
    fp: str
    rhs: np.ndarray
    future: Future
    t_submit: float


class AsyncLinsysServer(LinsysServer):
    """Pipelined twin of ``LinsysServer``: same registration, coalescing,
    store, executor-cache and warm-start semantics — decomposed into
    admission / assembly / execution stages so they overlap.

    ``pipeline_depth`` bounds concurrently-executing batches (the pool
    size AND the assembly→execution hand-off); ``admit_capacity`` bounds
    requests in the system, beyond which ``submit`` sheds.  ``step()`` is
    not part of this server's surface; ``drain()`` blocks until every
    ticket since the last drain resolved and returns the results in
    submission (rid) order.
    """

    def __init__(self, store: Optional[FactorStore] = None, *,
                 pipeline_depth: int = 2,
                 admit_capacity: Optional[int] = None, **kw):
        super().__init__(store, **kw)
        if pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {pipeline_depth}")
        if admit_capacity is None:
            # enough for every executor slot plus a full assembly backlog
            admit_capacity = 8 * self.batch * pipeline_depth
        if admit_capacity < 1:
            raise ValueError(
                f"admit_capacity must be >= 1, got {admit_capacity}")
        self.pipeline_depth = pipeline_depth
        self.admit_capacity = admit_capacity
        self._admit_base = admit_capacity   # full-fleet capacity; see
                                            # on_membership()
        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)   # assembly wakeups
        self._idle = threading.Condition(self._lock)   # drain/close wakeups
        self._in_system = 0       # admitted and not yet completed
        self._inflight = 0        # batches dispatched and not yet completed
        self._busy = set()        # fps serialized for warm-state chaining
        self._tickets: List[Ticket] = []
        self._lat: List[float] = []
        self._stopping = False
        self._assembler: Optional[threading.Thread] = None
        self._pool: Optional[ThreadPoolExecutor] = None
        # bounded assembly->execution hand-off: acquiring a slot blocks the
        # assembly thread once pipeline_depth batches are in flight
        self._slots = threading.Semaphore(pipeline_depth)

    # ----- lifecycle --------------------------------------------------------
    def start(self) -> "AsyncLinsysServer":
        """Start the assembly thread and the executor pool (idempotent)."""
        with self._lock:
            if self._assembler is not None:
                return self
            self._stopping = False
            self._pool = ThreadPoolExecutor(
                max_workers=self.pipeline_depth,
                thread_name_prefix="linsys-exec")
            self._assembler = threading.Thread(
                target=self._assemble_loop, name="linsys-assembly",
                daemon=True)
            self._assembler.start()
        return self

    def close(self, drain: bool = True) -> None:
        """Drain the pipeline (default) and stop the stage threads; on a
        mesh of several ranks, then send the followers the stop flag
        (``LinsysServer.close``)."""
        try:
            self._stop_stages(drain)
        finally:
            super().close()

    def _stop_stages(self, drain: bool) -> None:
        with self._lock:
            started = self._assembler is not None
            has_work = self._in_system > 0
        if not started:
            if has_work and drain:
                self.start()
            elif not has_work:
                return
        if drain:
            with self._idle:
                while self._in_system or self._inflight:
                    self._idle.wait(0.05)
        with self._lock:
            self._stopping = True
            self._work.notify_all()
            assembler, pool = self._assembler, self._pool
            self._assembler, self._pool = None, None
        if assembler is not None:
            assembler.join()
        if pool is not None:
            pool.shutdown(wait=True)

    def __enter__(self) -> "AsyncLinsysServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ----- stage 1: admission with backpressure -----------------------------
    def submit(self, fp: str, rhs) -> Ticket:        # type: ignore[override]
        """Admit one request, or shed it with an explicit overload result.

        Validation is the sync server's, shared.  A full pipeline
        (``admit_capacity`` requests queued or in flight) resolves the
        ticket's future IMMEDIATELY with ``Shed``.  On a mesh of several
        ranks, rank 0 alone admits.
        """
        self._admits()
        _, rhs = self._validated(fp, rhs)
        fut: Future = Future()
        t = time.perf_counter()
        with self._lock:
            rid = self._rid
            self._rid += 1
            tk = Ticket(rid=rid, fp=fp, future=fut, t_submit=t)
            self._tickets.append(tk)
            if self._in_system >= self.admit_capacity:
                self.stats.shed += 1
                shed = True
            else:
                self.stats.admitted += 1
                self._in_system += 1
                self._queues[fp].append(_AsyncRequest(
                    rid=rid, fp=fp, rhs=rhs, future=fut, t_submit=t))
                self._work.notify()
                shed = False
        if shed:
            fut.set_result(Shed(rid=rid, fp=fp))
        return tk

    def in_system(self) -> int:
        """Requests admitted and not yet completed (queued + in flight)."""
        with self._lock:
            return self._in_system

    def on_membership(self, alive: int, total: int) -> int:
        """Scale admission to the live fraction of the worker fleet: a
        shrunken fleet sheds more at admission instead of queueing
        unboundedly; capacity never drops below 1.  Returns the new
        ``admit_capacity``."""
        if total < 1:
            raise ValueError(f"total workers must be >= 1, got {total}")
        if not 0 <= alive <= total:
            raise ValueError(
                f"alive={alive} must be within [0, total={total}]")
        with self._lock:
            self.admit_capacity = max(
                1, int(self._admit_base * alive / total))
            return self.admit_capacity

    # ----- stage 2: batch assembly (host thread) ----------------------------
    def _next_group(self):
        """Under the lock: oldest-pending eligible system -> FIFO group.
        With ``warm_start`` on, a system whose batch is still in flight is
        skipped (its next batch needs that batch's final states)."""
        pending = [(q[0].rid, fp) for fp, q in self._queues.items()
                   if q and fp not in self._busy]
        if not pending:
            return None
        fp = min(pending)[1]
        group, n_real = take_group(self._queues[fp], self.batch)
        if self.warm_start:
            self._busy.add(fp)
        return fp, group, n_real

    def _assemble_loop(self):
        while True:
            with self._work:
                item = self._next_group()
                while item is None:
                    if self._stopping:
                        return
                    self._work.wait(0.05)
                    item = self._next_group()
            fp, group, n_real = item
            try:
                # the sync server's assembly (store with the server's
                # precision, placement, the batch's copy to the device) on
                # THIS thread: the copy of batch B+1 overlaps batch B
                work = self._assemble(fp, group, n_real)
            except Exception as e:               # noqa: BLE001 — stage must
                self._complete_error(fp, group[:n_real], e)   # not die
                continue
            # bounded hand-off: blocks while pipeline_depth batches are in
            # flight — THE backpressure between assembly and execution
            self._slots.acquire()
            with self._lock:
                self._inflight += 1
            if self.backend == "mesh":
                # the collectives of a batch follow its announcement on
                # this thread, the one thread of this rank that issues any
                self._execute(work)
            else:
                self._pool.submit(self._execute, work)

    # ----- stage 3+4: execution pool, streaming completion ------------------
    def _execute(self, w: _Batch) -> None:
        try:
            states, X, res = w.ex.run(
                w.A, w.factors, w.Bb_dev,
                w.ent.last_states if w.warm else None)
            # the store replaced this batch's entry meanwhile: its program
            # (rebuilt if the assembly thread dropped it first) goes too
            if w.ent.placed_src is not w.src:
                w.ex.drop(w.A, w.factors)
            out = self._results(w.fp, w.group, w.n_real, X, res, w.warm)
            t_done = time.perf_counter()
            with self._lock:
                if self.warm_start:
                    w.ent.last_states, w.ent.last_Bb = states, w.Bb
                    self._busy.discard(w.fp)     # unblocks warm chaining
                self.stats.batches += 1
                self.stats.served += w.n_real
                self.stats.padded += len(w.group) - w.n_real
                self.stats.warm_batches += int(w.warm)
                for r in w.group[:w.n_real]:
                    self._lat.append(t_done - r.t_submit)
                self._in_system -= w.n_real
                self._inflight -= 1
                self._work.notify_all()
                self._idle.notify_all()
            for r, s in zip(w.group[:w.n_real], out):
                r.future.set_result(s)
        except Exception as e:                   # noqa: BLE001
            with self._lock:
                self._busy.discard(w.fp)
                self._in_system -= w.n_real
                self._inflight -= 1
                self._work.notify_all()
                self._idle.notify_all()
            for r in w.group[:w.n_real]:
                if not r.future.done():
                    r.future.set_exception(e)
        finally:
            self._slots.release()

    def _complete_error(self, fp, requests, exc) -> None:
        with self._lock:
            self._busy.discard(fp)
            self._in_system -= len(requests)
            self._work.notify_all()
            self._idle.notify_all()
        for r in requests:
            if not r.future.done():
                r.future.set_exception(exc)

    # ----- draining / reporting ---------------------------------------------
    def step(self):
        raise RuntimeError(
            "AsyncLinsysServer serves on its pipeline threads: submit() "
            "returns a Ticket whose future streams the result; use "
            "drain() (or ticket.result()) instead of step()")

    def drain(self, final: bool = False) -> List[Result]:
        """Block until every ticket since the last drain resolved; return
        the results in submission (rid) order — ``Served`` for admitted
        requests, ``Shed`` for rejected ones.  With zero outstanding
        tickets this is a true no-op ([] — no threads started, no
        executor build).  ``final=True`` then closes the server."""
        try:
            with self._lock:
                tickets, self._tickets = self._tickets, []
                has_work = self._in_system > 0
            if not tickets:
                return []
            if has_work:
                self.start()
            return [t.future.result() for t in tickets]
        finally:
            if final:
                self.close()

    def latencies(self) -> np.ndarray:
        """Per-request submit→result latencies (seconds) so far."""
        with self._lock:
            return np.asarray(self._lat, dtype=float)

    def reset_metrics(self) -> None:
        """Clear the latency record and traffic counters (keeps executors,
        placements and warm states — benchmarks prime then measure)."""
        with self._lock:
            self._lat = []
            builds = self.stats.executor_builds
            self.stats = type(self.stats)(executor_builds=builds)

    def latency_report(self) -> dict:
        """The SLO view: count, p50/p95/p99/mean/max in milliseconds."""
        lat = self.latencies()
        if lat.size == 0:
            return {"count": 0, "p50_ms": float("nan"),
                    "p95_ms": float("nan"), "p99_ms": float("nan"),
                    "mean_ms": float("nan"), "max_ms": float("nan")}
        q = np.percentile(lat, [50, 95, 99]) * 1e3
        return {"count": int(lat.size), "p50_ms": float(q[0]),
                "p95_ms": float(q[1]), "p99_ms": float(q[2]),
                "mean_ms": float(lat.mean() * 1e3),
                "max_ms": float(lat.max() * 1e3)}
