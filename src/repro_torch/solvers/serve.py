"""Linear-system request server on the unified solver API.

Counterpart of ``repro.solvers.serve`` (local backend).  ``LinsysServer``
turns the paper's cost split into a serving loop: a stream of
``(system_fingerprint, rhs)`` requests is coalesced into same-system
``solve_many`` batches, every factorization comes from a
content-addressed ``FactorStore`` (memory LRU + optional disk tier), and
each batch runs through a compile-once ``executor.LocalExecutor`` keyed
by ``executor.executor_key`` (solver, shapes, params, plan signature,
batch, iterations): on the card its program is captured into one CUDA
graph per placed system and batch shape, and every later batch replays
it.

    store = FactorStore(directory="/ckpt/factors")
    srv = LinsysServer(store, solver="apc", iters=500, batch=4)
    fp = srv.register(sys)                      # fingerprint the system
    srv.submit(fp, b1); srv.submit(fp, b2)      # enqueue right-hand sides
    for served in srv.drain():                  # FIFO, coalesced batches
        served.x, served.residual               # numpy, as the reference

Batching: groups are FIFO by the oldest pending request's system, a
short final group is padded by repeating the last request so the batch
shape (and its captured program) stays stable, and padding is NEVER
counted in throughput.

Kernel serving (``use_kernel=True``, projection solvers): every batch
runs through the CUDA kernels, one launch of each per iteration for the
whole batch; the store entry is augmented with the pinv factors once, and
``precision="mixed"`` serves its bf16-stored entry.

Warm starts (``warm_start=True``): a system's previous batch state seeds
the next one.  Repeated right-hand sides always qualify; PERTURBED ones
only for solvers whose state caches nothing RHS-dependent
(``Solver.warm_rhs_ok``: the gradient family and Cimmino).

The mesh backend (``backend="mesh"``) is not ported yet (ROADMAP A14):
it raises ``NotImplementedError`` at construction.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.partition import BlockSystem

from . import executor
from .api import iters_to_tolerance
from .capability import ExecutionPlan, check_capability, resolve_use_kernel
from .store import FactorStore

__all__ = ["LinsysServer", "Request", "Served", "ServerStats",
           "StreamReport", "solve_stream", "take_group"]


def take_group(queue, batch: int):
    """Pop the next slot group off the request queue, FIFO.

    Returns ``(group, n_real)``: up to ``batch`` requests in arrival order,
    padded by repeating the last one so the batch shape is stable.  Only
    ``n_real`` requests were actually served — padding must never be
    counted in throughput.
    """
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    n_real = min(batch, len(queue))
    group = [queue.popleft() for _ in range(n_real)]
    while group and len(group) < batch:
        group.append(group[-1])
    return group, n_real


class Request(NamedTuple):
    rid: int            # server-assigned id, arrival order
    fp: str             # system fingerprint (FactorStore key)
    rhs: np.ndarray     # (N,) right-hand side


class Served(NamedTuple):
    """Per-request result handed back by ``step``/``drain``."""
    rid: int
    fp: str
    x: np.ndarray       # (n,) solution estimate
    residual: float     # final relative residual ||Ax-b||/||b||
    iters_to_tol: int   # -1 sentinel = tolerance never reached
    warm: bool          # batch was warm-started from a prior state


@dataclasses.dataclass
class ServerStats:
    served: int = 0             # real requests completed (padding excluded)
    padded: int = 0             # pad slots run (never counted as traffic)
    batches: int = 0
    warm_batches: int = 0
    executor_builds: int = 0    # compile-once cache misses
    admitted: int = 0           # accepted into the pipeline (async server)
    shed: int = 0               # rejected at admission (async server
                                # backpressure; the sync server never sheds)


@dataclasses.dataclass
class _System:
    """Per-registered-system serving state."""
    sys: BlockSystem
    prm: Dict[str, float]
    dtype: Any                      # A's numpy dtype, read once at register()
    executor_key: Tuple             # compile-once cache key, built once
    use_kernel: bool = False        # per-system resolution (downgraded only
                                    # for solvers with no kernel engine)
    A_placed: Any = None            # placed A (the system's own operand)
    factors_placed: Any = None      # placed factors (the store's entry)
    placed_src: Any = None          # store factors the placement came from
                                    # (None: not placed, or released)
    last_states: Any = None         # prior batch's final states (warm start)
    last_Bb: Optional[np.ndarray] = None


class _Batch(NamedTuple):
    """One assembled batch (``LinsysServer._assemble``): the placement it
    runs on and its right-hand sides, on the host and on the device."""
    fp: str
    ent: _System
    ex: Any                 # its executor.LocalExecutor
    group: list             # the requests, padding included
    n_real: int
    A: Any                  # the placement (LocalExecutor.place_system)
    factors: Any
    src: Any                # the store entry it was placed from
    Bb: np.ndarray          # host copy (warm-start repeat detection)
    Bb_dev: Any             # device copy (LocalExecutor.place_B)
    warm: bool


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


class LinsysServer:
    """Batched linear-system serving on the unified solver lifecycle.

    Requests for the SAME system (by content fingerprint) are coalesced
    into ``solve_many`` batches; the oldest pending request picks which
    system is served next, so no system starves while coalescing still
    fills batches.  All factor acquisition goes through the
    ``FactorStore`` — the first request for a system pays ``prepare`` (a
    store miss, or a disk hit after a restart), every later one is a hit.
    """

    def __init__(self, store: Optional[FactorStore] = None, *,
                 solver="apc", iters: int = 500, tol: float = 1e-6,
                 batch: int = 4, plan: Optional[ExecutionPlan] = None,
                 backend: str = "local", mesh=None,
                 warm_start: bool = False, use_kernel: bool = False,
                 precision: str = "default", **params):
        if plan is not None:
            if not isinstance(plan, ExecutionPlan):
                raise TypeError(f"plan must be an ExecutionPlan, got "
                                f"{type(plan).__name__}")
            if (backend != "local" or mesh is not None or use_kernel
                    or precision != "default"):
                raise ValueError(
                    "pass the execution surface EITHER on plan= OR as "
                    "loose kwargs, not both")
            if plan.redundancy > 1:
                raise ValueError(
                    "redundant execution is not servable: the coalesced "
                    "solve_many batches have no coded replicated layout; "
                    "run solve(plan=ExecutionPlan(redundancy=..., "
                    "alive_schedule=...)) per right-hand side")
            if plan.warm_state is not None or plan.factors is not None:
                raise ValueError(
                    "a server plan cannot carry warm_state=/factors= — "
                    "warm starts are per-system (warm_start=True) and "
                    "factors flow through the FactorStore")
            if store is None and plan.store is not None:
                store = plan.store
            backend = plan.backend
            use_kernel, precision = plan.kernel, plan.precision
        else:
            plan = ExecutionPlan(backend=backend, kernel=use_kernel,
                                 precision=precision)
        if backend == "mesh" or mesh is not None:
            raise NotImplementedError(
                "backend='mesh' serving is not ported yet (ROADMAP A14): "
                "the port serves on one device (backend='local')")
        if backend != "local":
            raise ValueError(f"unknown backend {backend!r}; "
                             "expected 'local' or 'mesh'")
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        from .registry import get
        self.store = store if store is not None else FactorStore()
        self.solver = get(solver) if isinstance(solver, str) else solver
        if use_kernel and not self.solver.supports_kernel:
            raise ValueError(
                f"solver {self.solver.name!r} is not projection-based and "
                f"has no kernel path (use_kernel=True unsupported)")
        self.solver._check_precision(precision, use_kernel)
        self.plan = dataclasses.replace(plan, store=None)
        self.iters, self.tol, self.batch = iters, tol, batch
        self.backend = backend
        self.warm_start = warm_start
        self.use_kernel = use_kernel
        self.precision = precision
        self.params = params
        self.stats = ServerStats()
        self._systems: Dict[str, _System] = {}
        self._queues: Dict[str, deque] = {}
        self._executors: Dict[Tuple, Any] = {}
        self._rid = 0

    # ----- request intake ---------------------------------------------------
    def register(self, sys: BlockSystem, **params) -> str:
        """Fingerprint ``sys`` and make it servable.  Factors are NOT
        prefetched — the first request pays the store miss (or disk hit).
        Per-register ``params`` override the server-level ones key by key.

        Capability is checked HERE; the kernel flag resolves per system
        (a sparse system on a solver with no kernel downgrades, loudly),
        and the precision is checked again against the resolved flag."""
        check_capability(self.solver, sys, context="register")
        use_kernel = resolve_use_kernel(self.solver, sys, self.use_kernel)
        self.solver._check_precision(self.precision, use_kernel)
        prm = self.solver.resolve_params(sys, **{**self.params, **params})
        fp = self.store.key(self.solver, sys, precision=self.precision,
                            **prm)
        key = executor.executor_key(
            self.solver, sys, prm,
            dataclasses.replace(self.plan, kernel=use_kernel),
            self.batch, self.iters)
        self._systems[fp] = _System(
            sys=sys, prm=prm, dtype=_numpy_dtype(sys.A_blocks.dtype),
            executor_key=key, use_kernel=use_kernel)
        self._queues.setdefault(fp, deque())
        return fp

    def _validated(self, fp: str, rhs) -> Tuple[_System, np.ndarray]:
        """Shared admission validation: the fingerprint must have been
        ``register()``-ed and the RHS must match the system's shape.  The
        KeyError names the FULL fingerprint."""
        ent = self._systems.get(fp)
        if ent is None:
            raise KeyError(f"unknown system fingerprint {fp!r}; "
                           "register() the system first")
        if isinstance(rhs, torch.Tensor):
            rhs = rhs.detach().cpu().numpy()
        rhs = np.asarray(rhs, dtype=ent.dtype)
        if rhs.shape != (ent.sys.N,):
            raise ValueError(f"rhs has shape {rhs.shape}, need "
                             f"({ent.sys.N},) for this system")
        return ent, rhs

    def submit(self, fp: str, rhs) -> int:
        """Enqueue one right-hand side for a registered system."""
        _, rhs = self._validated(fp, rhs)
        rid = self._rid
        self._rid += 1
        self._queues[fp].append(Request(rid=rid, fp=fp, rhs=rhs))
        return rid

    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    # ----- executors (compile-once cache) -----------------------------------
    def _executor(self, ent: _System):
        key = ent.executor_key
        ex = self._executors.get(key)
        if ex is None:
            self.stats.executor_builds += 1
            ex = executor.LocalExecutor(
                self.solver, ent.prm, self.iters, use_kernel=ent.use_kernel,
                ls_mode=ent.sys.mode == "least_squares")
            self._executors[key] = ex
        return ex

    def jit_cache_size(self) -> int:
        """Programs held across executors (the reference's jit-cache
        entries).  Constant across batches == zero rebuilds.  (Snapshots
        the executor dict: the async pipeline's assembly thread may add
        executors meanwhile.)"""
        return sum(ex.cache_size() for ex in list(self._executors.values()))

    def _release_evicted(self) -> None:
        """Drop the placement of every system whose store entry the memory
        tier no longer holds (an LRU eviction, a replaced entry), and the
        executor's programs that read it: an evicted entry must not live
        on, on the card, in a placement or a graph.  (Snapshots the
        systems: ``register`` may add one meanwhile.)"""
        for fp, ent in list(self._systems.items()):
            if ent.placed_src is None or self.store.holds(fp,
                                                          ent.placed_src):
                continue
            ex = self._executors.get(ent.executor_key)
            if ex is not None:
                ex.drop(ent.A_placed, ent.factors_placed)
            ent.A_placed = ent.factors_placed = ent.placed_src = None

    def _assemble(self, fp: str, group, n_real: int) -> _Batch:
        """Everything a batch needs before it runs, for ``step`` and the
        async server's assembly thread alike: the factors through the
        store (with the server's ``precision``, on the process's own
        linalg library whatever another thread captures meanwhile), the
        release of evicted placements, the executor, this system's
        placement, the warm-start decision and the batch's copy to the
        device (on the calling thread)."""
        ent = self._systems[fp]
        with executor.default_linalg():
            factors = self.store.factors(self.solver, ent.sys, key=fp,
                                         use_kernel=ent.use_kernel,
                                         precision=self.precision,
                                         **ent.prm)
        self._release_evicted()
        ex = self._executor(ent)
        if ent.placed_src is None:
            ent.A_placed, ent.factors_placed = ex.place_system(ent.sys,
                                                               factors)
            ent.placed_src = factors
        Bb = np.stack([r.rhs for r in group]).reshape(
            len(group), ent.sys.m, ent.sys.p)
        return _Batch(fp=fp, ent=ent, ex=ex, group=list(group),
                      n_real=n_real, A=ent.A_placed,
                      factors=ent.factors_placed, src=factors, Bb=Bb,
                      Bb_dev=ex.place_B(Bb, ent.A_placed),
                      warm=self._warm_ok(ent, Bb))

    def _results(self, fp, group, n_real, X, res, warm):
        X = X.cpu().numpy()
        res = res.cpu().numpy()
        to_tol = np.atleast_1d(iters_to_tolerance(res, self.tol))
        return [Served(rid=r.rid, fp=fp, x=X[i],
                       residual=float(res[i, -1]),
                       iters_to_tol=int(to_tol[i]), warm=warm)
                for i, r in enumerate(group[:n_real])]

    # ----- serving ----------------------------------------------------------
    def _warm_ok(self, ent: _System, Bb: np.ndarray) -> bool:
        if not self.warm_start or ent.last_states is None \
                or ent.last_Bb is None:
            return False
        if np.array_equal(ent.last_Bb, Bb):
            return True                       # repeated RHS: plain resume
        return bool(getattr(self.solver, "warm_rhs_ok", False))

    def step(self):
        """Serve ONE coalesced batch (the oldest pending request's system).

        Returns the ``Served`` results of the REAL requests in the batch.
        With ZERO pending requests this is a true no-op: it returns []
        before any executor, store or device work.
        """
        pending = [(q[0].rid, fp) for fp, q in self._queues.items() if q]
        if not pending:
            return []
        fp = min(pending)[1]
        group, n_real = take_group(self._queues[fp], self.batch)
        b = self._assemble(fp, group, n_real)
        states, X, res = b.ex.run(b.A, b.factors, b.Bb_dev,
                                  b.ent.last_states if b.warm else None)
        b.ent.last_states, b.ent.last_Bb = states, b.Bb

        self.stats.batches += 1
        self.stats.served += n_real
        self.stats.padded += len(group) - n_real
        self.stats.warm_batches += int(b.warm)
        return self._results(fp, group, n_real, X, res, b.warm)

    def drain(self):
        """Serve until every queue is empty; results in served order."""
        out = []
        while True:
            batch = self.step()
            if not batch:
                return out
            out.extend(batch)


class StreamReport(NamedTuple):
    """Outcome of a ``solve_stream`` run."""
    served: list        # Served results, completion order
    batches: int        # coalesced batches executed for this stream
    warm_batches: int   # batches that started from a prior state
    warm_hit_rate: float  # warm_batches / batches (0.0 on an empty stream)


def solve_stream(server, stream, *, drain_every: int = 1) -> StreamReport:
    """Drive a server through an ordered stream of ``(fp, rhs)`` requests,
    served every ``drain_every`` submissions; the report separates warm
    from cold batches (what ``Solver.warm_rhs_ok`` gating moves).  Works
    with the sync ``LinsysServer`` and the pipelined ``AsyncLinsysServer``
    (whose shed requests come back as ``Shed``)."""
    if drain_every < 1:
        raise ValueError(f"drain_every must be >= 1, got {drain_every}")
    b0, w0 = server.stats.batches, server.stats.warm_batches
    served = []
    for i, (fp, rhs) in enumerate(stream):
        server.submit(fp, rhs)
        if (i + 1) % drain_every == 0:
            served.extend(server.drain())
    served.extend(server.drain())
    batches = server.stats.batches - b0
    warm = server.stats.warm_batches - w0
    return StreamReport(served=served, batches=batches, warm_batches=warm,
                        warm_hit_rate=warm / batches if batches else 0.0)
