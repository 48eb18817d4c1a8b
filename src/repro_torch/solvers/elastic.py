"""Elastic runtime: membership-aware driving of the solve lifecycle
(counterpart of ``repro.solvers.elastic``).

``ElasticRuntime`` wraps one solver and one global system and keeps a
solve making progress while the worker fleet CHANGES under it: it solves
in short warm-started segments, polls the ``HeartbeatMonitor``'s
membership events between segments, and reacts:

  * **permanent death** (``mark_dead`` / a ``sweep`` timeout) — the row
    partition is KEPT and the redundant selection schedule re-lowered over
    the survivors (``RedundantEngine.lower``); replicas of the dead
    worker's blocks answer for it, so the iterate continues from the live
    global-shape state, bit-exactly (``solvers/redundant.py``).  If the
    survivors cannot cover every block (>= r cyclically adjacent holders
    lost) the runtime raises a ``RuntimeError``.

  * **a join or rejoin that grows the fleet** — the global system is
    repartitioned over the alive workers (``pad_to_blocks`` +
    ``partition``), the current global iterate is LIFTED into the new
    layout (``Solver.lift_state``), and per-block factorizations come
    through the ``FactorStore`` block tier wherever a block's fingerprint
    is unchanged: ``reused_blocks`` / ``prepared_blocks`` count reuse
    against refactorization.  A returnee to the CURRENT fleet size is a
    reassignment alone: state and engine untouched.

  * **taskmaster loss** — ``checkpoint()`` persists the global iterate
    after every segment (atomic, versioned: checkpoint/ckpt.py);
    ``ElasticRuntime.recover`` rebuilds a runtime in a fresh process from
    the store's DISK tier (its factors come back as block hits, counted as
    reuse) and the checkpointed iterate.

One ``RedundantEngine`` is kept per fleet size, and every segment
re-enters its step program with a freshly lowered schedule of the same
shape: a membership change costs a host-side lowering (a death) or one
engine build (the first visit to a fleet size), never a recapture.
``engine_cache_sizes()`` exposes the engines' programs.

On ``backend="mesh"`` with several ranks, each rank runs the runtime
with the same arguments; the membership (the monitor's events, its dead
set and size) is read on rank 0 alone and broadcast at every poll, and so
is each segment's lowered schedule: a monitor read on each rank would
disagree and hang the group.  Rank 0 alone writes the checkpoints.

    from repro_torch import solvers
    from repro_torch.runtime.fault import HeartbeatMonitor
    rt = solvers.ElasticRuntime(
        solvers.get("apc"), sys,
        plan=solvers.ExecutionPlan(redundancy=2),
        monitor=HeartbeatMonitor(n_workers=sys.m))
    rt.monitor.mark_dead(2)          # death -> re-lower, keep iterating
    rep = rt.run(iters=600)          # rep.reused_blocks / rep.events
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import ckpt
from repro_torch.core import partition as partition_lib
from repro_torch.core.partition import BlockSystem
from repro_torch.runtime.fault import (HeartbeatMonitor, MembershipEvent,
                                       covering_ok)

from .api import SolveResult, iters_to_tolerance
from .capability import CapabilityError, ExecutionPlan, resolve_plan
from .redundant import RedundantEngine
from .store import FactorStore

__all__ = ["ElasticReport", "ElasticRuntime"]


@dataclasses.dataclass(frozen=True)
class ElasticReport:
    """What one ``ElasticRuntime.run`` did and produced.

    ``result`` is the ordinary ``SolveResult`` (final x, plain global-shape
    state, the residual/error history of THIS call); beside it the
    membership events absorbed, factor reuse against refactorization, and
    how often the runtime re-lowered (deaths) or repartitioned (growth).
    ``iters`` is CUMULATIVE across runs and recoveries.
    """
    result: SolveResult
    events: Tuple[MembershipEvent, ...]
    iters: int
    segments: int
    reused_blocks: int
    prepared_blocks: int
    repartitions: int
    relowerings: int
    fleet: Tuple[int, ...]          # holder worker ids after the run

    @property
    def x(self):
        return self.result.x

    @property
    def residuals(self):
        return self.result.residuals

    @property
    def errors(self):
        return self.result.errors

    @property
    def state(self):
        return self.result.state

    @property
    def iters_to_tol(self):
        return self.result.iters_to_tol


@dataclasses.dataclass
class _Partition:
    """One fleet size's world: system, params, factors, engine."""
    sys: BlockSystem
    prm: Dict[str, Any]
    factors: Any
    engine: RedundantEngine


def _spmd(plan: ExecutionPlan) -> bool:
    """A mesh of several ranks: membership and checkpoints go through
    rank 0."""
    return (plan.backend == "mesh" and dist.is_initialized()
            and dist.get_world_size() > 1)


class ElasticRuntime:
    """Drive a solve across fleet membership changes (module docstring).

    Parameters
    ----------
    solver:   a registry solver with the redundancy hooks (projection
              family).
    sys:      the ``BlockSystem``; its initial ``m`` must equal the
              monitor's ``n_workers``.
    plan:     an ``ExecutionPlan``: ``redundancy`` sets the death budget,
              ``store`` supplies (or a fresh in-memory ``FactorStore``
              replaces) the per-block factor cache, ``backend``/``mesh``
              pick the local or the mesh backend, ``warm_state`` seeds the
              first segment.  ``kernel=True`` and ``alive_schedule=`` are
              refused: the replicated layout has no kernel, and the masks
              come from the monitor.
    monitor:  the ``HeartbeatMonitor`` polled between segments.  The
              runtime beats for the alive workers itself, so membership
              is the explicit death/rejoin/join transitions.
    segment:  iterations a segment: the reaction latency to a membership
              event.
    checkpoint_dir: when set, ``checkpoint()`` runs after every segment.
    """

    def __init__(self, solver, sys: BlockSystem, *,
                 plan: Optional[ExecutionPlan] = None,
                 monitor: Optional[HeartbeatMonitor] = None,
                 segment: int = 25, tol: float = 1e-6,
                 checkpoint_dir: Optional[str] = None, **params):
        if plan is None:
            plan = ExecutionPlan()
        if not isinstance(plan, ExecutionPlan):
            raise TypeError(f"plan must be an ExecutionPlan, got "
                            f"{type(plan).__name__}")
        if plan.alive_schedule is not None:
            raise ValueError(
                "ExecutionPlan.alive_schedule is for fixed-schedule "
                "solve(); the elastic runtime derives alive masks from "
                "its HeartbeatMonitor")
        plan = resolve_plan(solver, sys, plan, context="elastic")
        if plan.kernel:
            raise CapabilityError(
                f"solver {solver.name!r} cannot run the elastic runtime "
                f"with kernel=True: the replicated (m, r, p, n) layout "
                f"has no CUDA kernel (the same limit as redundancy= with "
                f"kernel=True); drop kernel=True")
        self.solver, self.plan = solver, plan
        self.tol = float(tol)
        self.segment = int(segment)
        if self.segment < 1:
            raise ValueError(f"segment must be >= 1, got {segment}")
        self.checkpoint_dir = checkpoint_dir
        self.params = dict(params)
        self.monitor = (HeartbeatMonitor(n_workers=sys.m)
                        if monitor is None else monitor)
        if self.monitor.n_workers != sys.m:
            raise ValueError(
                f"HeartbeatMonitor tracks {self.monitor.n_workers} workers "
                f"but the system has m={sys.m} blocks — build the monitor "
                f"for the initial fleet")
        self.store = plan.store if plan.store is not None else FactorStore()
        self.base_sys = sys
        self._A_global, self._b_global = sys.dense()
        self._x_true = sys.x_true
        self._dtype = sys.A_blocks.dtype

        self._parts: Dict[int, _Partition] = {}
        self.reused_blocks = 0
        self.prepared_blocks = 0
        self.repartitions = 0
        self.relowerings = 0
        self.segments = 0
        self.events: List[MembershipEvent] = []
        self._iters_done = 0
        self._state = None              # replicated state of the engine
        self._warm_x = None             # a recovered global iterate
        self._holders = np.arange(sys.m)
        self._dead = frozenset()        # the membership of the last poll
        self._n_workers = sys.m
        self._current = self._partition_for(sys.m)
        self._beat_alive()

    # ------------------------------------------------------------------
    # partitions & engines
    # ------------------------------------------------------------------
    @property
    def sys(self) -> BlockSystem:
        """The CURRENT partition's system (m tracks the fleet size)."""
        return self._current.sys

    @property
    def engine(self) -> RedundantEngine:
        return self._current.engine

    def engine_cache_sizes(self) -> Dict[int, int]:
        """Step programs per fleet size: flat across steady segments."""
        return {m: part.engine.cache_size()
                for m, part in sorted(self._parts.items())}

    def _partition_for(self, m_new: int) -> _Partition:
        """The world for fleet size ``m_new`` (built once)."""
        part = self._parts.get(m_new)
        if part is not None:
            return part
        if m_new == self.base_sys.m:
            sys2 = self.base_sys
        else:
            A2, b2 = partition_lib.pad_to_blocks(
                self._A_global, self._b_global, m_new)
            sys2 = partition_lib.partition(
                A2, b2, m_new, x_true=self._x_true, mode=self.base_sys.mode)
        prm2 = self.solver.resolve_params(sys2, **self.params)
        if (getattr(self.solver, "supports_block_store", False)
                and not sys2.is_sparse):
            factors2, reuse = self.store.blockwise_factors(
                self.solver, sys2, precision=self.plan.precision,
                **self.params)
            self.reused_blocks += reuse.reused
            self.prepared_blocks += reuse.prepared
        else:
            # a solver without per-block independence has no block tier
            # (the reference's elastic.py is an allow-listed owner too)
            factors2 = self.solver.prepare(  # repro: allow[R003]
                sys2.A_blocks, prm2)
            self.prepared_blocks += sys2.m
        engine = RedundantEngine(
            self.solver, sys2, r=min(self.plan.redundancy, m_new),
            backend=self.plan.backend, mesh=self.plan.mesh,
            worker_axes=self.plan.worker_axes,
            model_axis=self.plan.model_axis, factors=factors2,
            **self.params)
        part = _Partition(sys=sys2, prm=prm2, factors=factors2,
                          engine=engine)
        self._parts[m_new] = part
        return part

    # ------------------------------------------------------------------
    # membership
    # ------------------------------------------------------------------
    def _poll(self) -> List[MembershipEvent]:
        """Drain the monitor's events and take its membership: on a mesh
        of several ranks, rank 0's, broadcast."""
        box = [None]
        if not _spmd(self.plan) or dist.get_rank() == 0:
            box[0] = (self.monitor.poll_events(), self.monitor.dead,
                      self.monitor.n_workers)
        if _spmd(self.plan):
            dist.broadcast_object_list(box, src=0)
        events, self._dead, self._n_workers = box[0]
        return list(events)

    def _alive_holder_mask(self) -> np.ndarray:
        """(m,) bool: is the holder of block-slot i alive right now?"""
        return np.array([w not in self._dead for w in self._holders],
                        dtype=bool)

    def _beat_alive(self):
        dead = self.monitor.dead
        for w in range(self.monitor.n_workers):
            if w not in dead:
                self.monitor.beat(w)

    def _require_covered(self, alive: np.ndarray):
        r = self.engine.r
        if not covering_ok(alive, r):
            lost = [int(w) for w, a in zip(self._holders, alive) if not a]
            raise RuntimeError(
                f"elastic fleet uncoverable: dead workers {lost} include "
                f">= r={r} cyclically-adjacent holders over m={self.sys.m} "
                f"blocks — no survivor holds a replica of every block.  "
                f"Add workers (monitor.join / rejoin) or recover from the "
                f"last checkpoint onto a fresh fleet")

    def _absorb_events(self):
        """Poll the membership and react (module docstring)."""
        events = self._poll()
        if not events:
            return
        self.events.extend(events)
        deaths = [e for e in events if e.kind == "died"]
        growth = [e for e in events if e.kind in ("joined", "rejoined")]
        if growth:
            self._repartition()
        if deaths:
            # the partition is kept; the NEXT segment lowers the schedule
            # over the survivors — fail loudly now if they cannot cover
            self._require_covered(self._alive_holder_mask())
            self.relowerings += 1

    def _repartition(self):
        holders = np.array([w for w in range(self._n_workers)
                            if w not in self._dead], dtype=int)
        if holders.size == 0:
            raise RuntimeError("elastic fleet has no alive workers left")
        m_new = int(holders.size)
        if m_new == self.sys.m:
            # same fleet size: a returnee slots into the layout (replicas
            # resynced by the join/rejoin handshake); state and engine
            # are untouched
            self._holders = holders
            return
        x = self._global_x()
        part = self._partition_for(m_new)
        self._current = part
        self._holders = holders
        lifted = self.solver.lift_state(part.factors, part.sys.b_blocks,
                                        part.prm, x)
        self._state = part.engine.init_state(lifted)
        self.repartitions += 1

    # ------------------------------------------------------------------
    # state plumbing
    # ------------------------------------------------------------------
    def _global_x(self) -> torch.Tensor:
        """The current global iterate (n,), whatever the partition."""
        if self._state is not None:
            return self.solver.extract(self.engine.collapse(self._state))
        if self._warm_x is not None:
            return self._warm_x
        if self.plan.warm_state is not None:
            return self.solver.extract(self.plan.warm_state)
        return self._b_global.new_zeros((self.sys.n,))

    def _initial_state(self):
        part = self._current
        if self._warm_x is not None:        # taskmaster recovery
            lifted = self.solver.lift_state(
                part.factors, part.sys.b_blocks, part.prm, self._warm_x)
            self._warm_x = None
            return part.engine.init_state(lifted)
        return part.engine.init_state(self.plan.warm_state)

    # ------------------------------------------------------------------
    # the loop
    # ------------------------------------------------------------------
    def run(self, iters: int = 1000, *, tol: Optional[float] = None
            ) -> ElasticReport:
        """Run ``iters`` more iterations, absorbing membership events at
        segment boundaries; call again to keep going (state, counters and
        engines persist)."""
        tol = self.tol if tol is None else float(tol)
        remaining = int(iters)
        events_before = len(self.events)
        segments_before = self.segments
        self._absorb_events()
        if self._state is None:
            self._state = self._initial_state()
        res_parts, err_parts = [], []
        while remaining > 0:
            self._absorb_events()
            T = min(self.segment, remaining)
            alive = self._alive_holder_mask()
            self._require_covered(alive)
            W_seq = self.engine.lower(
                np.broadcast_to(alive, (T, self.sys.m)))
            self._state, res, err = self.engine.run(self._state, W_seq)
            res_parts.append(res)
            err_parts.append(err)
            remaining -= T
            self._iters_done += T
            self.segments += 1
            self._beat_alive()
            if self.checkpoint_dir is not None:
                self.checkpoint()
        empty = self._b_global.new_zeros((0,))
        residuals = torch.cat(res_parts) if res_parts else empty
        errors = torch.cat(err_parts) if err_parts else empty
        state = self.engine.collapse(self._state)
        result = SolveResult(
            name=self.solver.name, x=self.solver.extract(state),
            state=state, residuals=residuals,
            errors=errors if self._x_true is not None else None,
            params=self._current.prm,
            iters_to_tol=iters_to_tolerance(residuals, tol), tol=tol)
        return ElasticReport(
            result=result, events=tuple(self.events[events_before:]),
            iters=self._iters_done,
            segments=self.segments - segments_before,
            reused_blocks=self.reused_blocks,
            prepared_blocks=self.prepared_blocks,
            repartitions=self.repartitions,
            relowerings=self.relowerings,
            fleet=tuple(int(w) for w in self._holders))

    # ------------------------------------------------------------------
    # taskmaster loss
    # ------------------------------------------------------------------
    def checkpoint(self, directory: Optional[str] = None) -> str:
        """Atomically persist the global iterate and the iteration count
        (on a mesh of several ranks, rank 0 writes).  With the store's
        disk tier this is all a replacement taskmaster needs."""
        d = directory or self.checkpoint_dir
        if d is None:
            raise ValueError(
                "no checkpoint directory: pass checkpoint_dir= at "
                "construction or directory= here")
        tree = {"iters": torch.tensor(self._iters_done, dtype=torch.int32),
                "x": self._global_x().to(self._dtype)}
        if _spmd(self.plan) and dist.get_rank() != 0:
            return d
        return ckpt.save(d, self._iters_done, tree)

    @classmethod
    def recover(cls, solver, sys: BlockSystem, directory: str, *,
                plan: Optional[ExecutionPlan] = None,
                monitor: Optional[HeartbeatMonitor] = None,
                segment: int = 25, tol: float = 1e-6,
                **params) -> "ElasticRuntime":
        """Rebuild a runtime after taskmaster loss: a FRESH process
        constructs it (factors through the store's disk tier — point
        ``plan.store`` at the same ``FactorStore`` directory and they
        count as ``reused_blocks``), then restores the checkpointed
        iterate, which the first segment lifts into the current fleet's
        partition."""
        rt = cls(solver, sys, plan=plan, monitor=monitor, segment=segment,
                 tol=tol, checkpoint_dir=directory, **params)
        like = {"iters": torch.zeros((), dtype=torch.int32),
                "x": sys.b_blocks.new_zeros((sys.n,), dtype=rt._dtype)}
        tree = ckpt.restore(directory, like)
        rt._warm_x = torch.as_tensor(tree["x"]).to(sys.device)
        rt._iters_done = int(tree["iters"])
        return rt
