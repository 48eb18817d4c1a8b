"""Redundant, straggler-tolerant execution of the projection family
(counterpart of ``repro.solvers.redundant``).

The paper's synchronous taskmaster waits for all m machines every
iteration: one straggler stalls the fleet.  This backend runs the same
prepare/init/step lifecycle through an r-redundant cyclic block
assignment in the style of gradient coding: worker i holds blocks
{i, i+1, ..., i+r-1 mod m}, so an iteration completes from any workers
whose blocks cover {0..m-1}; with r-redundancy, ANY m - r + 1 suffice.

    from repro_torch import solvers
    res = solvers.get("apc").solve(sys, plan=solvers.ExecutionPlan(
        redundancy=2, alive_schedule=lambda t: mask_t))

``alive_schedule`` may be a callable ``t -> (m,) bool mask``, a static
``(m,)`` or per-iteration ``(iters, m)`` mask array, or a
``runtime.fault.HeartbeatMonitor``.  The whole schedule is lowered to
selection weights ONCE, before the first step; a monitor is therefore a
snapshot taken at launch (drive a long-lived deployment in warm-started
segments to re-sample it, as ``solvers.elastic`` does).

The master's Eq. (2b) average needs each block's x_j exactly once.  Given
the alive mask a ∈ {0,1}^m, each block j is taken from its lowest-index
alive holder, expressed as a weight matrix W(a) ∈ {0,1}^{m x r}, so the
masked block-unique mean stays one reduction: locally an einsum, on
``backend="mesh"`` the same ``all_reduce`` over the worker axes that the
mesh's plain master update uses.

The semantics are EXACT: an iteration under any covering mask computes
the x̄(t+1) of a plain iteration over all m blocks, since each block's
update depends on (x_j(t), x̄(t)) alone and every replica of block j holds
the same x_j(t).  Exactness also keeps states GLOBAL-shaped: the
replicated internal state is a gather of the plain one, so warm starts and
checkpoints cross redundant and plain runs, and local and mesh backends.

Compile-once, in the port's idiom (:class:`RedundantEngine`): on the card
one step is captured into a CUDA graph per engine (``executor
.StepProgram``; on a mesh, where every group is NCCL), reading its
selection weights from a static (m, r) buffer; a segment copies each
iteration's weights in and replays.  A membership change that keeps the
partition (a death) therefore costs a host-side lowering and copies,
never a recapture.  Every step of a run is such a program run (the
graph's warm-up step runs on a throwaway copy of the state), so a
history split into segments anywhere is bit-equal to the history run in
one.  On the CPU (and on a gloo mesh) the same step runs eagerly through
the same buffers.  The replicated layout has no kernel (the reference refuses ``use_kernel`` with
redundancy): the steps are torch library ops, as the reference's are XLA
ops; their Cholesky solves are triangular solves, which a graph captures
(``projection._cho_solve_replicas``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.partition import BlockSystem
from repro_torch.runtime.fault import HeartbeatMonitor

from . import executor
from .api import LOCAL_PSUM, SolveResult, iters_to_tolerance

__all__ = ["Assignment", "RedundantEngine", "monitor_schedule",
           "replicate_system", "resolve_schedule", "schedule_weights",
           "selection_weights", "solve_redundant"]


@dataclasses.dataclass(frozen=True)
class Assignment:
    """Cyclic r-redundant block assignment over m workers."""
    m: int
    r: int

    @property
    def holder(self) -> np.ndarray:
        """(m, r) block id held in slot k of worker i: (i + k) mod m."""
        return (np.arange(self.m)[:, None] + np.arange(self.r)[None, :]) \
            % self.m


#: the identity psum context of the local backend (the reference's
#: ``_LocalContext``): every ``red_*`` hook is written once against the
#: psum contract and runs on both backends
_LOCAL = LOCAL_PSUM


def schedule_weights(alive: np.ndarray, r: int) -> np.ndarray:
    """Lower a (T, m) alive schedule to (T, m, r) selection weights.

    W[t, i, k] = 1 iff worker i is the designated provider of the block in
    its slot k at iteration t: the lowest-index alive holder (ties broken
    by slot), so each block contributes exactly once to the masked mean.
    Vectorized over T, on the host, before the first step.

    Raises if some block has no alive holder (the fleet lost >= r
    cyclically adjacent workers).
    """
    alive = np.atleast_2d(np.asarray(alive, dtype=bool))
    T, m = alive.shape
    ks = np.arange(r)
    # block j's slot-k holder is worker (j - k) mod m
    holders = (np.arange(m)[:, None] - ks[None, :]) % m          # (m, r)
    ok = alive[:, holders]                                       # (T, m, r)
    # lexicographic (worker, slot) preference key; m*r when dead
    key = np.where(ok, holders * r + ks[None, :], m * r)
    sel = key.argmin(axis=-1)                                    # (T, m)
    covered = np.take_along_axis(ok, sel[..., None], axis=-1)[..., 0]
    if not covered.all():
        t, blk = np.argwhere(~covered)[0]
        raise RuntimeError(
            f"block {blk} unrecoverable at iteration {t}: no alive holder "
            f"(r={r}; lost >= {r} cyclically-adjacent workers)")
    i_sel = (np.arange(m)[None, :] - sel) % m                    # (T, m)
    W = np.zeros((T, m, r))
    W[np.repeat(np.arange(T), m), i_sel.ravel(), sel.ravel()] = 1.0
    return W


def selection_weights(alive: np.ndarray, m: int, r: int) -> np.ndarray:
    """Single-mask form of :func:`schedule_weights` (W ∈ {0,1}^{m x r})."""
    alive = np.asarray(alive, dtype=bool).reshape(1, m)
    return schedule_weights(alive, r)[0]


def monitor_schedule(monitor) -> Any:
    """A ``HeartbeatMonitor`` as an alive schedule excluding its
    ``drop_set()`` (dead OR straggling workers): a snapshot taken when
    the schedule is lowered."""
    return lambda t: ~monitor.drop_set()


def resolve_schedule(alive_schedule, m: int, iters: int) -> np.ndarray:
    """Any accepted alive-schedule form as an (iters, m) bool array."""
    if alive_schedule is None:
        return np.ones((iters, m), dtype=bool)
    if isinstance(alive_schedule, HeartbeatMonitor):
        if alive_schedule.n_workers != m:
            raise ValueError(
                f"HeartbeatMonitor tracks {alive_schedule.n_workers} "
                f"workers but the system has m={m} blocks")
        alive_schedule = monitor_schedule(alive_schedule)
    if callable(alive_schedule):
        masks = [np.asarray(alive_schedule(t), dtype=bool)
                 for t in range(iters)]
        alive = np.stack(masks) if masks else np.ones((0, m), bool)
    else:
        alive = np.asarray(alive_schedule, dtype=bool)
        if alive.ndim == 1:
            alive = np.broadcast_to(alive, (iters, m)).copy()
    if alive.shape != (iters, m):
        raise ValueError(f"alive schedule has shape {alive.shape}, "
                         f"need ({iters}, {m})")
    return alive


def _holder_index(assign: Assignment, device) -> torch.Tensor:
    return torch.as_tensor(assign.holder, device=device)


def replicate_system(sys: BlockSystem, assign: Assignment):
    """(A_rep, b_rep): A_rep[i, k] = A_blocks[(i + k) % m], likewise b."""
    idx = _holder_index(assign, sys.device)
    return sys.A_blocks[idx], sys.b_blocks[idx]


def _check_solver(solver, sys: BlockSystem, r: int):
    if not getattr(solver, "supports_redundancy", False):
        raise ValueError(
            f"solver {solver.name!r} does not support redundant execution "
            "(projection family only: the coded masked mean needs the "
            "block-local update structure of apc/consensus/cimmino)")
    if sys.is_sparse or sys.mode != "square":
        raise ValueError(
            f"redundant execution is dense-square only: got a "
            f"mode={sys.mode!r}, structure={sys.structure!r} system — the "
            f"replicated (m, r, p, n) factor layout has no sparse variant "
            f"and the straggler theory assumes a consistent system; "
            f"densify()/drop redundancy=r to proceed")
    if not (1 <= r <= sys.m):
        raise ValueError(f"redundancy r={r} must be in [1, m={sys.m}]")


def _lowered(alive_fn, r: int, backend: str) -> np.ndarray:
    """``schedule_weights(alive_fn(), r)``.  On a mesh of several ranks
    the schedule is resolved and lowered on rank 0 alone and broadcast
    (a monitor read on each rank would disagree): an unrecoverable
    schedule then raises on every rank at once, the broadcast being the
    only collective before it."""
    import torch.distributed as dist
    if backend != "mesh" or not dist.is_initialized() \
            or dist.get_world_size() == 1:
        return schedule_weights(alive_fn(), r)
    box = [None]
    if dist.get_rank() == 0:
        try:
            box[0] = ("ok", schedule_weights(alive_fn(), r))
        except (RuntimeError, ValueError) as e:
            box[0] = (type(e).__name__, str(e))
    dist.broadcast_object_list(box, src=0)
    kind, payload = box[0]
    if kind != "ok":
        raise {"RuntimeError": RuntimeError,
               "ValueError": ValueError}[kind](payload)
    return payload


class RedundantEngine:
    """Compile-once, re-enterable segment runner of redundant execution.

    An engine binds the FIXED part of a redundant solve — solver,
    partition, r, resolved params, backend, mesh placement, replicated
    factors — and builds its step program ONCE (module docstring).
    Segments then re-enter it with a new ``(state, W_seq)`` pair: a
    membership change that keeps the partition costs a host-side
    re-lowering (:meth:`lower`) and no recapture.  That is the death path
    of ``solvers.elastic.ElasticRuntime``, which keeps one engine per fleet
    size.  ``solve_redundant`` is one engine and one segment.

    ``captures`` counts the CUDA graphs captured (one an engine, on the
    card or a mesh of NCCL groups); :meth:`cache_size` the step programs
    held (the reference's jit-cache entries), flat across segments.
    """

    def __init__(self, solver, sys: BlockSystem, *, r: int,
                 backend: str = "local", mesh: Any = None,
                 worker_axes: Sequence[str] = ("data",),
                 model_axis: Optional[str] = "model",
                 factors: Any = None, **params):
        _check_solver(solver, sys, r)
        self.solver, self.sys = solver, sys
        self.r = int(r)
        self.assign = Assignment(m=sys.m, r=self.r)
        self.backend = backend
        self.prm = solver.resolve_params(sys, **params)
        self.dtype = sys.A_blocks.dtype
        self.W_all = torch.as_tensor(
            selection_weights(np.ones(sys.m, bool), sys.m, self.r),
            dtype=self.dtype, device=sys.device)
        if backend == "mesh":
            from . import mesh as mesh_backend
            self._mesh_runner = mesh_backend.RedundantRunner(
                solver, sys, self.assign, self.prm, mesh=mesh,
                worker_axes=worker_axes, model_axis=model_axis,
                factors=factors)
            return
        self._mesh_runner = None
        if factors is None:
            # redundant placement (the reference's redundant.py is an
            # allow-listed owner, as mesh.py is); solve_redundant hands
            # the store's factors in when it has a store
            factors = solver.prepare(  # repro: allow[R003]
                sys.A_blocks, self.prm)
        # the kernel path's pinv factors are not replicated
        self._frep = solver.red_factors(solver.mesh_factors(factors),
                                        self.assign)
        self._b_rep = sys.b_blocks[_holder_index(self.assign, sys.device)]
        # the selection weights the step reads: one static buffer (the
        # step closes over the tensors, not the engine: a graph is never
        # in a reference cycle)
        W = self.W_all.clone()
        prm, b_rep = self.prm, self._b_rep
        self._program = executor.StepProgram(executor.History(
            lambda f, b, s: solver.red_step(f, b_rep, s, prm, W, _LOCAL),
            solver.extract, self._frep, sys.b_blocks, sys.A_blocks,
            x_true=sys.x_true), W, name=f"{solver.name}.redundant")

    @property
    def captures(self) -> int:
        """The CUDA graphs of the engine's step program (0 or 1)."""
        if self._mesh_runner is not None:
            return self._mesh_runner.captures
        return self._program.captures

    def lower(self, alive) -> torch.Tensor:
        """(T, m) alive masks -> (T, m, r) selection weights on the
        engine's device.  Raises the loud ``unrecoverable``
        ``RuntimeError`` if a block has no alive holder; on a mesh of
        several ranks rank 0's masks are lowered (:func:`_lowered`)."""
        W = _lowered(lambda: np.asarray(alive, dtype=bool), self.r,
                     self.backend)
        return torch.as_tensor(W, dtype=self.dtype, device=self.sys.device)

    def init_state(self, warm_state: Any = None):
        """A fresh ``red_init``, or the replicated expansion of a
        GLOBAL-shape warm state (whatever backend and redundancy produced
        it).  Runs eagerly."""
        if self._mesh_runner is not None:
            return self._mesh_runner.init_state(warm_state, self.W_all)
        if warm_state is None:
            return self.solver.red_init(self._frep, self._b_rep, self.prm,
                                        self.W_all, _LOCAL)
        return self.solver.red_expand(warm_state, self.assign)

    def run(self, state, W_seq):
        """One segment: ``red_step`` over the T rows of ``W_seq`` from
        ``state``; returns ``(state, residuals (T,), errors (T,))`` (the
        errors are the residuals without ``x_true``).  On the card each
        step is a replay of the captured program; under
        ``executor.disable_capture()`` the same steps run eagerly."""
        if self._mesh_runner is not None:
            return self._mesh_runner.run(state, W_seq)
        return self._program.run(state, torch.as_tensor(
            W_seq, dtype=self.dtype, device=self.sys.device))

    def collapse(self, state):
        """Replicated -> plain GLOBAL-shape state."""
        return self.solver.red_collapse(state, self.assign)

    def cache_size(self) -> int:
        """The step programs the engine holds (one after its first run):
        flat across segments, which the elastic runtime's callers check."""
        if self._mesh_runner is not None:
            return self._mesh_runner.cache_size()
        return self._program.cache_size()


def solve_redundant(solver, sys: BlockSystem, *, r: int, iters: int = 1000,
                    tol: float = 1e-6, alive_schedule=None,
                    warm_state: Any = None, factors: Any = None,
                    store: Any = None, backend: str = "local",
                    mesh: Any = None,
                    worker_axes: Sequence[str] = ("data",),
                    model_axis: Optional[str] = "model",
                    **params) -> SolveResult:
    """The driver of ``solve(plan=ExecutionPlan(redundancy=r,
    alive_schedule=...))``.

    Checks the solver and the system, lowers the alive schedule to
    per-iteration selection weights once — before the factors (a
    ``store`` lookup or ``prepare``), any placement or any collective but
    the lowering's own broadcast (:func:`_lowered`), so an uncoverable
    schedule fails loudly without paying for them — then runs one
    :class:`RedundantEngine` segment over them.  The ``SolveResult``
    carries the plain GLOBAL-shape state.
    """
    _check_solver(solver, sys, r)
    W_host = _lowered(
        lambda: resolve_schedule(alive_schedule, sys.m, iters), r, backend)
    if factors is None and store is not None:
        params = solver.resolve_params(sys, **params)
        factors = store.factors(solver, sys, resume=warm_state is not None,
                                **params)
    engine = RedundantEngine(solver, sys, r=r, backend=backend, mesh=mesh,
                             worker_axes=worker_axes, model_axis=model_axis,
                             factors=factors, **params)
    state = engine.init_state(warm_state)
    state, res, err = engine.run(state, torch.as_tensor(
        W_host, dtype=engine.dtype, device=sys.device))
    state = engine.collapse(state)
    return SolveResult(
        name=solver.name, x=solver.extract(state), state=state,
        residuals=res, errors=err if sys.x_true is not None else None,
        params=engine.prm, iters_to_tol=iters_to_tolerance(res, tol),
        tol=tol)


def _red_mesh_prepare(solver, A_rep, prm, ctx):
    """On-mesh replicated ``prepare``: replicas are more worker blocks, so
    the (m_loc, r) axes flatten into m_loc·r for ``mesh_prepare`` and fold
    back into every factor leaf."""
    m_loc, r = A_rep.shape[:2]
    flat = solver.mesh_prepare(  # repro: allow[R003]
        A_rep.reshape((m_loc * r,) + tuple(A_rep.shape[2:])), prm, ctx)
    return type(flat)(*(None if f is None else
                        f.reshape((m_loc, r) + tuple(f.shape[1:]))
                        .contiguous() for f in flat))
