"""Compile-once execution of the solver histories: the step loop captured
into a CUDA graph on the card.

Counterpart of the reference's compiled histories: every solve of
``repro.solvers.api`` is one jitted ``lax.scan``, and its serving
executor (``repro.solvers.serve._LocalExecutor``) compiles once per key.
The port captures the step loop with ``torch.cuda.CUDAGraph``.  A graph
reads its operands by address from buffers that outlive it, and a replay
runs every kernel of the captured steps (the hand-written ones, launched
through ``ctypes``, and PyTorch's glue) without the host's launch work.

* :func:`run_history`, the history of ``Solver.solve``/``solve_many``:
  the first :data:`CHUNK` steps run eagerly (they are real iterations,
  and they make the first launch of every kernel instance, library handle
  and module outside the capture); one CHUNK-step graph is captured from
  the state they leave and replayed ⌊(T−C)/C⌋ times; the last
  (T−C) mod C steps run eagerly.  No graph outlives the call.
* :class:`LocalExecutor`, the reusable program of serving (ROADMAP A13):
  one graph for the whole cold (init + T steps) or warm (T steps from
  given states) program of a placed system and batch shape, captured at
  its first run and replayed for every later batch.

On the CPU (only where the caller put the tensors there) both run the
same bodies through the same static buffers and chunks, eagerly.  The
tensors' device decides, by ``ops.on_cuda``, the predicate of the kernel
ops.  A capture or a replay that fails raises: nothing retries eagerly.
:func:`disable_capture` (the twin of ``jax.disable_jit``) runs every
history as the plain eager loop, :func:`eager_history`, which is what
the captured histories are held to.

Every executor build and every graph capture is reported to
:mod:`repro_torch.analysis.tracecheck`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
from typing import Any, Optional

import torch

from repro_torch.analysis.tracecheck import record
from repro_torch.core import blockops
from repro_torch.kernels import block_projection as bp
from repro_torch.kernels import ops
from repro_torch.solvers.capability import resolve_plan

__all__ = ["CHUNK", "History", "LocalExecutor", "disable_capture",
           "eager_history", "executor_key", "run_history"]

#: the steps one captured graph of a one-shot solve holds
CHUNK = 16

_capture_disabled = False


@contextlib.contextmanager
def disable_capture():
    """Inside, every history runs as the eager loop (:func:`eager_history`)
    and no :class:`LocalExecutor` program is captured."""
    global _capture_disabled
    prev, _capture_disabled = _capture_disabled, True
    try:
        yield
    finally:
        _capture_disabled = prev


def _capturing(b: torch.Tensor) -> bool:
    return ops.on_cuda("history", b) and not _capture_disabled


@contextlib.contextmanager
def _cusolver():
    """cuSOLVER for ``torch.cholesky_solve`` (the unfused steps' Gram
    solves, ``core.apc._gram_solve``) while a history runs on the card:
    PyTorch's default sends a batch of solves to MAGMA, whose batched
    solve stages its pointer arrays in host memory, which a graph cannot
    capture."""
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


# ---------------------------------------------------------------------------
# One history's step and records
# ---------------------------------------------------------------------------


class History:
    """The body of one history: a step and what it records.

    ``b`` is the (m, p) right-hand side, or the (k, m, p) batch
    (``batched``); ``A`` the dense stack or a ``SparseBlocks`` operand.
    Record t is the residual ‖Ax−b‖/‖b‖ (and, with ``x_true``, the error
    ‖x−x*‖/‖x*‖) after step t+1; ``residual_fn(x)`` (least squares)
    replaces the plain residual.  ``step_residual(factors, b, state) ->
    (state, rsq)`` switches to the FUSED residual: each step harvests
    ‖Ax−b‖² of the state it consumed from its own gather pass, so its
    record is the residual before it; :meth:`close` shifts the records by
    one and ends them with ONE true-A residual of the final state — the
    same indexing as the plain path.
    """

    def __init__(self, step, extract, factors, b, A, *, x_true=None,
                 residual_fn=None, step_residual=None, batched=False):
        self.step, self.extract, self.factors = step, extract, factors
        self.b, self.A, self.batched = b, A, batched
        self.residual_fn, self.step_residual = residual_fn, step_residual
        self.x_true = x_true
        self.xt_norm = None if x_true is None else torch.linalg.norm(x_true)
        self.b_norm = (torch.sqrt(torch.sum(b * b, dim=(1, 2))) if batched
                       else torch.sqrt(torch.sum(b * b)))

    def true_res(self, state) -> torch.Tensor:
        if self.batched:
            r = blockops.bmatvec_many(self.A, self.extract(state)) - self.b
            return torch.sqrt(torch.sum(r * r, dim=(1, 2))) / self.b_norm
        r = blockops.bmatvec(self.A, self.extract(state)) - self.b
        return torch.sqrt(torch.sum(r * r)) / self.b_norm

    def one(self, state):
        """One step: (state, residual record, error record or None)."""
        if self.step_residual is not None:
            state, rsq = self.step_residual(self.factors, self.b, state)
            res = torch.sqrt(rsq) / self.b_norm
        else:
            state = self.step(self.factors, self.b, state)
            res = (self.true_res(state) if self.residual_fn is None
                   else self.residual_fn(self.extract(state)))
        err = None if self.x_true is None else (
            torch.linalg.norm(self.extract(state) - self.x_true)
            / self.xt_norm)
        return state, res, err

    def steps(self, state, n: int):
        """``n`` >= 1 steps: (state, residual records (n,) or (n, k),
        error records (n,) or None)."""
        res, err = [], []
        for _ in range(n):
            state, r, e = self.one(state)
            res.append(r)
            err.append(e)
        return (state, torch.stack(res),
                None if self.x_true is None else torch.stack(err))

    def close(self, state, res: Optional[torch.Tensor],
              err: Optional[torch.Tensor]):
        """(residuals, errors) of the whole history from its records
        (None for no step): the fused residual's shift, the batch axis
        first ((k, T), errors None), and without ``x_true`` the errors are
        the residuals, as the reference returns them."""
        if res is None:
            res = self.b.new_zeros((0,) + self.b_norm.shape)
            err = None if self.x_true is None else res
        elif self.step_residual is not None:
            res = torch.cat([res[1:], self.true_res(state)[None]])
        if self.batched:
            return res.T, None
        return res, res if err is None else err


def eager_history(h: History, state, iters: int):
    """The plain eager loop: (state, residuals, errors) after ``iters``
    steps of ``h`` from ``state``."""
    res = err = None
    if iters > 0:
        state, res, err = h.steps(state, iters)
    return (state, *h.close(state, res, err))


# ---------------------------------------------------------------------------
# Static buffers and captured programs
# ---------------------------------------------------------------------------


def _tensors(state) -> list:
    return [v for v in state if isinstance(v, torch.Tensor)]


def _with_tensors(state, tensors):
    """``state`` (a NamedTuple) with its tensor fields replaced, in
    order."""
    it = iter(tensors)
    return type(state)(*(next(it) if isinstance(v, torch.Tensor) else v
                         for v in state))


def _static(t: torch.Tensor) -> torch.Tensor:
    """A buffer holding ``t``'s values in ``t``'s own layout (strides
    included: a reduction over it then takes the same path, bit for bit)
    from the caching allocator, whose blocks keep the 16-byte alignment
    ``block_projection.gather_instance`` reads."""
    return torch.empty_like(t).copy_(t)


@contextlib.contextmanager
def _no_collection():
    """No cyclic garbage collection inside: a CUDA graph it destroyed
    there would invalidate the capture under way."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


_capture_streams: dict = {}


def _capture(body, name: str):
    """``body`` captured into a CUDA graph on the current device: (graph,
    the kernel launches it holds).  The launches counted while capturing
    ran nothing and are taken back out of the counts; the replays add
    them.

    The capture runs on a side stream of its own (a graph cannot be
    captured on the default stream) that first waits for the current
    one.  It calls ``CUDAGraph.capture_begin``/``capture_end`` itself
    rather than entering ``torch.cuda.graph``, which first synchronizes
    the device and empties the allocator's cache: work a one-shot solve
    pays on every call, and needs neither.
    """
    record(f"capture {name}")
    device = torch.cuda.current_device()
    side = _capture_streams.get(device)
    if side is None:
        side = _capture_streams[device] = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with _no_collection(), bp.captured_launches() as launches, \
            torch.cuda.stream(side):
        graph.capture_begin()
        try:
            body()
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    return graph, launches


class _Program:
    """``body`` over static buffers, run by :meth:`run`: a CUDA graph
    captured at construction (``capture``) and replayed, or the body
    called eagerly.  A captured program keeps the graph and not the
    body, whose closure leads back to the program's owner: a graph in a
    reference cycle is destroyed whenever the collector runs, perhaps
    inside another capture."""

    def __init__(self, body, *, capture: bool, name: str):
        self.body = self.graph = self.launches = None
        if capture:
            self.graph, self.launches = _capture(body, name)
        else:
            self.body = body

    def run(self) -> None:
        if self.graph is None:
            self.body()
            return
        self.graph.replay()
        bp.add_launches(self.launches)


class _Loop:
    """``n`` steps of ``h`` from ``state``, a state on static copies of
    its tensors that the steps write back into, and their records
    (``res``, ``err``)."""

    def __init__(self, h: History, state, n: int, *, capture: bool,
                 name: str):
        self.h, self.n = h, n
        self.static = [_static(t) for t in _tensors(state)]
        self.state = _with_tensors(state, self.static)
        self.program = _Program(self._body, capture=capture, name=name)

    def _body(self) -> None:
        state, self.res, self.err = self.h.steps(self.state, self.n)
        for buf, t in zip(self.static, _tensors(state)):
            if t is not buf:
                buf.copy_(t)


def run_history(h: History, state, iters: int, *, name: str = "history"):
    """(state, residuals, errors) after ``iters`` steps of ``h``: the eager
    head, the CHUNK-step graph's replays, the eager tail (module
    docstring).  Bit-identical to :func:`eager_history` wherever the
    captured steps pick the same kernels as the eager ones (the kernel
    path's glue is elementwise and reductions; cuBLAS may choose another
    algorithm inside a graph).  The state counter ``t`` advances by
    ``iters`` on the host."""
    if _capture_disabled or iters == 0:
        return eager_history(h, state, iters)
    capture = _capturing(h.b)
    with _cusolver() if capture else contextlib.nullcontext():
        t0 = state.t
        head = min(CHUNK, iters)
        state, res, err = h.steps(state, head)
        res, err = [res], [err]
        reps, tail = divmod(iters - head, CHUNK)
        if reps:
            loop = _Loop(h, state, CHUNK, capture=capture, name=name)
            for _ in range(reps):
                loop.program.run()
                res.append(loop.res.clone())
                err.append(None if loop.err is None else loop.err.clone())
            state = loop.state
        if tail:
            state, r, e = h.steps(state, tail)
            res.append(r)
            err.append(e)
        state = state._replace(t=t0 + iters)
        return (state, *h.close(
            state, torch.cat(res),
            None if h.x_true is None else torch.cat(err)))


# ---------------------------------------------------------------------------
# The serving executor
# ---------------------------------------------------------------------------


def executor_key(solver, sys, prm: dict, plan, k: int, iters: int) -> tuple:
    """The compile-once key of serving (the reference's ``executor_key``,
    ``repro/solvers/serve.py``): what an executor closes over — solver,
    shapes, dtype, structure, mode, parameters, the plan's signature with
    the kernel flag resolved for this system, batch and iterations."""
    plan = resolve_plan(solver, sys, plan, context="executor_key")
    return (solver.name, sys.m, sys.p, sys.n, str(sys.A_blocks.dtype),
            sys.structure, sys.mode, tuple(sorted(prm.items())),
            plan.signature(), k, iters)


def _placement(A, factors) -> tuple:
    """The addresses a program reads A and the factors at."""
    leaves = [A, *(factors if isinstance(factors, tuple) else (factors,))]
    out = []
    for leaf in leaves:
        for t in (leaf if isinstance(leaf, tuple) else (leaf,)):
            if isinstance(t, torch.Tensor):
                out.append((t.data_ptr(), tuple(t.shape), t.dtype))
    return tuple(out)


@dataclasses.dataclass
class _Served:
    """One program of an executor: the placed A and factors it reads, its
    static right-hand sides (and states, warm), and its outputs."""
    A: Any
    factors: Any
    Bb: torch.Tensor
    static: Optional[list] = None     # warm: the states' buffers
    states: Any = None                # warm: the states, on them
    program: Optional[_Program] = None
    out: Any = None                   # (states, X, res) of the last run


class LocalExecutor:
    """Compile-once single-device executor of a (k, m, p) right-hand-side
    batch: the counterpart of the reference's ``_LocalExecutor``.

    ``run(A, factors, Bb, states=None) -> (states, X, res)`` runs the cold
    program (init + ``iters`` steps) or the warm one (``iters`` steps from
    ``states``), with the lagged fused residual (``use_kernel`` on a
    solver that has it, outside least squares) and the least-squares
    optimality residual (``ls_mode``).  X is (k, n), res (k, iters).

    On the card the first run of a program — per cold/warm, placement of
    A and the factors (their addresses), and batch shape — copies Bb (and
    the states) into buffers the executor owns, runs a warm-up head
    eagerly (init and the first :data:`CHUNK` steps), and captures the
    program into one CUDA graph; every run then only copies its inputs
    into those buffers and replays.  What it returns is cloned out of the
    graph's outputs, so a later replay never overwrites it.  The executor
    holds the placed A and factors, which the graph reads by address: a
    new placement is a new build and a new capture.  On the CPU the same
    body runs eagerly through the same buffers.

    ``builds`` counts programs built (key misses, on any device),
    ``captures`` the graphs captured; :meth:`cache_size` is the number of
    programs held (the reference's ``jit_cache_size``).
    """

    def __init__(self, solver, prm, iters: int, use_kernel: bool = False,
                 ls_mode: bool = False):
        self.solver, self.prm, self.iters = solver, dict(prm), iters
        self.use_kernel, self.ls_mode = use_kernel, ls_mode
        self.fused = (use_kernel and solver.supports_fused_residual
                      and not ls_mode and iters > 0)
        self.builds = self.captures = 0
        self._programs: dict = {}

    def cache_size(self) -> int:
        return len(self._programs)

    def _history(self, served: _Served) -> History:
        s, prm, Bb = self.solver, self.prm, served.Bb
        residual_fn = (s._ls_residual(served.A, served.factors, prm, Bb)
                       if self.ls_mode else None)
        step_res = ((lambda f, bb, sts: s.step_many_residual(f, bb, sts,
                                                             prm))
                    if self.fused else None)
        return History(
            lambda f, bb, sts: s.step_many(f, bb, sts, prm,
                                           use_kernel=self.use_kernel),
            s.extract, served.factors, Bb, served.A,
            residual_fn=residual_fn, step_residual=step_res, batched=True)

    def _states(self, served: _Served):
        if served.states is None:
            return self.solver.init(served.factors, served.Bb, self.prm)
        return served.states

    def _body(self, served: _Served, iters: int) -> None:
        states, res, _ = eager_history(self._history(served),
                                       self._states(served), iters)
        served.out = (states, self.solver.extract(states), res)

    def _build(self, A, factors, Bb, states, key) -> _Served:
        self.builds += 1
        cold = states is None
        record(
            f"build {self.solver.name}.{'cold' if cold else 'warm'}",
            f"Bb {tuple(Bb.shape)} {Bb.dtype} {Bb.device}")
        served = _Served(A=A, factors=factors, Bb=_static(Bb))
        if not cold:
            served.static = [_static(t) for t in _tensors(states)]
            served.states = _with_tensors(states, served.static)
        capture = _capturing(Bb)
        if capture:
            # the warm-up head: every kernel instance, library handle and
            # module the graph launches is first launched outside it
            self._body(served, min(CHUNK, self.iters))
            self.captures += 1
        served.program = _Program(
            lambda: self._body(served, self.iters), capture=capture,
            name=f"{self.solver.name}.{'cold' if cold else 'warm'}")
        self._programs[key] = served
        return served

    def run(self, A, factors, Bb: torch.Tensor, states=None):
        key = (states is None, _placement(A, factors), tuple(Bb.shape),
               Bb.dtype, Bb.device)
        capture = _capturing(Bb)
        with _cusolver() if capture else contextlib.nullcontext():
            served = self._programs.get(key)
            if served is None:
                served = self._build(A, factors, Bb, states, key)
            served.Bb.copy_(Bb)
            if states is not None:
                for buf, t in zip(served.static, _tensors(states)):
                    buf.copy_(t)
            served.program.run()
        out_states, X, res = served.out
        t0 = 0 if states is None else states.t
        out_states = _with_tensors(out_states, [
            t.clone() for t in _tensors(out_states)])._replace(
                t=t0 + self.iters)
        return out_states, X.clone(), res.clone()
