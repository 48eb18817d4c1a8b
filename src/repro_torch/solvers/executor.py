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
  and module outside the capture, and resolve the engine and tile
  verdicts the steps read, ``kernels.ops``); one CHUNK-step graph is
  captured from
  the state they leave and replayed ⌊(T−C)/C⌋ times; the last
  (T−C) mod C steps run eagerly.  No graph outlives the call.
* :class:`LocalExecutor`, the reusable program of serving (ROADMAP A13):
  one graph for the whole cold (init + T steps) or warm (T steps from
  given states) program of a placed system and batch shape, captured at
  its first run and replayed for every later batch.  On the mesh
  backend it runs a rank's shards with the mesh's context
  (``serve._MeshExecutor`` places them).
* :class:`StepProgram`, the redundant runners' one step, captured once
  and replayed a step at a time with a per-step input copied in.

Whether a history is captured is :func:`capturable`'s one verdict: the
tensors on the card (``ops.on_cuda``, the predicate of the kernel ops),
capture not disabled, and every process group the history's context sums
over NCCL, whose collectives a graph captures; gloo's go through the
host, so a mesh on gloo runs eagerly.  Everywhere else (the CPU, where
the caller put the tensors there, or gloo) the same bodies run through
the same static buffers and chunks, eagerly.  A capture or a replay that
fails raises: nothing retries eagerly.
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
import threading
from typing import Any, Optional

import torch

from repro_torch import device as dev
from repro_torch.analysis.tracecheck import record
from repro_torch.core import blockops
from repro_torch.kernels import block_projection as bp
from repro_torch.kernels import ops
from repro_torch.solvers.capability import resolve_plan

__all__ = ["CHUNK", "History", "LOCAL_PSUM", "LocalExecutor", "StepProgram",
           "capturable", "default_linalg", "disable_capture",
           "eager_history", "executor_key", "residual", "run_history"]

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


def _cuda_backend(group) -> str:
    """The backend that carries a process group's collectives on CUDA
    tensors: ``dist.get_backend``'s name, or where the group names one a
    device (``"cpu:gloo,cuda:nccl"``) the one it names for ``cuda``."""
    import torch.distributed as dist
    name = str(dist.get_backend(group))
    if ":" not in name:
        return name
    return dict(part.split(":", 1) for part in name.split(",")).get(
        "cuda", "")


def capturable(ctx, b: torch.Tensor) -> bool:
    """Whether a history summing through ``ctx`` over tensors like ``b``
    runs captured: ``b`` on the card and capture not disabled
    (:func:`disable_capture`), and every process group of ``ctx``
    (``ctx.groups()``: none locally, a ``MeshContext``'s worker and model
    groups) on NCCL.  The one predicate of :func:`run_history`,
    :class:`LocalExecutor` and :class:`StepProgram`."""
    return _capturing(b) and all(_cuda_backend(g) == "nccl"
                                 for g in ctx.groups())


class _Shared:
    """A process-wide setting held while any thread is inside: the first
    to enter applies it (``enter() -> what to restore``), the last to
    leave restores it.  The settings below are global to the process, and
    serving runs histories on several threads at once."""

    def __init__(self, enter, leave):
        self._enter, self._leave = enter, leave
        self._lock = threading.Lock()
        self._depth, self._saved = 0, None

    @contextlib.contextmanager
    def __call__(self):
        with self._lock:
            if self._depth == 0:
                self._saved = self._enter()
            self._depth += 1
        try:
            yield
        finally:
            with self._lock:
                self._depth -= 1
                if self._depth == 0:
                    self._leave(self._saved)


class _Linalg:
    """The linalg backend preference
    (``torch.backends.cuda.preferred_linalg_library``), global to the
    process, held by section: inside ``_linalg("cusolver")`` it is
    cuSOLVER, inside ``_linalg(None)`` the process's own.  Sections of one
    kind share the setting (the first to enter applies it, the last to
    leave restores it); sections of the two kinds exclude each other.  So
    what runs in a ``None`` section (the servers' factorizations and
    inits) takes the same library whichever other thread is capturing
    meanwhile.  A thread never enters one kind inside the other."""

    def __init__(self):
        self._cv = threading.Condition()
        self._kind = self._saved = None
        self._depth = 0

    @contextlib.contextmanager
    def __call__(self, library: Optional[str]):
        with self._cv:
            while self._depth and self._kind != library:
                self._cv.wait()
            if self._depth == 0:
                self._kind = library
                if library is not None:
                    self._saved = \
                        torch.backends.cuda.preferred_linalg_library()
                    torch.backends.cuda.preferred_linalg_library(library)
            self._depth += 1
        try:
            yield
        finally:
            with self._cv:
                self._depth -= 1
                if self._depth == 0:
                    if self._kind is not None:
                        torch.backends.cuda.preferred_linalg_library(
                            self._saved)
                    self._cv.notify_all()


#: cuSOLVER for ``torch.cholesky_solve`` (the unfused steps' Gram solves,
#: ``core.apc._gram_solve``) while a history is captured: PyTorch's
#: default sends a batch of solves to MAGMA, whose batched solve stages
#: its pointer arrays in host memory, which a graph cannot capture.
_linalg = _Linalg()


def default_linalg():
    """A section on the process's own linalg preference: no capture's
    cuSOLVER section runs meanwhile (``_Linalg``).  The servers compute
    their store misses in one, so an entry's bits do not depend on the
    schedule of the pipeline's threads."""
    return _linalg(None)


# ---------------------------------------------------------------------------
# One history's step and records
# ---------------------------------------------------------------------------


class _LocalPsum:
    """The psum context of the local backend: one shard, so both sums are
    identities (and the workers are all local: the reference's
    ``redundant._LocalContext``).  Lets the records and the least-squares hooks be written
    once against the ``MeshContext`` psum contract
    (``solvers/mesh.py``) and run on both backends."""

    @staticmethod
    def psum_workers(x):
        return x

    @staticmethod
    def psum_model(x):
        return x

    @staticmethod
    def workers_total(m_local: int) -> int:
        return m_local

    @staticmethod
    def groups() -> tuple:
        """No process group: nothing stands in the way of a capture."""
        return ()


LOCAL_PSUM = _LocalPsum()


def residual(A, b, x, b_norm, ctx=LOCAL_PSUM) -> torch.Tensor:
    """‖Ax − b‖/‖b‖: x (n,) with b (m, p), or a batch x (k, n) with b (k,
    m, p) -> (k,).  On the mesh from local shards (A and x cut along n
    over the model axis, the blocks over the workers), summed through
    ``ctx``; the result is replicated."""
    r = ctx.psum_model(blockops.bmatvec(A, x)) - b
    return torch.sqrt(ctx.psum_workers(torch.sum(r * r, dim=(-2, -1)))) \
        / b_norm


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
    same indexing as the plain path.  ``ctx`` sums the norms across
    shards: the identity locally, a ``MeshContext`` on the mesh backend,
    where every argument is this rank's shard and every record is
    replicated.
    """

    def __init__(self, step, extract, factors, b, A, *, x_true=None,
                 residual_fn=None, step_residual=None, batched=False,
                 ctx=LOCAL_PSUM):
        self.step, self.extract, self.factors = step, extract, factors
        self.b, self.A, self.batched = b, A, batched
        self.residual_fn, self.step_residual = residual_fn, step_residual
        self.x_true, self.ctx = x_true, ctx
        self.xt_norm = None if x_true is None else self._norm(x_true)
        self.b_norm = torch.sqrt(ctx.psum_workers(
            torch.sum(b * b, dim=(-2, -1))))

    def _norm(self, v: torch.Tensor) -> torch.Tensor:
        """‖v‖ of an (n,) vector cut along n over the model axis."""
        return torch.sqrt(self.ctx.psum_model(torch.sum(v * v)))

    def true_res(self, state) -> torch.Tensor:
        return residual(self.A, self.b, self.extract(state), self.b_norm,
                        self.ctx)

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
            self._norm(self.extract(state) - self.x_true) / self.xt_norm)
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


def _gc_off():
    was = gc.isenabled()
    gc.disable()
    return was


#: no cyclic garbage collection inside: a CUDA graph it destroyed there
#: would invalidate the capture under way
_no_collection = _Shared(_gc_off, lambda was: gc.enable() if was else None)

#: each thread's side stream of each device, for its captures
_capture_streams = threading.local()


def _capture(body, name: str):
    """``body`` captured into a CUDA graph on the current device: (graph,
    the kernel launches it holds).  The launches counted while capturing
    ran nothing and are taken back out of the counts; the replays add
    them.

    The capture runs on a side stream of its own thread (a graph cannot
    be captured on the default stream) that first waits for the current
    one.  It calls ``CUDAGraph.capture_begin``/``capture_end`` itself
    rather than entering ``torch.cuda.graph``, which first synchronizes
    the device and empties the allocator's cache: work a one-shot solve
    pays on every call, and needs neither.  The capture is thread-local:
    another thread's work on the card meanwhile (a serving pipeline
    copies the next batch in while a pool thread captures) does not
    invalidate it.
    """
    record(f"capture {name}")
    device = torch.cuda.current_device()
    streams = vars(_capture_streams).setdefault("by_device", {})
    side = streams.get(device)
    if side is None:
        side = streams[device] = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with _no_collection(), bp.captured_launches() as launches, \
            torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
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
    ``iters`` on the host.  On a mesh the eager head also makes each
    group's first collective, where NCCL creates its communicator, which
    no capture may do; it runs inside ``ops.rank0_decides`` there."""
    if _capture_disabled or iters == 0:
        return eager_history(h, state, iters)
    capture = capturable(h.ctx, h.b)
    with _linalg("cusolver") if capture else contextlib.nullcontext():
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


class StepProgram:
    """One step of ``h``, run a step at a time, each step first copying
    its row of a per-step input into ``inp``, a static buffer the step
    reads (the redundant runners' (m, r) selection weights,
    ``solvers.redundant``).

    Where :func:`capturable` says so, the step is captured into a CUDA
    graph at the first run (after a warm-up step on a throwaway state:
    every kernel instance, library handle and communicator the graph
    launches is first used outside it) and every step of every run is a
    replay; elsewhere the same step runs eagerly through the same
    buffers.  So a history split into runs anywhere is bit-equal to the
    history in one run.  Under :func:`disable_capture` the plain eager
    loop runs.  ``captures`` counts the graphs (one at most),
    :meth:`cache_size` the step programs held.  ``h``'s step closes over
    ``inp``, never over the program's owner: a graph is never in a
    reference cycle."""

    def __init__(self, h: History, inp: torch.Tensor, name: str):
        self.h, self.inp, self.name = h, inp, name
        self.captures = 0
        self._loop: Optional[_Loop] = None

    def cache_size(self) -> int:
        return int(self._loop is not None)

    def run(self, state, seq):
        """``h``'s step over the T rows of ``seq`` from ``state``:
        ``(state, residuals (T,), errors (T,))``, the errors the residuals
        without ``x_true``."""
        h, T = self.h, int(seq.shape[0])
        res = h.b_norm.new_empty((T,))
        err = res if h.x_true is None else h.b_norm.new_empty((T,))
        if T == 0:
            return state, res, err
        t0 = state.t
        if _capture_disabled:
            for t in range(T):
                self.inp.copy_(seq[t])
                state, res[t], e = h.one(state)
                if e is not None:
                    err[t] = e
            return state._replace(t=t0 + T), res, err
        if self._loop is None:
            self.inp.copy_(seq[0])
            capture = capturable(h.ctx, h.b)
            if capture:
                h.steps(state, 1)
                self.captures += 1
            self._loop = _Loop(h, state, 1, capture=capture, name=self.name)
        loop = self._loop
        for buf, v in zip(loop.static, _tensors(state)):
            buf.copy_(v)
        for t in range(T):
            self.inp.copy_(seq[t])
            loop.program.run()
            res[t:t + 1].copy_(loop.res)
            if loop.err is not None:
                err[t:t + 1].copy_(loop.err)
        state = _with_tensors(loop.state,
                              [v.clone() for v in _tensors(loop.state)])
        return state._replace(t=t0 + T), res, err


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
    static right-hand sides and states, and its outputs."""
    A: Any
    factors: Any
    Bb: torch.Tensor
    static: list                      # the states' buffers
    states: Any                       # the states, on them
    program: Optional[_Program] = None
    out: Any = None                   # (states, X, res) of the last run
    done: Any = None                  # the card: an event after the last run


class LocalExecutor:
    """Compile-once single-device executor of a (k, m, p) right-hand-side
    batch: the counterpart of the reference's ``_LocalExecutor``.

    ``run(A, factors, Bb, states=None) -> (states, X, res)`` runs the cold
    program (``init`` from Bb, then ``iters`` steps) or the warm one
    (``iters`` steps from ``states``), with the lagged fused residual
    (``use_kernel`` on a solver that has it, outside least squares) and
    the least-squares optimality residual (``ls_mode``).  X is (k, n), res
    (k, iters).

    On the card the first run of a program — per cold/warm, placement of
    A and the factors (their addresses), and batch shape — copies Bb and
    the states into buffers the executor owns, runs a warm-up head
    eagerly (the first :data:`CHUNK` steps), and captures the ``iters``
    steps into one CUDA graph; every run then only copies its inputs into
    those buffers and replays.  ``init`` runs eagerly, outside the graph,
    on the process's own linalg library (:func:`default_linalg`), as
    ``solve_many``'s does.  What a run returns is cloned out of the
    graph's outputs, so a later replay never overwrites it.  The executor
    holds the placed A and factors, which the graph reads by address: a
    new placement is a new build and a new capture.  On the CPU the same
    body runs eagerly through the same buffers.

    ``ctx`` is the psum context the steps sum through: ``LOCAL_PSUM`` (the
    solver's local hooks), or a mesh's ``MeshContext`` (its ``mesh_*``
    hooks on this rank's shards, every record replicated), under which
    the program is captured only where every group of the mesh is NCCL
    (:func:`capturable`; the warm-up head makes each group's first
    collective), and runs through the same buffers eagerly on gloo.  The
    mesh's executor (``serve._MeshExecutor``) places the shards and
    decides the verdicts on rank 0 around :meth:`run`.

    ``builds`` counts programs built (key misses, on any device),
    ``captures`` the graphs captured; :meth:`cache_size` is the number of
    programs held (the reference's ``jit_cache_size``).

    Serving (``solvers.serve``): :meth:`place_system` and :meth:`place_B`
    put a system and a batch where the programs read them; :meth:`drop`
    frees the programs of a placement the server no longer holds.  Runs
    may come from several threads at once (the async pipeline's pool): a
    lock held from the copy into the static buffers to the clone out of
    the outputs keeps them from racing, and the copies, the replay and the
    clones go to the calling thread's current stream, whose order protects
    the buffers after the lock is released.
    """

    def __init__(self, solver, prm, iters: int, use_kernel: bool = False,
                 ls_mode: bool = False, ctx=LOCAL_PSUM):
        self.solver, self.prm, self.iters = solver, dict(prm), iters
        self.use_kernel, self.ls_mode, self.ctx = use_kernel, ls_mode, ctx
        self.fused = (use_kernel and solver.supports_fused_residual
                      and not ls_mode and iters > 0)
        self.builds = self.captures = 0
        self._programs: dict = {}
        self._lock = threading.Lock()

    def cache_size(self) -> int:
        return len(self._programs)

    def place_system(self, sys, factors):
        """(A, factors) as the programs read them: the system's own
        operand and the factors as given, on the system's device — no
        copy of A or B is made."""
        return sys.A_op, factors

    def place_B(self, Bb, A=None) -> torch.Tensor:
        """A (k, m, p) right-hand-side batch on the device of the placed
        ``A`` (:meth:`place_system`'s), or without it on the port's
        default device (``device.resolve()``: the card), copied in on the
        calling thread (the async pipeline's assembly thread copies batch
        B+1 in while batch B runs)."""
        where = (dev.resolve() if A is None
                 else (A.vals if blockops.is_sparse(A) else A).device)
        return torch.as_tensor(Bb, device=where)

    def drop(self, A, factors) -> int:
        """Free the programs of the placement (A, factors), which the
        graphs read by address: an evicted store entry must not live on
        in a graph.  First waits for each one's last run on the card,
        which may still be under way.  Returns the number dropped."""
        placement = _placement(A, factors)
        return self._free(lambda key: key[1] == placement)

    def release(self) -> int:
        """Free every program, as :meth:`drop` does a placement's: a mesh
        server's graphs hold its communicators' collectives, and go before
        its process group does (``LinsysServer.close``)."""
        return self._free(lambda key: True)

    def _free(self, which) -> int:
        with self._lock:
            stale = [self._programs.pop(k) for k in list(self._programs)
                     if which(k)]
        for served in stale:
            if served.done is not None:
                served.done.synchronize()
        return len(stale)

    def _init(self, factors, Bb):
        s, ctx = self.solver, self.ctx
        if ctx is LOCAL_PSUM:
            return s.init(factors, Bb, self.prm)
        return s.mesh_init(factors, Bb, self.prm, ctx)

    def _history(self, served: _Served) -> History:
        s, prm, Bb, ctx = self.solver, self.prm, served.Bb, self.ctx
        kernel = self.use_kernel
        residual_fn = (s._ls_residual(served.A, served.factors, prm, Bb,
                                      ctx) if self.ls_mode else None)
        if ctx is LOCAL_PSUM:
            step = lambda f, bb, sts: s.step_many(  # noqa: E731
                f, bb, sts, prm, use_kernel=kernel)
            step_res = lambda f, bb, sts: s.step_many_residual(  # noqa: E731
                f, bb, sts, prm)
        else:
            step = lambda f, bb, sts: s.mesh_step_many(  # noqa: E731
                f, bb, sts, prm, ctx, use_kernel=kernel)
            step_res = lambda f, bb, sts: s.mesh_step_many_residual(  # noqa: E731,E501
                f, bb, sts, prm, ctx)
        return History(step, s.extract, served.factors, Bb, served.A,
                       residual_fn=residual_fn,
                       step_residual=step_res if self.fused else None,
                       batched=True, ctx=ctx)

    def _body(self, served: _Served, iters: int) -> None:
        states, res, _ = eager_history(self._history(served), served.states,
                                       iters)
        served.out = (states, self.solver.extract(states), res)

    def _build(self, A, factors, Bb, states, key) -> _Served:
        self.builds += 1
        name = f"{self.solver.name}.{'cold' if key[0] else 'warm'}"
        record(f"build {name}",
               f"Bb {tuple(Bb.shape)} {Bb.dtype} {Bb.device}")
        static = [_static(t) for t in _tensors(states)]
        served = _Served(A=A, factors=factors, Bb=_static(Bb), static=static,
                         states=_with_tensors(states, static))
        if ops.on_cuda("history", Bb):
            served.done = torch.cuda.Event()
        capture = capturable(self.ctx, Bb)
        with _linalg("cusolver") if capture else contextlib.nullcontext():
            if capture:
                # the warm-up head: every kernel instance, library handle,
                # module and communicator the graph launches is first used
                # outside
                self._body(served, min(CHUNK, self.iters))
                self.captures += 1
            served.program = _Program(
                lambda: self._body(served, self.iters), capture=capture,
                name=name)
        self._programs[key] = served
        return served

    def run(self, A, factors, Bb: torch.Tensor, states=None):
        cold = states is None
        key = (cold, _placement(A, factors), tuple(Bb.shape), Bb.dtype,
               Bb.device)
        if cold:
            with default_linalg():
                states = self._init(factors, Bb)
        if self.use_kernel:
            # the engine and tile verdicts, before any build or capture
            self.solver.resolve_engine(factors, Bb.shape[0], Bb.dtype)
        with self._lock:
            served = self._programs.get(key)
            if served is None:
                served = self._build(A, factors, Bb, states, key)
            served.Bb.copy_(Bb)
            for buf, t in zip(served.static, _tensors(states)):
                buf.copy_(t)
            served.program.run()
            out_states, X, res = served.out
            out_states = _with_tensors(out_states, [
                t.clone() for t in _tensors(out_states)])
            X, res = X.clone(), res.clone()
            if served.done is not None:
                served.done.record()
        return out_states._replace(t=states.t + self.iters), X, res
