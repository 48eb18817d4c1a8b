"""The mesh backend: any registered solver, sharded over the ranks of a
``torch.distributed`` process group (counterpart of
``repro.solvers.mesh``).

Every solver runs distributed through the same lifecycle it uses on one
device::

    from repro_torch import solvers
    from repro_torch.launch import mesh as mesh_lib
    mesh = mesh_lib.solver_mesh_for(sys.m)           # a DeviceMesh
    res = solvers.get("dhbm").solve(
        sys, plan=solvers.ExecutionPlan(backend="mesh", mesh=mesh))

It is SPMD: every rank runs the same program on its own shard.

  * worker i   -> a slice of the worker axes (``"data"``, optionally
                  ``"pod"``): the m row blocks shard over them.
  * taskmaster -> no rank: every master update is an ``all_reduce`` over
                  the worker axes (``MeshContext.psum_workers``).
  * columns    -> optionally sharded over ``"model"``; a worker's
                  products then need one p-sized ``all_reduce`` over the
                  model axis (``psum_model``).

Placement replaces the reference's PartitionSpecs: each operand, factor
and state field has a placement tuple (``("w", None, "n")``: the leading
axis over the workers, n over the model axis), and each rank copies its
own contiguous shard, and only that, to its device (contiguous, so the
kernels' ring takes the shard where it takes the whole block).  Setup
runs on the mesh (``mesh_prepare``, ``mesh_init``); states and results
come back with GLOBAL shapes on every rank, so warm starts and
checkpoints cross backends both ways.

The step loop is ``executor.History`` with the context summing its
norms, compiled once as the reference's ``jit(shard_map(...))``: run by
``executor.run_history`` (solves and ``solve_many``), by the serving
executor (``serve._MeshExecutor``) and, one step captured and replayed
a step at a time, by :class:`RedundantRunner` (``executor
.StepProgram``).  Where every group of the context is NCCL and the shards
are on the card the loop is captured into CUDA graphs, whose replays
launch the collectives with the kernels; on gloo (whose collectives go
through the host) and on the CPU the same chunked bodies run through the
same static buffers eagerly (``executor.capturable``).  A capture or
replay that fails raises; nothing retries eagerly.  Every host-side
decision rests on replicated values (the iteration count,
``iters_to_tol``, the engine and tile verdicts, which ``kernels.ops``
takes on rank 0 and broadcasts in the loop's eager head, before any
capture, ``ops.rank0_decides``), so every rank issues the same
collectives, and captures the same graphs, in the same order; everything
a solve validates (capability, axes, divisibility, precision) is checked
before its first collective.

Per-solver code lives in the ``mesh_*`` hooks of each solver
(``api.Solver``); this module owns the context, placement, the history
loop and the ``SolveResult``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import blockops
from repro_torch.core.partition import BlockSystem
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib

from . import executor
from .api import SolveResult, iters_to_tolerance
from .capability import check_capability, resolve_use_kernel

__all__ = ["BatchedRunner", "CompiledSolve", "MeshContext",
           "batched_runner", "compile_solve", "make_context",
           "operand_placement", "residual_shard", "solve_many_mesh",
           "solve_mesh"]

# (id(mesh), worker axes) -> (mesh, this rank's group over those axes)
_GROUPS: dict = {}


def _axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _coords(mesh, rank: int) -> dict:
    """A rank's coordinate along each named dim of ``mesh``."""
    where = (mesh.mesh == rank).nonzero()[0].tolist()
    return dict(zip(mesh.mesh_dim_names, where))


def _worker_group(mesh, axes: Tuple[str, ...]):
    """This rank's group over the worker axes ``axes``: the mesh's own
    sub-group for one axis; for several, one group built by
    ``dist.new_group`` from the mesh's rank grid, every rank creating
    every group in the same order (``new_group`` is collective)."""
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    if key not in _GROUPS:
        names = list(mesh.mesh_dim_names)
        grid = mesh.mesh.permute(
            [names.index(a) for a in names if a not in axes]
            + [names.index(a) for a in axes])
        grid = grid.reshape(-1, math.prod(_axis_size(mesh, a)
                                          for a in axes))
        mine = None
        for ranks in grid.tolist():
            group = dist.new_group(ranks)
            if dist.get_rank() in ranks:
                mine = group
        _GROUPS[key] = (mesh, mine)
    return _GROUPS[key][1]


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """The collectives handed to every ``mesh_*`` solver hook.

    ``psum_workers``/``psum_model`` are the only collectives a solver
    needs (the taskmaster is a sum, never a rank): each is an
    ``all_reduce(SUM)`` on a copy of its argument, as ``all_reduce``
    works in place.  Constructing a context is collective where it has
    several worker axes (their group is built then): every rank
    constructs the same contexts in the same order.
    """
    mesh: Any
    worker_axes: Tuple[str, ...]
    model_axis: Optional[str]

    def __post_init__(self):
        object.__setattr__(self, "worker_axes", tuple(self.worker_axes))
        # the worker axes' group, built now: on every rank at once
        object.__setattr__(self, "_wgroup",
                           _worker_group(self.mesh, self.worker_axes))

    @property
    def workers(self) -> int:
        """The number of worker shards."""
        return math.prod(_axis_size(self.mesh, a) for a in self.worker_axes)

    @property
    def model_shards(self) -> int:
        """The number of column shards (1 when n is not sharded)."""
        return (1 if self.model_axis is None
                else _axis_size(self.mesh, self.model_axis))

    def index(self, rank: Optional[int] = None) -> Tuple[int, int]:
        """(worker shard, column shard) of ``rank`` (default: this one):
        the worker shard row-major over ``worker_axes``."""
        c = _coords(self.mesh, dist.get_rank() if rank is None else rank)
        w = 0
        for a in self.worker_axes:
            w = w * _axis_size(self.mesh, a) + c[a]
        return w, (0 if self.model_axis is None else c[self.model_axis])

    def psum_workers(self, v: torch.Tensor) -> torch.Tensor:
        """Sum over every worker axis (the Eq. 2b taskmaster)."""
        out = v.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=self._wgroup)
        return out

    def psum_model(self, v: torch.Tensor) -> torch.Tensor:
        """Sum over the column shards (``v`` itself when n is not
        sharded)."""
        if self.model_axis is None:
            return v
        out = v.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=self.mesh.get_group(self.model_axis))
        return out

    def workers_total(self, m_local: int) -> int:
        """The global worker count m from a shard's worker axis."""
        return m_local * self.workers

    def groups(self) -> tuple:
        """The process groups the sums run over: the workers' and, with a
        model axis, the column shards' (``executor.capturable`` captures
        only where every one is NCCL)."""
        if self.model_axis is None:
            return (self._wgroup,)
        return (self._wgroup, self.mesh.get_group(self.model_axis))


def make_context(mesh, sys: BlockSystem, *,
                 worker_axes: Sequence[str] = ("data",),
                 model_axis: Optional[str] = "model") -> MeshContext:
    """Validate the mesh's axes against the system and build its context.

    As the reference: axes the mesh lacks are dropped (a misspelled name
    runs unsharded along it, silently), a sparse system forces
    ``model_axis=None`` (its ``cols`` index the global n), and m and n
    must be divisible by their shard counts.  Every check runs before the
    context's first collective.
    """
    names = tuple(mesh.mesh_dim_names)
    if math.prod(mesh.mesh.shape) != dist.get_world_size():
        raise ValueError(f"the mesh {names} holds {mesh.mesh.numel()} ranks "
                         f"of {dist.get_world_size()}: it must cover every "
                         f"rank")
    worker_axes = tuple(a for a in worker_axes if a in names)
    if not worker_axes:
        raise ValueError(f"mesh {names} has none of the requested worker "
                         f"axes")
    if model_axis is not None and model_axis not in names:
        model_axis = None
    if sys.is_sparse:
        model_axis = None
    wsize = math.prod(_axis_size(mesh, a) for a in worker_axes)
    if sys.m % wsize:
        raise ValueError(f"worker axes {worker_axes} have {wsize} shards, "
                         f"which does not divide m={sys.m}")
    nsize = 1 if model_axis is None else _axis_size(mesh, model_axis)
    if sys.n % nsize:
        raise ValueError(f"model axis {model_axis!r} has {nsize} shards, "
                         f"which does not divide n={sys.n}")
    return MeshContext(mesh=mesh, worker_axes=worker_axes,
                       model_axis=model_axis)


#: ‖Ax − b‖/‖b‖ from local shards, replicated out (the records' own
#: residual, ``executor.residual`` with a ``MeshContext``)
residual_shard = executor.residual


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------


def operand_placement(sys: BlockSystem):
    """The placement of ``sys.A_op``: one tuple for the dense stack, a
    ``SparseBlocks`` of tuples for a sparse operand (blocks over the
    workers; ``span`` whole)."""
    if sys.is_sparse:
        return blockops.SparseBlocks(vals=("w", None, None),
                                     cols=("w", None), span=(None,))
    return ("w", None, "n")


def _is_spec(p) -> bool:
    return type(p) is tuple


def _patch_factor_placement(fpl, a_pl):
    """A sparse operand's placement in a factor tree's ``A`` field."""
    if blockops.is_sparse(a_pl) and "A" in getattr(fpl, "_fields", ()):
        return fpl._replace(A=a_pl)
    return fpl


def _batched(pl):
    """Every placement of a state tree with a leading batch axis."""
    if pl is None:
        return None
    if _is_spec(pl):
        return (None,) + pl
    return type(pl)(*map(_batched, pl))


def _slices(spec, shape, ctx: MeshContext, rank: Optional[int] = None):
    """The index of ``rank``'s shard in a global tensor of ``shape``."""
    w, j = ctx.index(rank)
    idx = []
    for entry, size in zip(spec, shape):
        parts, at = ((ctx.workers, w) if entry == "w" else
                     (ctx.model_shards, j) if entry == "n" else (1, 0))
        step = size // parts
        idx.append(slice(at * step, (at + 1) * step))
    return tuple(idx)


def _shard(t, spec, ctx: MeshContext, device: torch.device):
    """This rank's contiguous shard of ``t`` on ``device``: a view where
    it already is one, else a copy of the shard alone."""
    if not isinstance(t, torch.Tensor) or spec is None:
        return t
    return t[_slices(spec, t.shape, ctx)].to(device).contiguous()


def _shard_tree(tree, pl, ctx: MeshContext, device: torch.device):
    if pl is None or _is_spec(pl):
        return _shard(tree, pl, ctx, device)
    return type(tree)(*(_shard_tree(v, p, ctx, device)
                        for v, p in zip(tree, pl)))


def _sharded(spec, ctx: MeshContext) -> bool:
    return ("w" in spec and ctx.workers > 1) or (
        "n" in spec and ctx.model_shards > 1)


def _gather(t, spec, ctx: MeshContext):
    """The global tensor of which every rank holds the shard ``t``: one
    ``all_gather`` over the world, each rank's shard placed by its
    coordinates (replicated copies land on each other)."""
    if not isinstance(t, torch.Tensor) or spec is None \
            or not _sharded(spec, ctx):
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    shape = [size * (ctx.workers if e == "w" else
                     ctx.model_shards if e == "n" else 1)
             for e, size in zip(spec, t.shape)]
    out = t.new_empty(shape)
    for rank, part in enumerate(parts):
        out[_slices(spec, shape, ctx, rank)] = part
    return out


def _gather_tree(tree, pl, ctx: MeshContext):
    if pl is None or _is_spec(pl):
        return _gather(tree, pl, ctx)
    return type(tree)(*(_gather_tree(v, p, ctx) for v, p in zip(tree, pl)))


def _place(solver, sys: BlockSystem, ctx: MeshContext, prm, factors, *,
           store=None, resume: bool = False, use_kernel: bool = False,
           precision: str = "default"):
    """Shard A and b, then the factors: a store hit's (or the caller's)
    global factors sharded, or a miss's on-mesh ``mesh_prepare``, whose
    factors are gathered to global shapes and inserted (the disk tier
    written by rank 0 alone), so later solves on either backend hit them.
    ``use_kernel`` keeps the pinv factors (a hit is augmented once per
    entry, by the store); a non-default ``precision`` casts LAST.
    Returns (A, b, factor placements, state placements, factors)."""
    device = mesh_lib.mesh_device(ctx.mesh)
    fpl, spl = solver.mesh_placements(use_kernel=use_kernel)
    a_pl = operand_placement(sys)
    fpl = _patch_factor_placement(fpl, a_pl)
    A = _shard_tree(sys.A_op, a_pl, ctx, device)
    b = _shard(sys.b_blocks, ("w", None), ctx, device)
    if factors is None and store is not None:
        factors = store.lookup(solver, sys, use_kernel=use_kernel,
                               precision=precision, **prm)
    if factors is None:
        # the on-mesh prepare is the store's miss path (the reference's
        # mesh.py is an allow-listed owner of the raw call too)
        factors = solver.mesh_prepare(  # repro: allow[R003]
            A, prm, ctx, use_kernel=use_kernel)
        if store is not None:
            store.insert(solver, sys, _gather_tree(factors, fpl, ctx),
                         resume=resume, use_kernel=use_kernel,
                         precision=precision,
                         persist=dist.get_rank() == 0, **prm)
    else:
        factors = _shard_tree(solver.mesh_factors(factors,
                                                  use_kernel=use_kernel),
                              fpl, ctx, device)
    if precision != "default":
        factors = solver.cast_factors(factors, precision)
    return A, b, fpl, spl, factors


# ---------------------------------------------------------------------------
# The history loop
# ---------------------------------------------------------------------------


class CompiledSolve(NamedTuple):
    """A placed mesh solve: call ``run(*args)`` repeatedly.

    ``run`` returns ``(state, residuals, errors)``, the state gathered to
    global shapes; ``has_errors`` says whether the error channel is real
    (x_true given) or aliases the residuals.  Benchmarks time repeated
    runs of the same placed arguments; ``solve_mesh`` builds one a call.
    """
    run: Any
    args: Tuple
    params: dict
    has_errors: bool


def compile_solve(solver, sys: BlockSystem, *, mesh=None, iters: int = 1000,
                  worker_axes: Sequence[str] = ("data",),
                  model_axis: Optional[str] = "model",
                  warm_state: Any = None, factors: Any = None,
                  store: Any = None, use_kernel: bool = False,
                  precision: str = "default", **params) -> CompiledSolve:
    """Placement, on-mesh setup and the history loop, without running it.
    ``mesh=None`` builds ``solver_mesh_for(sys.m)`` on the system's
    device."""
    check_capability(solver, sys, context="solve(mesh)")
    use_kernel = resolve_use_kernel(solver, sys, use_kernel)
    solver._check_precision(precision, use_kernel)
    # a solver without the hooks raises here, before any collective
    solver.mesh_placements(use_kernel=use_kernel)
    if mesh is None:
        mesh = mesh_lib.solver_mesh_for(sys.m, device=sys.device)
    ctx = make_context(mesh, sys, worker_axes=worker_axes,
                       model_axis=model_axis)
    prm = solver.resolve_params(sys, **params)
    A, b, fpl, spl, factors = _place(
        solver, sys, ctx, prm, factors, store=store,
        resume=warm_state is not None, use_kernel=use_kernel,
        precision=precision)
    device = mesh_lib.mesh_device(mesh)
    state = (solver.mesh_init(factors, b, prm, ctx) if warm_state is None
             else _shard_tree(warm_state, spl, ctx, device))
    xt = sys.x_true
    if xt is None and sys.mode == "least_squares":
        xt = solver.ls_reference(sys)        # errors against the LS optimum
    args = (A, b, factors, state)
    if xt is not None:
        args += (_shard(xt, ("n",), ctx, device),)
    ls = sys.mode == "least_squares"
    fused = (use_kernel and solver.supports_fused_residual and not ls
             and iters > 0)

    def step(f_, b_, s_):
        return solver.mesh_step(f_, b_, s_, prm, ctx, use_kernel=use_kernel)

    def step_residual(f_, b_, s_):
        return solver.mesh_step_residual(f_, b_, s_, prm, ctx)

    def run(A_, b_, f_, s_, *rest):
        h = executor.History(
            step, solver.extract, f_, b_, A_,
            x_true=rest[0] if rest else None,
            residual_fn=solver._ls_residual(A_, f_, prm, b_, ctx) if ls
            else None,
            step_residual=step_residual if fused else None, ctx=ctx)
        with ops.rank0_decides(device):
            s_, res, err = executor.run_history(h, s_, iters,
                                                name=f"{solver.name}.mesh")
        return _gather_tree(s_, spl, ctx), res, err

    return CompiledSolve(run=run, args=args, params=prm,
                         has_errors=xt is not None)


def solve_mesh(solver, sys: BlockSystem, *, mesh=None, iters: int = 1000,
               tol: float = 1e-6, worker_axes: Sequence[str] = ("data",),
               model_axis: Optional[str] = "model", warm_state: Any = None,
               factors: Any = None, store: Any = None,
               use_kernel: bool = False, precision: str = "default",
               **params) -> SolveResult:
    """The sharded ``solve``: the same ``SolveResult`` as the local driver
    (residual/error history, a warm-startable state with global shapes),
    on every rank.  ``use_kernel=True`` (projection family) runs each
    rank's worker update through the kernels on its (p × n/model) shard:
    the gather, an ``all_reduce`` of u over the model axis, the
    scatter."""
    cs = compile_solve(solver, sys, mesh=mesh, iters=iters,
                       worker_axes=worker_axes, model_axis=model_axis,
                       warm_state=warm_state, factors=factors, store=store,
                       use_kernel=use_kernel, precision=precision, **params)
    state, res, err = cs.run(*cs.args)
    return SolveResult(
        name=solver.name, x=solver.extract(state), state=state,
        residuals=res, errors=err if cs.has_errors else None,
        params=cs.params, iters_to_tol=iters_to_tolerance(res, tol), tol=tol)


class BatchedRunner(NamedTuple):
    """The multi-RHS init/run pair of one (solver, params, mesh) config,
    over PLACED shards: nothing system-specific is baked in beyond the
    params and the context, so one runner serves every same-shape
    system."""
    init: Any           # (factors, Bb)            -> states
    run: Any            # (A, Bb, factors, states) -> (states, X, res (k,T))
    A_placement: Any
    Bb_placement: Any
    factor_placements: Any
    state_placements: Any


def batched_runner(solver, ctx: MeshContext, prm, iters: int,
                   use_kernel: bool = False, *, a_placement: Any = None,
                   ls_mode: bool = False,
                   fused_residual: bool = False) -> BatchedRunner:
    """The init/run pair of ``solve_many_mesh``.  ``use_kernel=True``
    routes the batched step through the kernels (one launch of each for
    all k rows); ``a_placement`` the operand's (a ``SparseBlocks`` of
    tuples for a sparse system, ``operand_placement``); ``ls_mode``
    records each RHS's LS optimality; ``fused_residual`` (kernel path,
    square mode) harvests the history from the gather pass.  ``run``
    returns the states and X (k, n) gathered to global shapes."""
    if a_placement is None:
        a_placement = ("w", None, "n")
    fpl, spl = solver.mesh_placements(use_kernel=use_kernel)
    fpl = _patch_factor_placement(fpl, a_placement)
    spl = _batched(spl)
    fused = (fused_residual and use_kernel and not ls_mode and iters > 0
             and solver.supports_fused_residual)

    def init(f_, Bb_):
        return solver.mesh_init(f_, Bb_, prm, ctx)

    def step(f_, Bb_, s_):
        return solver.mesh_step_many(f_, Bb_, s_, prm, ctx,
                                     use_kernel=use_kernel)

    def step_residual(f_, Bb_, s_):
        return solver.mesh_step_many_residual(f_, Bb_, s_, prm, ctx)

    def run(A_, Bb_, f_, s_):
        h = executor.History(
            step, solver.extract, f_, Bb_, A_,
            residual_fn=solver._ls_residual(A_, f_, prm, Bb_, ctx)
            if ls_mode else None,
            step_residual=step_residual if fused else None, batched=True,
            ctx=ctx)
        with ops.rank0_decides(mesh_lib.mesh_device(ctx.mesh)):
            s_, res, _ = executor.run_history(
                h, s_, iters, name=f"{solver.name}.mesh_many")
        s_ = _gather_tree(s_, spl, ctx)
        return s_, solver.extract(s_), res

    return BatchedRunner(init=init, run=run, A_placement=a_placement,
                         Bb_placement=(None, "w", None),
                         factor_placements=fpl, state_placements=spl)


def solve_many_mesh(solver, sys: BlockSystem, B, *, mesh=None,
                    iters: int = 1000, tol: float = 1e-6,
                    worker_axes: Sequence[str] = ("data",),
                    model_axis: Optional[str] = "model", factors: Any = None,
                    store: Any = None, use_kernel: bool = False,
                    precision: str = "default", **params) -> SolveResult:
    """The sharded multi-RHS solve: one on-mesh factorization, k
    right-hand sides batched on every rank (the batch axis whole)."""
    check_capability(solver, sys, context="solve_many(mesh)")
    use_kernel = resolve_use_kernel(solver, sys, use_kernel)
    solver._check_precision(precision, use_kernel)
    solver.mesh_placements(use_kernel=use_kernel)
    B = torch.as_tensor(B, dtype=sys.b_blocks.dtype, device=sys.device)
    if B.ndim == 1:
        B = B[None, :]
    if B.shape[-1] != sys.N:
        raise ValueError(f"RHS batch has {B.shape[-1]} rows, need N={sys.N}")
    if mesh is None:
        mesh = mesh_lib.solver_mesh_for(sys.m, device=sys.device)
    ctx = make_context(mesh, sys, worker_axes=worker_axes,
                       model_axis=model_axis)
    k = B.shape[0]
    prm = solver.resolve_params(sys, **params)
    A, _, _, _, factors = _place(solver, sys, ctx, prm, factors, store=store,
                                 use_kernel=use_kernel, precision=precision)
    runner = batched_runner(solver, ctx, prm, iters, use_kernel=use_kernel,
                            a_placement=operand_placement(sys),
                            ls_mode=sys.mode == "least_squares",
                            fused_residual=use_kernel)
    Bb = _shard(B.reshape(k, sys.m, sys.p), runner.Bb_placement, ctx,
                mesh_lib.mesh_device(mesh))
    states = runner.init(factors, Bb)
    states, X, res = runner.run(A, Bb, factors, states)
    return SolveResult(
        name=solver.name, x=X, state=states, residuals=res, errors=None,
        params=prm, iters_to_tol=iters_to_tolerance(res, tol), tol=tol)


# ---------------------------------------------------------------------------
# Redundant execution on the mesh
# ---------------------------------------------------------------------------


def _shard_replicated(t, spec, holder, ctx: MeshContext,
                      device: torch.device):
    """This rank's shard of the replicated tensor ``t[holder]`` ((m, r,
    ...) from the per-worker (m, ...) ``t`` placed by ``spec``), made
    without the whole replication: the columns cut first (a view), then
    the rank's rows of ``holder`` gathered."""
    if not isinstance(t, torch.Tensor) or spec is None:
        return t
    cut = list(_slices(spec, t.shape, ctx))
    cut[0] = slice(None)
    rows = _shard(torch.as_tensor(holder), ("w", None), ctx,
                  t.device)                                  # (m_loc, r)
    return t[tuple(cut)][rows].to(device).contiguous()


class RedundantRunner:
    """The mesh runner of redundant execution (counterpart of the
    reference's ``RedundantRunner``).

    Built once by ``redundant.RedundantEngine`` on ``backend="mesh"``:
    each rank places its shard of A and b (the residual's operands) and of
    the replicated (m, r, p, n) blocks, the slot axis whole on its worker
    (``Solver.red_factor_placements``), and prepares them on the mesh
    (``redundant._red_mesh_prepare``: the replicas as more worker blocks)
    unless factors are given.  Its step (``executor.History`` with the
    ``MeshContext``) reads this rank's (m_loc, r) selection weights from a
    static buffer: an ``executor.StepProgram``, captured once on NCCL (as
    the local engine's is on the card) and eager on gloo.  ``run``
    re-enters it with a new schedule of the same shape: the schedule
    arrives lowered (on rank 0, broadcast: ``redundant._lowered``), so
    the ranks never disagree.  States go in and come out with GLOBAL
    shapes on every rank.
    """

    def __init__(self, solver, sys: BlockSystem, assign, prm, *, mesh=None,
                 worker_axes: Sequence[str] = ("data",),
                 model_axis: Optional[str] = "model", factors: Any = None):
        from . import redundant as red  # redundant.py imports this module

        if mesh is None:
            mesh = mesh_lib.solver_mesh_for(sys.m, device=sys.device)
        ctx = make_context(mesh, sys, worker_axes=worker_axes,
                           model_axis=model_axis)
        self.solver, self.assign, self.prm = solver, assign, prm
        self.mesh, self.ctx = mesh, ctx
        self.device = device = mesh_lib.mesh_device(mesh)
        fpl, spl = solver.mesh_placements()
        self._fpl = solver.red_factor_placements(fpl)
        self._spl = solver.red_state_placements(spl)
        holder = assign.holder
        self._A = _shard(sys.A_blocks, ("w", None, "n"), ctx, device)
        self._b = _shard(sys.b_blocks, ("w", None), ctx, device)
        b_rep = self._b_rep = _shard_replicated(sys.b_blocks, ("w", None),
                                                holder, ctx, device)
        if factors is None:
            A_rep = _shard_replicated(sys.A_blocks, ("w", None, "n"),
                                      holder, ctx, device)
            self._frep = red._red_mesh_prepare(solver, A_rep, prm, ctx)
        else:
            f = solver.mesh_factors(factors)
            self._frep = type(f)(*(
                _shard_replicated(v, p, holder, ctx, device)
                for v, p in zip(f, fpl)))
        xt = sys.x_true
        self._xt = None if xt is None else _shard(xt, ("n",), ctx, device)
        # this rank's selection weights, the static buffer the step reads
        W = b_rep.new_zeros(b_rep.shape[:2])

        def step(f_, b_, s_):
            return solver.red_step(f_, b_rep, s_, prm, W, ctx)

        self._program = executor.StepProgram(
            executor.History(step, solver.extract, self._frep, self._b,
                             self._A, x_true=self._xt, ctx=ctx),
            W, name=f"{solver.name}.redundant_mesh")

    @property
    def captures(self) -> int:
        """The step's CUDA graphs (one on NCCL, after the first run)."""
        return self._program.captures

    def init_state(self, warm_state, W_all):
        """A fresh on-mesh ``red_init`` (``warm_state`` None) or the
        placed ``red_expand`` of a GLOBAL-shape warm state, gathered to
        global shapes."""
        if warm_state is None:
            W = _shard(W_all, ("w", None), self.ctx, self.device)
            state = self.solver.red_init(self._frep, self._b_rep, self.prm,
                                         W, self.ctx)
            return _gather_tree(state, self._spl, self.ctx)
        return self.solver.red_expand(warm_state, self.assign)

    def run(self, state, W_seq):
        """One segment from the global ``state`` over the (T, m, r)
        schedule: ``(state, residuals (T,), errors (T,))``, replicated;
        every step a run of the one step program."""
        W_seq = _shard(torch.as_tensor(W_seq), (None, "w", None), self.ctx,
                       self.device).to(self._A.dtype)
        state = _shard_tree(state, self._spl, self.ctx, self.device)
        state, res, err = self._program.run(state, W_seq)
        return _gather_tree(state, self._spl, self.ctx), res, err

    def cache_size(self) -> int:
        """The step programs held: one after the first run, flat across
        segments."""
        return self._program.cache_size()
