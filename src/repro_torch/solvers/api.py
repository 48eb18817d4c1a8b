"""The solver API of the port: one lifecycle, one result type.

Counterpart of ``repro.solvers.api`` (local backend).  Every solver
implements

    factors = solver.prepare(A_blocks, params)   # one-time, b-INDEPENDENT
    state   = solver.init(factors, b_blocks, params)
    state   = solver.step(factors, b_blocks, state, params)

and inherits the shared drivers

    solver.solve(sys, iters=..., plan=ExecutionPlan(...), **params)
    solver.solve_many(sys, B, iters=..., plan=..., **params)

``prepare`` never looks at the right-hand side, so ``solve_many`` shares
one factorization across a batch.  ``init`` and ``step`` accept states
and right-hand sides with a leading (k,) batch axis (the port writes the
batch dimension out where the reference vmaps).  The histories run
through ``executor.run_history``: on the card the step loop is captured
into a CUDA graph and replayed, as the reference compiles its
``lax.scan``; every record stays on the device, and the host reads them
once, at the end.  ``plan=`` is the execution surface; the reference's
loose execution kwargs (``use_kernel=``, ``warm_state=``, ...) survive as
its deprecation shim, :func:`_coerce_plan`.

``ExecutionPlan(backend="mesh", mesh=...)`` runs the same lifecycle
sharded over the ranks of a ``torch.distributed`` mesh
(``solvers/mesh.py``) through the ``mesh_*`` hooks below: the row blocks
over the worker axes, n optionally over the model axis, every master
update a sum over the workers.  The least-squares hooks are written once
against that psum contract and run locally with :data:`LOCAL_PSUM`, and
so are the ``red_*`` hooks of redundant execution
(``ExecutionPlan(redundancy=r, alive_schedule=...)``,
``solvers/redundant.py``), on either backend.
"""
from __future__ import annotations

import dataclasses
import logging
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import blockops
from repro_torch.core.partition import BlockSystem
from repro_torch.solvers import executor
from repro_torch.solvers.capability import ExecutionPlan, resolve_plan

__all__ = ["LOCAL_PSUM", "Solver", "SolveResult", "iters_to_tolerance"]

log = logging.getLogger(__name__)

_UNSET = object()     # sentinel distinguishing "not passed" from None

# legacy kwarg -> ExecutionPlan field (the use_kernel rename is the only
# non-identity entry); everything here goes through the deprecation shim
_LEGACY_PLAN_KWARGS = {
    "use_kernel": "kernel", "precision": "precision",
    "warm_state": "warm_state", "factors": "factors", "store": "store",
    "backend": "backend", "mesh": "mesh", "worker_axes": "worker_axes",
    "model_axis": "model_axis", "redundancy": "redundancy",
    "alive_schedule": "alive_schedule",
}

def _coerce_plan(plan: Optional[ExecutionPlan], legacy: Dict[str, Any],
                 *, context: str) -> ExecutionPlan:
    """Resolve the plan/legacy-kwarg split of a solve call (the
    reference's shim).

    Exactly one of the two surfaces may be used: an explicit ``plan=``
    wins, loose legacy kwargs build one and emit exactly ONE
    ``DeprecationWarning`` per call (however many were passed), and
    mixing the two is a ``ValueError``: silently merging would make the
    plan lie about what runs.
    """
    given = {k: v for k, v in legacy.items() if v is not _UNSET}
    if plan is not None:
        if given:
            raise ValueError(
                f"{context} was called with both plan= and the legacy "
                f"kwargs {sorted(given)}; put everything on the "
                f"ExecutionPlan")
        if not isinstance(plan, ExecutionPlan):
            raise TypeError(f"plan= must be an ExecutionPlan, got "
                            f"{type(plan).__name__}")
        return plan
    if not given:
        return ExecutionPlan()
    warnings.warn(
        f"passing {sorted(given)} to {context} as loose kwargs is "
        f"deprecated; build an ExecutionPlan and pass plan= instead "
        f"(e.g. plan=ExecutionPlan("
        + ", ".join(f"{_LEGACY_PLAN_KWARGS[k]}=..." for k in sorted(given))
        + "))", DeprecationWarning, stacklevel=3)
    return ExecutionPlan(**{_LEGACY_PLAN_KWARGS[k]: v
                            for k, v in given.items()})


#: the identity psum context of the local backend
LOCAL_PSUM = executor.LOCAL_PSUM


@dataclasses.dataclass(frozen=True)
class SolveResult:
    """Unified result record returned by every registered solver.

    For ``solve_many`` the leading axis of ``x`` / ``residuals`` /
    ``iters_to_tol`` is the RHS batch and ``errors`` is None.
    """
    name: str                         # registry key of the solver that ran
    x: torch.Tensor                   # final global estimate (n,) or (k, n)
    state: Any                        # full solver state (warm start)
    residuals: torch.Tensor           # (T,) or (k, T)  ||Ax-b|| / ||b||
    errors: Optional[torch.Tensor]    # (T,) ||x-x*||/||x*|| if x_true given
    params: Dict[str, float]          # hyper-parameters actually used
    iters_to_tol: Any = -1            # first 1-based iter with residual <
                                      # tol; -1 means "never reached" (int
                                      # for solve, (k,) array for
                                      # solve_many — the same sentinel)
    tol: float = 1e-6                 # tolerance iters_to_tol was computed at

    def iters_to(self, tol: float):
        """Iterations needed to push the residual below ``tol``."""
        return iters_to_tolerance(self.residuals, tol)


def iters_to_tolerance(residuals, tol: float):
    """First 1-based iteration whose residual is < tol; -1 = never reached.

    Returns an int for a (T,) history and a (k,) int array for a batched
    (k, T) history — the never-reached sentinel is -1 in both cases.
    """
    if isinstance(residuals, torch.Tensor):
        residuals = residuals.detach().cpu().numpy()
    r = np.asarray(residuals)
    hit = r < tol
    if r.ndim == 1:
        return int(np.argmax(hit)) + 1 if hit.any() else -1
    first = np.argmax(hit, axis=-1) + 1
    return np.where(hit.any(axis=-1), first, -1)


class Solver:
    """Base class / protocol for every registered solver."""

    name: str = "solver"
    paper_name: str = ""           # display name used in the paper's tables
    supports_kernel: bool = False  # hand-written kernel path available
    param_names: Tuple[str, ...] = ()
    # True when a prior state warm-starts a PERTURBED right-hand side
    # (the state holds no b-dependent cache); read by serving (ROADMAP A13)
    warm_rhs_ok: bool = False
    # System classes this solver handles; checked at dispatch against the
    # system's (mode, structure) — see solvers/capability.py.
    supports: frozenset = frozenset({"square"})
    # A solver whose kernel gather pass already yields the consumed
    # state's residual blocks sets this and implements ``step_residual``
    # (returning ``(new_state, rsq)``, rsq the squared residual norm of
    # the state the step CONSUMED, scalar or (k,)).  The history drivers
    # then record ‖Ax−b‖ without a second read of A per iteration: the
    # lagged records shift by one and close with one true-A residual.
    supports_fused_residual: bool = False
    # True when ``prepare`` is per-block independent and every factor
    # leaf carries the leading worker axis (``FactorStore``'s block tier)
    supports_block_store: bool = False
    # True for the projection family, which implements the ``red_*``
    # hooks of redundant execution (solvers/redundant.py)
    supports_redundancy: bool = False
    # A solver that can rebuild a valid state for a NEW partition from
    # the global estimate alone sets this and implements ``lift_state``:
    # the cross-partition warm start of the elastic runtime.  States are
    # global-SHAPED, but their per-block invariants (APC's A_i x_i = b_i)
    # belong to one partition, so a plain warm start across a repartition
    # would be wrong.
    supports_lift: bool = False

    # ----- lifecycle hooks (override) -------------------------------------
    def default_params(self, sys: BlockSystem) -> Dict[str, float]:
        """Analysis-time auto-tuning (Theorem 1 closed forms)."""
        return {}

    def prepare(self, A: torch.Tensor, params: Dict[str, float]) -> Any:
        """One-time factorization from the (m, p, n) row blocks only."""
        raise NotImplementedError

    def init(self, factors: Any, b: torch.Tensor,
             params: Dict[str, float]) -> Any:
        """Initial state for right-hand side blocks ``b`` of shape (m, p)
        or a batch (k, m, p)."""
        raise NotImplementedError

    def step(self, factors: Any, b: torch.Tensor, state: Any,
             params: Dict[str, float], *, use_kernel: bool = False) -> Any:
        """One synchronous iteration (all workers + master)."""
        raise NotImplementedError

    def step_many(self, factors: Any, Bb: torch.Tensor, states: Any,
                  params: Dict[str, float], *,
                  use_kernel: bool = False) -> Any:
        """One iteration over a (k,)-batched RHS/state bundle: ``step`` on
        the batched state (every hook is batch-polymorphic), so the kernel
        path is ONE launch of each kernel for all k rows."""
        return self.step(factors, Bb, states, params, use_kernel=use_kernel)

    def extract(self, state: Any) -> torch.Tensor:
        """The global estimate x (n,) — or (k, n) — carried by ``state``."""
        raise NotImplementedError

    def step_residual(self, factors: Any, b: torch.Tensor, state: Any,
                      params: Dict[str, float]):
        raise NotImplementedError(
            f"solver {self.name!r} does not implement the fused residual")

    def step_many_residual(self, factors: Any, Bb: torch.Tensor,
                           states: Any, params: Dict[str, float]):
        """``step_residual`` on the batched state; rsq is (k,)."""
        return self.step_residual(factors, Bb, states, params)

    def analyze(self, sys: BlockSystem):
        """(auto-tuned params, theoretical rho or None) in ONE spectral
        pass."""
        return self.default_params(sys), None

    def theoretical_rate(self, sys: BlockSystem) -> Optional[float]:
        """Closed-form optimal spectral radius rho, if known (Table 1):
        ``analyze``'s."""
        return self.analyze(sys)[1]

    def kernel_factors(self, factors: Any) -> Any:
        """Augment factors with kernel-path precomputation (idempotent)."""
        return factors

    def resolve_engine(self, factors: Any, k: int,
                       dtype: torch.dtype) -> None:
        """Resolve every engine and tile verdict the kernel path's steps
        on ``factors`` with k right-hand sides in ``dtype`` read
        (``kernels.ops.use_fused``, ``pick_tiles``), measuring where they
        measure: called before a build or capture, so a captured step
        reads only their caches.  Solvers without a kernel have none."""

    # ----- mixed-precision matrix streams ----------------------------------
    def cast_factors(self, factors: Any, precision: str) -> Any:
        """The factors with the kernels' matrix streams in the storage
        precision.

        ``precision="mixed"`` stores the streamed A/B (or vals/Bvals) in
        bfloat16 while every kernel contraction accumulates in the
        working dtype and the Cholesky factors stay in it.  Idempotent.
        """
        if precision == "default":
            return factors
        raise NotImplementedError(
            f"solver {self.name!r} does not implement precision="
            f"{precision!r}")

    def _check_precision(self, precision: str, use_kernel: bool) -> None:
        if precision == "default":
            return
        if precision != "mixed":
            raise ValueError(f"unknown precision {precision!r}; expected "
                             f"'default' or 'mixed'")
        if not (use_kernel and self.supports_kernel):
            raise ValueError(
                "precision='mixed' casts the kernels' matrix streams "
                "(bf16 storage, accumulation in the working dtype) and "
                "therefore requires use_kernel=True on a kernel-capable "
                f"solver; {self.name!r} was dispatched with use_kernel="
                f"{use_kernel} (supports_kernel={self.supports_kernel})")

    # ----- least-squares mode hooks ---------------------------------------
    # A solver declaring "least_squares" in ``supports`` implements both.
    # ``ls_moment`` is its optimality map, the (weighted) normal-equation
    # residual its fixed point zeroes: Aᵀ(Ax−b) for the gradient family,
    # Σ_i A_iᵀG_i⁻¹(A_i x−b_i) for Cimmino.  LS-mode histories record
    # ‖ls_moment(x)‖ / ‖ls_moment(0)‖, and ``iters_to_tol`` keys off it.

    def ls_moment(self, factors: Any, A, b: torch.Tensor, x: torch.Tensor,
                  params: Dict[str, float], ctx=LOCAL_PSUM) -> torch.Tensor:
        """The (..., n) optimality vector this solver drives to zero, for
        x (n,) / b (m, p) or a batch x (k, n) / b (k, m, p); on the mesh,
        from local shards, summed through ``ctx``."""
        raise NotImplementedError(
            f"solver {self.name!r} does not support least-squares mode")

    def ls_reference(self, sys: BlockSystem) -> torch.Tensor:
        """The (n,) solution this solver converges to on an inconsistent
        system: what ``errors`` compares against when ``sys.x_true`` is
        absent."""
        raise NotImplementedError(
            f"solver {self.name!r} does not support least-squares mode")

    def _ls_residual_fn(self, sys: BlockSystem, factors: Any,
                        prm: Dict[str, float], b: torch.Tensor):
        """The LS-mode residual ``x -> ‖ls_moment(x)‖/‖ls_moment(0)‖`` for
        right-hand sides b (scalar, or (k,) for a batch), or None in
        square mode; the denominator is taken once."""
        if sys.mode != "least_squares":
            return None
        return self._ls_residual(sys.A_op, factors, prm, b)

    def _ls_residual(self, A, factors: Any, prm: Dict[str, float],
                     b: torch.Tensor, ctx=LOCAL_PSUM):
        """``x -> ‖ls_moment(x)‖/‖ls_moment(0)‖`` on the blocks ``A`` (on
        the mesh, this rank's shards, summed through ``ctx``)."""
        def optim(x):
            mom = self.ls_moment(factors, A, b, x, prm, ctx=ctx)
            return torch.sqrt(ctx.psum_model(torch.sum(mom * mom, dim=-1)))

        zero = optim(b.new_zeros(b.shape[:-2] + (blockops.ncols(A),)))
        return lambda x: optim(x) / zero

    # ----- mesh-backend hooks (solvers/mesh.py) -----------------------------
    # Every array argument is this rank's shard (the worker axis and, with
    # a model axis, n cut); sums across shards go through the
    # ``MeshContext`` (``ctx.psum_workers``, ``ctx.psum_model``).  Like the
    # local hooks, they take a leading (k,) RHS batch.

    def mesh_placements(self, use_kernel: bool = False):
        """(factor placements, state placements): trees of the factors'
        and the state's structure whose leaves are placement tuples —
        ``"w"`` for the axis the workers shard, ``"n"`` for the column
        axis, None for a whole one (the reference's PartitionSpecs)."""
        raise NotImplementedError(
            f"solver {self.name!r} does not implement the mesh backend")

    def mesh_factors(self, factors: Any, use_kernel: bool = False) -> Any:
        """Global factors as the mesh takes them (host-only fields
        stripped; the kernel path's pinv factors ensured)."""
        return factors

    def mesh_prepare(self, A, params: Dict[str, float], ctx,
                     use_kernel: bool = False) -> Any:
        """On-mesh ``prepare`` from the local (m_loc, p, n_loc) shard."""
        raise NotImplementedError(
            f"solver {self.name!r} does not implement the mesh backend")

    def mesh_init(self, factors: Any, b: torch.Tensor,
                  params: Dict[str, float], ctx) -> Any:
        """On-mesh ``init``: ``init`` itself wherever it sums nothing
        across shards."""
        return self.init(factors, b, params)

    def mesh_step(self, factors: Any, b: torch.Tensor, state: Any,
                  params: Dict[str, float], ctx, *,
                  use_kernel: bool = False) -> Any:
        """One iteration on local shards (collectives through ``ctx``)."""
        raise NotImplementedError(
            f"solver {self.name!r} does not implement the mesh backend")

    def mesh_step_residual(self, factors: Any, b: torch.Tensor, state: Any,
                           params: Dict[str, float], ctx):
        """``step_residual`` on local shards: (state, the GLOBAL squared
        residual of the consumed state)."""
        raise NotImplementedError(
            f"solver {self.name!r} does not implement the fused residual")

    def mesh_step_many(self, factors: Any, Bb: torch.Tensor, states: Any,
                       params: Dict[str, float], ctx, *,
                       use_kernel: bool = False) -> Any:
        """The batched mesh step: ``mesh_step`` on the batched state (one
        launch of each kernel for all k rows)."""
        return self.mesh_step(factors, Bb, states, params, ctx,
                              use_kernel=use_kernel)

    def mesh_step_many_residual(self, factors: Any, Bb: torch.Tensor,
                                states: Any, params: Dict[str, float], ctx):
        """``mesh_step_residual`` on the batched state; rsq is (k,)."""
        return self.mesh_step_residual(factors, Bb, states, params, ctx)

    # ----- redundancy hooks (solvers/redundant.py) --------------------------
    # Straggler-tolerant execution replicates the row blocks r-redundantly
    # (the cyclic assignment, worker i holds blocks i, ..., i+r-1 mod m)
    # and replaces the sum over the workers by a masked one that takes each
    # block exactly once.  ``red_init``/``red_step`` are written ONCE
    # against the psum contract: identities locally (``LOCAL_PSUM``), the
    # ``MeshContext``'s collectives on the mesh.  Factors and b grow a slot
    # axis, (m, r, ...); W is the (m, r) selection weight of an iteration.

    def red_factors(self, factors: Any, assign) -> Any:
        """Replicate b-independent factors along the cyclic assignment:
        every tensor leaf's leading worker axis gathered through
        ``assign.holder`` (right whenever every leaf is per-worker), in
        the contiguous layout whatever the leaf's own (a triangular solve
        rounds by its operand's layout, and factors from the store's block
        tier are stacked where ``prepare``'s Cholesky factors are
        column-major)."""
        def rep(f):
            if not isinstance(f, torch.Tensor):
                return f
            idx = torch.as_tensor(assign.holder, device=f.device)
            return f[idx].contiguous()
        return type(factors)(*map(rep, factors))

    def red_init(self, factors: Any, b: torch.Tensor,
                 params: Dict[str, float], W0, ctx) -> Any:
        """The initial state, with the replicated internal layout, from
        replicated factors/b and the all-alive selection weights ``W0``."""
        raise NotImplementedError(
            f"solver {self.name!r} does not implement redundant execution")

    def red_step(self, factors: Any, b: torch.Tensor, state: Any,
                 params: Dict[str, float], W, ctx) -> Any:
        """One masked iteration: every replica updates, the master sum
        takes each block once through ``W``."""
        raise NotImplementedError(
            f"solver {self.name!r} does not implement redundant execution")

    def red_expand(self, state: Any, assign) -> Any:
        """A plain global-shape state in the replicated internal layout
        (replicas are identical copies).  Default: the identity, for
        states with no per-block field."""
        return state

    def red_collapse(self, state: Any, assign) -> Any:
        """The inverse of ``red_expand``: the plain global shape, so warm
        starts and checkpoints cross redundant and plain runs."""
        return state

    def red_factor_placements(self, fpl: Any) -> Any:
        """The placements of replicated factors from the plain ones
        (``mesh_placements``' first): the slot axis, whole on its worker,
        after the worker axis."""
        return type(fpl)(*(None if p is None else (p[0], None) + tuple(p[1:])
                           for p in fpl))

    def red_state_placements(self, spl: Any) -> Any:
        """The placements of the replicated internal state from the plain
        ones (the default: the same; overridden where the state gains a
        slot axis)."""
        return spl

    def lift_state(self, factors: Any, b: torch.Tensor,
                   params: Dict[str, float], x: torch.Tensor) -> Any:
        """A state for THIS partition warm-started from the global
        estimate ``x`` of a differently partitioned run: every invariant
        ``init`` establishes holds, and ``extract`` gives (about) x."""
        raise NotImplementedError(
            f"solver {self.name!r} cannot lift a state across partitions "
            f"(supports_lift=False)")

    # ----- shared drivers --------------------------------------------------
    def resolve_params(self, sys: BlockSystem,
                       **overrides) -> Dict[str, float]:
        """Merge explicit overrides over the auto-tuned defaults; the
        spectral analysis is skipped when every parameter is pinned."""
        given = {k: v for k, v in overrides.items() if v is not None}
        if self.param_names and all(k in given for k in self.param_names):
            return given
        return {**self.default_params(sys), **given}

    def _factors(self, sys: BlockSystem, plan: ExecutionPlan,
                 prm: Dict[str, float], *, resume: bool = False) -> Any:
        """``plan.factors``, or the store's (``plan.store``: a
        content-addressed lookup, memory LRU and disk tier, counted as a
        resume miss when ``resume`` misses), or a fresh ``prepare``; then
        the kernel augmentation and the precision cast (both
        idempotent)."""
        factors = plan.factors
        if factors is None and plan.store is not None:
            factors = plan.store.factors(
                self, sys, use_kernel=plan.kernel, resume=resume,
                precision=plan.precision, **prm)
        elif factors is None:
            if resume:
                # a warm-start resume silently repaying the full
                # b-independent prepare is the cost a FactorStore exists
                # to amortize — make it visible
                log.info(
                    "solve(warm_state=...) without cached factors: "
                    "re-running the full prepare for %r (pass "
                    "ExecutionPlan(store=...) to count and amortize this "
                    "as a cache miss)", self.name)
            factors = self.prepare(sys.A_op, prm)
        if plan.kernel:
            factors = self.kernel_factors(factors)
        if plan.precision != "default":
            factors = self.cast_factors(factors, plan.precision)
        return factors

    def solve(self, sys: BlockSystem, *, iters: int = 1000, tol: float = 1e-6,
              plan: Optional[ExecutionPlan] = None,
              use_kernel: Any = _UNSET, precision: Any = _UNSET,
              warm_state: Any = _UNSET,
              factors: Any = _UNSET, store: Any = _UNSET,
              backend: Any = _UNSET, mesh: Any = _UNSET,
              worker_axes: Any = _UNSET, model_axis: Any = _UNSET,
              redundancy: Any = _UNSET, alive_schedule: Any = _UNSET,
              **params) -> SolveResult:
        """End-to-end solve: prepare -> init (or warm start) -> T steps.

        ``plan.kernel`` runs the worker update through the kernel pair and
        records the residual from the gather pass (the fused residual);
        ``plan.precision="mixed"`` stores its matrix streams in bfloat16
        (``cast_factors``, after ``kernel_factors`` and before ``init``);
        ``plan.factors`` skips ``prepare``; ``plan.store`` (a ``FactorStore``)
        turns it into a content-addressed lookup; ``plan.warm_state``
        resumes (a store miss then counts as a resume miss).
        In least-squares mode the history is the optimality residual
        (``ls_moment``), the fused residual is off, and ``errors`` are
        taken against ``ls_reference`` when ``sys.x_true`` is None.
        ``plan.redundancy``/``plan.alive_schedule`` (projection family,
        either backend) run the straggler-tolerant redundant path with the
        reference's exact semantics (``solvers/redundant.py``).
        The loose kwargs (``use_kernel=``, ``warm_state=``, ...) are the
        deprecated shim of :func:`_coerce_plan`.
        """
        plan = _coerce_plan(plan, dict(
            use_kernel=use_kernel, precision=precision,
            warm_state=warm_state, factors=factors, store=store,
            backend=backend, mesh=mesh, worker_axes=worker_axes,
            model_axis=model_axis, redundancy=redundancy,
            alive_schedule=alive_schedule), context="solve")
        plan = resolve_plan(self, sys, plan, context="solve")
        if plan.is_redundant:
            from . import redundant
            return redundant.solve_redundant(
                self, sys, r=plan.redundancy, iters=iters, tol=tol,
                alive_schedule=plan.alive_schedule,
                warm_state=plan.warm_state, factors=plan.factors,
                store=plan.store, backend=plan.backend, mesh=plan.mesh,
                worker_axes=plan.worker_axes, model_axis=plan.model_axis,
                **params)
        if plan.backend == "mesh":
            from . import mesh as mesh_backend
            return mesh_backend.solve_mesh(
                self, sys, mesh=plan.mesh, iters=iters, tol=tol,
                worker_axes=plan.worker_axes, model_axis=plan.model_axis,
                warm_state=plan.warm_state, factors=plan.factors,
                store=plan.store, use_kernel=plan.kernel,
                precision=plan.precision, **params)
        prm = self.resolve_params(sys, **params)
        factors = self._factors(sys, plan, prm,
                                resume=plan.warm_state is not None)
        state = (self.init(factors, sys.b_blocks, prm)
                 if plan.warm_state is None else plan.warm_state)
        step = lambda f, b, s: self.step(f, b, s, prm,      # noqa: E731
                                         use_kernel=plan.kernel)
        residual_fn = self._ls_residual_fn(sys, factors, prm, sys.b_blocks)
        xt = sys.x_true
        if xt is None and sys.mode == "least_squares":
            xt = self.ls_reference(sys)
        step_res = None
        if (plan.kernel and self.supports_fused_residual
                and residual_fn is None and iters > 0):
            step_res = lambda f, b, s: self.step_residual(  # noqa: E731
                f, b, s, prm)
        h = executor.History(step, self.extract, factors, sys.b_blocks,
                             sys.A_op, x_true=xt, residual_fn=residual_fn,
                             step_residual=step_res)
        state, res, err = executor.run_history(h, state, iters,
                                               name=f"{self.name}.solve")
        return SolveResult(
            name=self.name, x=self.extract(state), state=state,
            residuals=res, errors=err if xt is not None else None,
            params=prm, iters_to_tol=iters_to_tolerance(res, tol), tol=tol)

    def solve_many(self, sys: BlockSystem, B, *, iters: int = 1000,
                   tol: float = 1e-6, plan: Optional[ExecutionPlan] = None,
                   use_kernel: Any = _UNSET, precision: Any = _UNSET,
                   factors: Any = _UNSET, store: Any = _UNSET,
                   backend: Any = _UNSET,
                   mesh: Any = _UNSET, worker_axes: Any = _UNSET,
                   model_axis: Any = _UNSET,
                   redundancy: Any = _UNSET, alive_schedule: Any = _UNSET,
                   **params) -> SolveResult:
        """Batched multi-RHS solve sharing ONE ``prepare`` factorization.

        ``B`` is (k, N) — k right-hand sides for the same A.  Returns a
        batched SolveResult: x (k, n), residuals (k, T), errors None.
        The loose kwargs are the same deprecated shim as ``solve``'s.
        """
        plan = _coerce_plan(plan, dict(
            use_kernel=use_kernel, precision=precision, factors=factors,
            store=store, backend=backend, mesh=mesh,
            worker_axes=worker_axes, model_axis=model_axis,
            redundancy=redundancy, alive_schedule=alive_schedule),
            context="solve_many")
        plan = resolve_plan(self, sys, plan, context="solve_many")
        if plan.backend == "mesh":
            from . import mesh as mesh_backend
            return mesh_backend.solve_many_mesh(
                self, sys, B, mesh=plan.mesh, iters=iters, tol=tol,
                worker_axes=plan.worker_axes, model_axis=plan.model_axis,
                factors=plan.factors, store=plan.store,
                use_kernel=plan.kernel, precision=plan.precision, **params)
        B = torch.as_tensor(B, dtype=sys.b_blocks.dtype, device=sys.device)
        if B.ndim == 1:
            B = B[None, :]
        if B.shape[-1] != sys.N:
            raise ValueError(f"RHS batch has {B.shape[-1]} rows, "
                             f"need N={sys.N}")
        Bb = B.reshape(B.shape[0], sys.m, sys.p)
        prm = self.resolve_params(sys, **params)
        factors = self._factors(sys, plan, prm)
        states = self.init(factors, Bb, prm)
        step_many = lambda f, bb, s: self.step_many(        # noqa: E731
            f, bb, s, prm, use_kernel=plan.kernel)
        residual_fn = self._ls_residual_fn(sys, factors, prm, Bb)
        step_many_res = None
        if (plan.kernel and self.supports_fused_residual
                and residual_fn is None and iters > 0):
            step_many_res = lambda f, bb, s: self.step_many_residual(  # noqa: E731,E501
                f, bb, s, prm)
        h = executor.History(step_many, self.extract, factors, Bb,
                             sys.A_op, residual_fn=residual_fn,
                             step_residual=step_many_res, batched=True)
        states, res, _ = executor.run_history(
            h, states, iters, name=f"{self.name}.solve_many")
        return SolveResult(
            name=self.name, x=self.extract(states), state=states,
            residuals=res, errors=None, params=prm,
            iters_to_tol=iters_to_tolerance(res, tol), tol=tol)


# ---------------------------------------------------------------------------
# The eager history loops (what the captured histories are held to)
# ---------------------------------------------------------------------------


def _history_scan(step, extract, factors, b, state, A, x_true, iters: int,
                  residual_fn=None, step_residual=None):
    """The eager loop of ``iters`` steps recording residual/error
    (``executor.History`` for the records and the fused residual's
    shift): (state, residuals (T,), errors (T,))."""
    return executor.eager_history(executor.History(
        step, extract, factors, b, A, x_true=x_true,
        residual_fn=residual_fn, step_residual=step_residual), state, iters)


def _history_scan_many(step_many, extract, factors, Bb, states, A,
                       iters: int, residual_fn=None,
                       step_many_residual=None):
    """Batched variant: states/Bb carry a leading (k,) RHS axis; returns
    (states, the (k, T) residual history)."""
    states, res, _ = executor.eager_history(executor.History(
        step_many, extract, factors, Bb, A, residual_fn=residual_fn,
        step_residual=step_many_residual, batched=True), states, iters)
    return states, res
