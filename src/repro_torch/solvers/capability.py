"""Per-solver capability declarations and the ExecutionPlan, checked ONCE
at dispatch (counterpart of ``repro.solvers.capability``).

A solver declares the system classes it supports::

    supports = frozenset({"square"})

and :func:`resolve_plan` checks the system and the plan against it before
any work happens.  ``backend="mesh"`` runs the solve sharded over a
``torch.distributed`` mesh (``solvers/mesh.py``); a mesh handed to the
local backend is the reference's ``ValueError``.  ``redundancy=r`` and
``alive_schedule=`` (``is_redundant``) run the straggler-tolerant
redundant path (``solvers/redundant.py``) on either backend; a redundant
``solve_many`` and the kernel path with redundancy raise the reference's
errors here, before any work.
``precision`` is checked as the reference checks it
(``Solver._check_precision``), after the kernel flag is resolved.  The
one downgrade is the reference's own, and it warns: ``kernel=True`` on a
sparse system for a solver without a kernel runs the unfused sparse
path.
"""
from __future__ import annotations

import dataclasses
import logging
import warnings
from typing import Any, Optional, Tuple

log = logging.getLogger(__name__)


class CapabilityError(ValueError):
    """A solver was dispatched on a system class it does not support."""


def required_capabilities(sys) -> set:
    """The capability set a system demands of its solver."""
    need = {sys.mode}
    if sys.is_sparse:
        need.add("sparse")
    return need


def check_capability(solver, sys, *, context: str = "solve") -> None:
    """Raise :class:`CapabilityError` unless ``solver`` declares every
    capability ``sys`` requires (its mode, plus sparsity)."""
    missing = required_capabilities(sys) - set(solver.supports)
    if missing:
        raise CapabilityError(
            f"solver {solver.name!r} does not support "
            f"{sorted(missing)} systems: {context} was called with a "
            f"mode={sys.mode!r}, structure={sys.structure!r} system but "
            f"{solver.name!r} declares supports="
            f"{sorted(solver.supports)}. Pick an LS/sparse-capable solver "
            f"(e.g. 'cimmino' or the gradient family) or densify/square "
            f"the system.")


def resolve_use_kernel(solver, sys, use_kernel: bool) -> bool:
    """The ``kernel`` flag that actually runs.

    A sparse system handed ``kernel=True`` on a solver with no kernel
    (dgd, dnag, dhbm, madmm) warns (``RuntimeWarning`` and a log line)
    and runs the unfused sparse path, as the reference does.  On a dense
    system the same request stays an error (:func:`resolve_plan`).
    """
    if use_kernel and sys.is_sparse and not solver.supports_kernel:
        msg = (f"use_kernel=True on a sparse system: solver "
               f"{solver.name!r} declares supports_kernel=False (no "
               f"kernel); falling back to the unfused sparse path")
        warnings.warn(msg, RuntimeWarning, stacklevel=4)
        log.warning(msg)
        return False
    return use_kernel


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """The validated execution surface of one solve.

    ``kernel=True`` routes the worker update of apc, consensus and
    cimmino through the hand-written CUDA kernels (their plain PyTorch
    versions for tensors on the CPU).  ``backend="mesh"`` shards the
    solve over ``mesh`` (a ``DeviceMesh``; None builds one over the
    process group), the row blocks over ``worker_axes`` and n over
    ``model_axis``.  ``warm_state`` resumes from a prior state;
    ``factors`` skips the one-time factorization; ``store`` (a
    ``FactorStore``) obtains it through the content-addressed cache.
    ``redundancy=r`` replicates the row blocks r-redundantly and
    ``alive_schedule`` (a callable t -> (m,) mask, an (m,) or (T, m) mask
    array, or a ``runtime.fault.HeartbeatMonitor``) names the workers that
    answer each iteration (``solvers/redundant.py``).  Plans are frozen:
    derive variants with :meth:`replace`.
    """

    backend: str = "local"
    kernel: bool = False
    precision: str = "default"
    redundancy: int = 1
    worker_axes: Tuple[str, ...] = ("data",)
    model_axis: Optional[str] = "model"
    # payload fields
    mesh: Any = None
    alive_schedule: Any = None
    store: Any = None
    warm_state: Any = None
    factors: Any = None

    def __post_init__(self):
        object.__setattr__(self, "worker_axes", tuple(self.worker_axes))
        object.__setattr__(self, "kernel", bool(self.kernel))
        if not isinstance(self.redundancy, int) or self.redundancy < 1:
            raise ValueError(
                f"ExecutionPlan.redundancy must be an int >= 1, got "
                f"{self.redundancy!r}")

    def replace(self, **changes) -> "ExecutionPlan":
        """A copy with ``changes`` applied (plans are immutable)."""
        return dataclasses.replace(self, **changes)

    def signature(self) -> tuple:
        """Hashable dispatch identity: which compiled program this plan
        selects, the reference's tuple (``backend, kernel, precision,
        redundancy, has an alive schedule, worker axes, model axis``).
        Payload fields (mesh, store, warm_state, factors and the schedule's
        values) are not part of it: only whether a schedule exists."""
        return (self.backend, self.kernel, self.precision,
                int(self.redundancy), self.alive_schedule is not None,
                self.worker_axes, self.model_axis)

    @property
    def is_redundant(self) -> bool:
        return self.redundancy != 1 or self.alive_schedule is not None


def resolve_plan(solver, sys, plan: ExecutionPlan, *,
                 context: str = "solve") -> ExecutionPlan:
    """Validate ``plan`` against ``solver``/``sys`` once, before any work;
    returns the plan with ``kernel`` resolved (:func:`resolve_use_kernel`).
    The order is the reference's: the sparse downgrade, the precision
    check against the resolved flag, the backend, the kernel, then the
    redundancy conflicts (a redundant ``solve_many``; the kernel path with
    redundancy, a :class:`CapabilityError`)."""
    check_capability(solver, sys, context=context)
    kernel = resolve_use_kernel(solver, sys, plan.kernel)
    solver._check_precision(plan.precision, kernel)
    if kernel != plan.kernel:
        plan = plan.replace(kernel=kernel)
    if plan.backend == "local":
        if plan.mesh is not None:
            raise ValueError("a mesh was passed but backend is 'local' "
                             "— did you mean backend='mesh'?")
    elif plan.backend != "mesh":
        raise ValueError(f"unknown backend {plan.backend!r}; "
                         "expected 'local' or 'mesh'")
    if plan.kernel and not solver.supports_kernel:
        raise ValueError(f"solver {solver.name!r} has no kernel path "
                         f"(kernel=True unsupported)")
    if plan.is_redundant:
        if context.startswith("solve_many"):
            # fail loudly rather than run the batch without the straggler
            # tolerance it asked for
            raise ValueError(
                "redundant execution is not supported by solve_many; run "
                "solve(redundancy=..., alive_schedule=...) per right-hand "
                "side, or batch without redundancy")
        if plan.kernel:
            fields = [f"redundancy={plan.redundancy}"]
            if plan.alive_schedule is not None:
                fields.append("alive_schedule=<set>")
            raise CapabilityError(
                f"solver {solver.name!r} cannot run kernel=True "
                f"(use_kernel=True) together with {', '.join(fields)}: "
                f"the coded replicated (m, r, p, n) layout has no CUDA "
                f"kernel. Drop kernel=True to keep the straggler "
                f"tolerance, or drop redundancy=/alive_schedule= to keep "
                f"the kernels.")
    return plan
