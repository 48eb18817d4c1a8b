"""Per-solver capability declarations and the ExecutionPlan, checked ONCE
at dispatch (the local subset of ``repro.solvers.capability``).

A solver declares the system classes it supports::

    supports = frozenset({"square"})

and :func:`resolve_plan` checks the system and the plan against it before
any work happens.  The plan fields whose execution is not ported yet —
``backend="mesh"`` (ROADMAP A14) and ``redundancy > 1`` (A15) — raise
``NotImplementedError`` naming their item; they never degrade silently.
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
from typing import Any

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
    """The validated execution surface of one solve (local subset).

    ``kernel=True`` routes the worker update of apc, consensus and
    cimmino through the hand-written CUDA kernels (their plain PyTorch
    versions for tensors on the CPU).  ``warm_state`` resumes from a prior state;
    ``factors`` skips the one-time factorization; ``store`` (a
    ``FactorStore``) obtains it through the content-addressed cache.
    Plans are frozen: derive variants with :meth:`replace`.
    """

    backend: str = "local"
    kernel: bool = False
    precision: str = "default"
    redundancy: int = 1
    store: Any = None
    warm_state: Any = None
    factors: Any = None

    def __post_init__(self):
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
        The port's plan has no schedule and no mesh axes yet (ROADMAP
        A14, A15): those fields are False and the reference's default
        axes, ``("data",)`` and ``"model"``, which its local backend
        never reads, so a local plan's signature equals the reference's.
        Payload fields (store, warm_state, factors) are not part of it."""
        return (self.backend, self.kernel, self.precision,
                int(self.redundancy), False, ("data",), "model")


def resolve_plan(solver, sys, plan: ExecutionPlan, *,
                 context: str = "solve") -> ExecutionPlan:
    """Validate ``plan`` against ``solver``/``sys`` once, before any work;
    returns the plan with ``kernel`` resolved (:func:`resolve_use_kernel`).
    The order is the reference's: the sparse downgrade, then the
    precision check against the resolved flag."""
    check_capability(solver, sys, context=context)
    kernel = resolve_use_kernel(solver, sys, plan.kernel)
    solver._check_precision(plan.precision, kernel)
    if kernel != plan.kernel:
        plan = plan.replace(kernel=kernel)
    if plan.backend == "mesh":
        raise NotImplementedError(
            "backend='mesh' is not ported yet (ROADMAP A14)")
    if plan.backend != "local":
        raise ValueError(f"unknown backend {plan.backend!r}; "
                         "expected 'local' or 'mesh'")
    if plan.redundancy > 1:
        raise NotImplementedError(
            "redundant execution is not ported yet (ROADMAP A15)")
    if plan.kernel and not solver.supports_kernel:
        raise ValueError(f"solver {solver.name!r} has no kernel path "
                         f"(kernel=True unsupported)")
    return plan
