"""Per-solver capability declarations and the ExecutionPlan, checked ONCE
at dispatch (the local subset of ``repro.solvers.capability``).

A solver declares the system classes it supports::

    supports = frozenset({"square"})

and :func:`resolve_plan` checks the system and the plan against it before
any work happens.  The plan fields whose execution is not ported yet —
``store`` (ROADMAP A12), ``backend="mesh"`` (A14), ``redundancy > 1``
(A15) and ``precision="mixed"`` (A10) — raise ``NotImplementedError``
naming their item; they never degrade silently.
"""
from __future__ import annotations

import dataclasses
from typing import Any

PRECISIONS = ("default", "mixed")


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
            f"{sorted(solver.supports)}.")


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """The validated execution surface of one solve (local subset).

    ``kernel=True`` routes the worker update through the hand-written
    CUDA ``apc_gather``/``apc_scatter`` pair (their plain PyTorch versions
    for tensors on the CPU).  ``warm_state`` resumes from a prior state;
    ``factors`` skips the one-time factorization.
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


def resolve_plan(solver, sys, plan: ExecutionPlan, *,
                 context: str = "solve") -> ExecutionPlan:
    """Validate ``plan`` against ``solver``/``sys`` once, before any work."""
    check_capability(solver, sys, context=context)
    if plan.backend == "mesh":
        raise NotImplementedError(
            "backend='mesh' is not ported yet (ROADMAP A14)")
    if plan.backend != "local":
        raise ValueError(f"unknown backend {plan.backend!r}; "
                         "expected 'local' or 'mesh'")
    if plan.precision == "mixed":
        raise NotImplementedError(
            "precision='mixed' is not ported yet (ROADMAP A10)")
    if plan.precision not in PRECISIONS:
        raise ValueError(f"unknown precision {plan.precision!r}; expected "
                         f"'default' or 'mixed'")
    if plan.redundancy > 1:
        raise NotImplementedError(
            "redundant execution is not ported yet (ROADMAP A15)")
    if plan.store is not None:
        raise NotImplementedError(
            "the factor store is not ported yet (ROADMAP A12)")
    if plan.kernel and not solver.supports_kernel:
        raise ValueError(f"solver {solver.name!r} has no kernel path "
                         f"(kernel=True unsupported)")
    return plan
