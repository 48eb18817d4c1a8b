"""DEPRECATED shim — straggler-tolerant execution moved to the registry
(counterpart of ``repro.core.coding``).

The r-redundant cyclic assignment, the selection weights and the
redundant solve driver live in ``repro_torch.solvers.redundant``, as an
option of the unified solver API::

    from repro_torch import solvers
    res = solvers.get("apc").solve(sys, plan=solvers.ExecutionPlan(
        redundancy=r, alive_schedule=lambda t: mask_t))

which runs the whole projection family (``apc``, ``consensus``,
``cimmino``) on both backends, with warm starts and checkpoints.  Kept
here: the legacy entry points as thin delegations.  ``solve_redundant``
has no ``seed`` parameter (the initialization is the deterministic
min-norm solution: there is nothing to seed).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .partition import BlockSystem


@dataclasses.dataclass(frozen=True)
class RedundantSystem:
    """Cyclic r-redundant replication of a BlockSystem.

    A_rep[i, k] = A_blocks[(i + k) % m]  for k in [0, r).
    """
    base: BlockSystem
    r: int
    A_rep: torch.Tensor    # (m, r, p, n)
    b_rep: torch.Tensor    # (m, r, p)

    @property
    def holder_of(self) -> np.ndarray:
        """(m, r) holder_of[i, k] = block id held in slot k of worker i."""
        from repro_torch.solvers.redundant import Assignment
        return Assignment(m=self.base.m, r=self.r).holder


def replicate(sys: BlockSystem, r: int) -> RedundantSystem:
    from repro_torch.solvers.redundant import Assignment, replicate_system
    if not (1 <= r <= sys.m):
        raise ValueError(f"redundancy r={r} must be in [1, m={sys.m}]")
    A_rep, b_rep = replicate_system(sys, Assignment(m=sys.m, r=r))
    return RedundantSystem(base=sys, r=r, A_rep=A_rep, b_rep=b_rep)


def selection_weights(alive: np.ndarray, m: int, r: int) -> np.ndarray:
    """Deprecated alias of ``repro_torch.solvers.redundant
    .selection_weights``."""
    from repro_torch.solvers.redundant import selection_weights as sw
    return sw(alive, m, r)


def solve_redundant(sys: BlockSystem, r: int, *, iters: int = 500,
                    gamma=None, eta=None, alive_schedule=None):
    """Deprecated shim over ``solvers.get("apc").solve(plan=
    ExecutionPlan(redundancy=r, ...))``: the legacy ``(xbar, residuals)``
    tuple, the residuals as numpy."""
    from repro_torch import solvers
    res = solvers.get("apc").solve(
        sys, iters=iters,
        plan=solvers.ExecutionPlan(redundancy=r,
                                   alive_schedule=alive_schedule),
        gamma=gamma, eta=eta)
    return res.x, res.residuals.cpu().numpy()
