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
batch dimension out where the reference vmaps).  The histories are
Python loops over the steps that keep every value on the device; the
host reads them once, at the end.  The loose-kwarg shim of the
reference (``_coerce_plan``) is ROADMAP item A18: ``plan=`` is the only
execution surface here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import blockops
from repro_torch.core.partition import BlockSystem
from repro_torch.solvers.capability import ExecutionPlan, resolve_plan

__all__ = ["Solver", "SolveResult", "iters_to_tolerance"]


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
    supports_kernel: bool = False  # hand-written kernel path available
    param_names: Tuple[str, ...] = ()
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
        """One iteration over a (k,)-batched RHS/state bundle."""
        raise NotImplementedError

    def extract(self, state: Any) -> torch.Tensor:
        """The global estimate x (n,) — or (k, n) — carried by ``state``."""
        raise NotImplementedError

    def step_residual(self, factors: Any, b: torch.Tensor, state: Any,
                      params: Dict[str, float]):
        raise NotImplementedError(
            f"solver {self.name!r} does not implement the fused residual")

    def step_many_residual(self, factors: Any, Bb: torch.Tensor,
                           states: Any, params: Dict[str, float]):
        raise NotImplementedError(
            f"solver {self.name!r} does not implement the fused residual")

    def analyze(self, sys: BlockSystem):
        """(auto-tuned params, theoretical rho or None) in ONE spectral
        pass."""
        return self.default_params(sys), None

    def kernel_factors(self, factors: Any) -> Any:
        """Augment factors with kernel-path precomputation (idempotent)."""
        return factors

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
                 prm: Dict[str, float]) -> Any:
        factors = plan.factors
        if factors is None:
            factors = self.prepare(sys.A_op, prm)
        if plan.kernel:
            factors = self.kernel_factors(factors)
        return factors

    def solve(self, sys: BlockSystem, *, iters: int = 1000, tol: float = 1e-6,
              plan: Optional[ExecutionPlan] = None,
              **params) -> SolveResult:
        """End-to-end solve: prepare -> init (or warm start) -> T steps.

        ``plan.kernel`` runs the worker update through the kernel pair and
        records the residual from the gather pass (the fused residual);
        ``plan.factors`` skips ``prepare``; ``plan.warm_state`` resumes.
        """
        plan = resolve_plan(self, sys, plan or ExecutionPlan(),
                            context="solve")
        prm = self.resolve_params(sys, **params)
        factors = self._factors(sys, plan, prm)
        state = (self.init(factors, sys.b_blocks, prm)
                 if plan.warm_state is None else plan.warm_state)
        step = lambda f, b, s: self.step(f, b, s, prm,      # noqa: E731
                                         use_kernel=plan.kernel)
        step_res = None
        if plan.kernel and self.supports_fused_residual and iters > 0:
            step_res = lambda f, b, s: self.step_residual(  # noqa: E731
                f, b, s, prm)
        state, res, err = _history_scan(step, self.extract, factors,
                                        sys.b_blocks, state, sys.A_op,
                                        sys.x_true, iters,
                                        step_residual=step_res)
        return SolveResult(
            name=self.name, x=self.extract(state), state=state,
            residuals=res, errors=err if sys.x_true is not None else None,
            params=prm, iters_to_tol=iters_to_tolerance(res, tol), tol=tol)

    def solve_many(self, sys: BlockSystem, B, *, iters: int = 1000,
                   tol: float = 1e-6, plan: Optional[ExecutionPlan] = None,
                   **params) -> SolveResult:
        """Batched multi-RHS solve sharing ONE ``prepare`` factorization.

        ``B`` is (k, N) — k right-hand sides for the same A.  Returns a
        batched SolveResult: x (k, n), residuals (k, T), errors None.
        """
        plan = resolve_plan(self, sys, plan or ExecutionPlan(),
                            context="solve_many")
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
        step_many_res = None
        if plan.kernel and self.supports_fused_residual and iters > 0:
            step_many_res = lambda f, bb, s: self.step_many_residual(  # noqa: E731,E501
                f, bb, s, prm)
        states, res = _history_scan_many(
            step_many, self.extract, factors, Bb, states, sys.A_op, iters,
            step_many_residual=step_many_res)
        return SolveResult(
            name=self.name, x=self.extract(states), state=states,
            residuals=res, errors=None, params=prm,
            iters_to_tol=iters_to_tolerance(res, tol), tol=tol)


# ---------------------------------------------------------------------------
# History drivers (Python loops; every record stays on the device)
# ---------------------------------------------------------------------------


def _stack(records, like: torch.Tensor) -> torch.Tensor:
    if not records:
        return like.new_zeros((0,))
    return torch.stack(records)


def _history_scan(step, extract, factors, b, state, A, x_true, iters: int,
                  step_residual=None):
    """Run ``step`` for ``iters`` iterations recording residual/error.

    Entry t is the residual ‖Ax−b‖/‖b‖ (and error ‖x−x*‖/‖x*‖) after step
    t+1.  ``step_residual(factors, b, state) -> (state, rsq)`` switches
    to the FUSED residual: each step harvests ‖Ax−b‖² of the state it
    consumed from its own gather pass, so the record of step t is the
    residual before it; the records shift by one and close with ONE
    true-A residual of the final state — the same indexing as the plain
    path.
    """
    b_norm = torch.sqrt(torch.sum(b * b))
    xt = x_true
    xt_norm = None if xt is None else torch.linalg.norm(xt)
    res, err = [], []
    for _ in range(iters):
        if step_residual is not None:
            state, rsq = step_residual(factors, b, state)
            res.append(torch.sqrt(rsq) / b_norm)
        else:
            state = step(factors, b, state)
            r = blockops.bmatvec(A, extract(state)) - b
            res.append(torch.sqrt(torch.sum(r * r)) / b_norm)
        if xt is not None:
            err.append(torch.linalg.norm(extract(state) - xt) / xt_norm)
    res = _stack(res, b)
    if step_residual is not None:
        r = blockops.bmatvec(A, extract(state)) - b
        final = torch.sqrt(torch.sum(r * r)) / b_norm
        res = torch.cat([res[1:], final[None]])
    err = res if xt is None else _stack(err, b)
    return state, res, err


def _history_scan_many(step_many, extract, factors, Bb, states, A,
                       iters: int, step_many_residual=None):
    """Batched variant: states/Bb carry a leading (k,) RHS axis; returns
    the (k, T) residual history (same lagged-shift contract as
    ``_history_scan`` for ``step_many_residual``)."""
    b_norms = torch.sqrt(torch.sum(Bb * Bb, dim=(1, 2)))

    def true_res(states):
        r = blockops.bmatvec_many(A, extract(states)) - Bb
        return torch.sqrt(torch.sum(r * r, dim=(1, 2))) / b_norms

    res = []
    for _ in range(iters):
        if step_many_residual is not None:
            states, rsq = step_many_residual(factors, Bb, states)
            res.append(torch.sqrt(rsq) / b_norms)
        else:
            states = step_many(factors, Bb, states)
            res.append(true_res(states))
    if not res:
        return states, Bb.new_zeros((Bb.shape[0], 0))
    res = torch.stack(res)                                   # (T, k)
    if step_many_residual is not None:
        res = torch.cat([res[1:], true_res(states)[None]])
    return states, res.T
