"""The APC solver (counterpart of ``repro.solvers.projection.APCSolver``).

Shares the per-worker null-space projection of ``core/apc.py`` (Gram
Cholesky factors, P_i v = v − A_iᵀ G_i⁻¹ A_i v), runs the kernel path
(``kernel=True``: the CUDA ``apc_gather``/``apc_scatter`` pair on the
card, their plain versions on the CPU) and auto-tunes (gamma, eta) from
the Theorem-1 spectral analysis of X when none are given.  Consensus and
Cimmino are ROADMAP A6.

Every hook is batch-polymorphic: states may carry a leading (k,) RHS
axis — x (k, m, n), x̄ (k, n) — so ``step_many`` is ``step`` on a batched
state and ONE launch of each kernel serves all k rows and m workers.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import apc as apc_core
from repro_torch.core import spectral
from repro_torch.core.apc import APCState, _gram_chol, _gram_solve
from repro_torch.core.partition import BlockSystem
from repro_torch.kernels import ops as kops

from .api import Solver
from .registry import register


class ProjFactors(NamedTuple):
    """b-independent per-worker factors (leading axis = worker)."""
    A: torch.Tensor       # (m, p, n) row blocks
    chol: torch.Tensor    # (m, p, p) Cholesky of Gram A_i A_i^T
    B: Optional[torch.Tensor] = None  # (m, n, p) pinv factors A_iᵀ G_i⁻¹,
                                      # contiguous (kernel path only)


def _proj_prepare(A: torch.Tensor, jitter: float) -> ProjFactors:
    return ProjFactors(A=A, chol=_gram_chol(A, jitter))


def _with_pinv(factors: ProjFactors) -> ProjFactors:
    """Precompute B_i = A_iᵀ G_i⁻¹ once (iteration-invariant); idempotent."""
    if factors.B is not None:
        return factors
    B = torch.cholesky_solve(factors.A, factors.chol)      # (m, p, n)
    return factors._replace(B=B.transpose(-1, -2).contiguous())


def _min_norm_solutions(factors: ProjFactors,
                        b: torch.Tensor) -> torch.Tensor:
    """x0_i = A_iᵀ (A_i A_iᵀ)⁻¹ b_i — the min-norm local solutions, for b
    (m, p) or a batch (k, m, p)."""
    return torch.einsum("mpn,...mp->...mn", factors.A,
                        _gram_solve(factors.chol, b))


@register("apc")
class APCSolver(Solver):
    """Accelerated Projection-based Consensus (paper Algorithm 1)."""

    supports_kernel = True
    param_names = ("gamma", "eta")
    # the paper's convergence theory (Theorem 1) assumes an exact solution
    # exists; sparse blocks are ROADMAP A9
    supports = frozenset({"square"})
    # The iterates satisfy A_i x_i = b_i exactly (min-norm init, kept by
    # the projection since A_i B_i = I), so the gather result
    # u_i = A_i(x̄ − x_i) IS the residual block A_i x̄ − b_i of the consumed
    # state: the history needs no second read of A per iteration.
    supports_fused_residual = True

    def default_params(self, sys: BlockSystem):
        return self.analyze(sys)[0]

    def analyze(self, sys: BlockSystem):
        X = spectral.x_matrix(sys)
        prm = spectral.apc_optimal(*spectral.mu_extremes(X))
        return {"gamma": prm.gamma, "eta": prm.eta}, prm.rho

    def prepare(self, A, params):
        return _proj_prepare(A, params.get("jitter", 0.0))

    def kernel_factors(self, factors):
        return _with_pinv(factors)

    def init(self, factors, b, params):
        x0 = _min_norm_solutions(factors, b)
        return APCState(x=x0, xbar=x0.mean(dim=-2), t=0)

    def _step_u(self, factors, state, gamma, use_kernel):
        """The worker update (Eq. 2a) and its gather result u, in the
        state's layout.  The kernel path hands the kernels the (m, k, n)
        view of a batched (k, m, n) iterate — a transpose, not a copy."""
        if not use_kernel:
            return apc_core.worker_update(factors.A, factors.chol, state,
                                          gamma)
        factors = _with_pinv(factors)
        batched = state.x.dim() == 3
        X = state.x.transpose(0, 1) if batched else state.x
        u = kops.proj_gather(factors.A, X, state.xbar)
        x_new = kops.proj_scatter(factors.B, X, state.xbar, u, gamma)
        if batched:
            return x_new.transpose(0, 1), u.transpose(0, 1)
        return x_new, u

    def step(self, factors, b, state, params, *, use_kernel=False):
        x_new, _ = self._step_u(factors, state, params["gamma"], use_kernel)
        return apc_core.master_update(x_new, state, params["eta"])

    def step_many(self, factors, Bb, states, params, *, use_kernel=False):
        """``step`` on a batched (k, m, n) state: one kernel launch each
        for the whole batch."""
        return self.step(factors, Bb, states, params, use_kernel=use_kernel)

    def step_residual(self, factors, b, state, params):
        """(new state, ‖A x̄ − b‖² of the consumed state) — the kernel
        path whenever the factors carry B, as in the reference."""
        x_new, u = self._step_u(factors, state, params["gamma"],
                                factors.B is not None)
        return (apc_core.master_update(x_new, state, params["eta"]),
                torch.sum(u * u, dim=(-2, -1)))

    def step_many_residual(self, factors, Bb, states, params):
        return self.step_residual(factors, Bb, states, params)

    def extract(self, state):
        return state.xbar
