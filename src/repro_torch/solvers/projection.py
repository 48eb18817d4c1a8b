"""The projection family: APC, consensus and block Cimmino (counterpart
of ``repro.solvers.projection``, local backend, dense and sparse blocks).

APC shares the per-worker null-space projection of ``core/apc.py`` (Gram
Cholesky factors, P_i v = v − A_iᵀ G_i⁻¹ A_i v) and auto-tunes (gamma,
eta) from the Theorem-1 spectral analysis of X when none are given;
consensus is APC with gamma = eta = 1; Cimmino sums the row projections
A_iᵀ G_i⁻¹ (b_i − A_i x̄) into x̄.  ``kernel=True`` runs the worker update
through the CUDA kernels on the card (APC and consensus:
``apc_gather``/``apc_scatter``; Cimmino: ``cimmino_gather``/
``cimmino_scatter``; on sparse systems ``sparse_gather``/
``sparse_cimmino_gather``/``sparse_scatter`` over the compressed
support), and through their plain versions on the CPU, wherever the
engine verdict (``kernels.ops.use_fused``, the reference's dispatch)
says fused; where it says unfused, the step is the unfused one, bit for
bit.  ``precision="mixed"`` stores the kernels' A and B in bfloat16
(``cast_factors``).

Every hook is batch-polymorphic: states may carry a leading (k,) RHS
axis — x (k, m, n), x̄ (k, n), b (k, m, p) — so ``step_many`` is ``step``
on a batched state and ONE launch of each kernel serves all k rows and m
workers.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import apc as apc_core
from repro_torch.core import blockops
from repro_torch.core import spectral
from repro_torch.core.apc import APCState, _gram_chol, _gram_solve
from repro_torch.core.partition import BlockSystem
from repro_torch.kernels import ops as kops

from .api import Solver
from .registry import register


class ProjFactors(NamedTuple):
    """b-independent per-worker factors (leading axis = worker)."""
    A: object             # (m, p, n) row blocks, or a blockops.SparseBlocks
    chol: torch.Tensor    # (m, p, p) Cholesky of Gram A_i A_i^T
    B: Optional[torch.Tensor] = None  # pinv factors A_iᵀ G_i⁻¹, contiguous
                                      # (kernel path only): (m, n, p)
                                      # dense, (m, w, p) on the support of
                                      # a SparseBlocks operand


def _proj_prepare(A, jitter: float) -> ProjFactors:
    """The Gram Cholesky factors; a sparse operand's Gram comes from its
    compressed values (exact: padded columns carry zeros)."""
    return ProjFactors(A=A, chol=_gram_chol(
        A.vals if blockops.is_sparse(A) else A, jitter))


def _with_pinv(factors: ProjFactors) -> ProjFactors:
    """Precompute B_i = A_iᵀ G_i⁻¹ once (iteration-invariant); idempotent.

    A sparse operand gets the support-compressed factor Bvals_i =
    (G_i⁻¹ vals_i)ᵀ, (m, w, p) on the same ``cols``: a padded slot's zero
    vals column gives an exactly zero Bvals row.
    """
    if factors.B is not None:
        return factors
    A = factors.A.vals if blockops.is_sparse(factors.A) else factors.A
    B = torch.cholesky_solve(A, factors.chol)              # (m, p, n|w)
    return factors._replace(B=B.transpose(-1, -2).contiguous())


def _cast_proj_factors(factors: ProjFactors, precision: str) -> ProjFactors:
    """``precision="mixed"``: bfloat16 storage for the streamed A (or a
    ``SparseBlocks``' vals) and B.

    The Cholesky factors stay in the working dtype, and the kernels
    accumulate every contraction in the dtype of x (float64 on the main
    path: the A/B stream goes from 8 bytes an element to 2).  Every
    consumer of the cast blocks promotes them back to x's dtype, so
    ``init`` and the steps run on the bf16-rounded A, as the reference's
    do.  Idempotent.
    """
    if precision == "default":
        return factors
    bf16 = torch.bfloat16
    if blockops.is_sparse(factors.A):
        A = factors.A._replace(vals=factors.A.vals.to(bf16))
    else:
        A = factors.A.to(bf16)
    B = None if factors.B is None else factors.B.to(bf16)
    return ProjFactors(A=A, chol=factors.chol, B=B)


def _min_norm_solutions(factors: ProjFactors,
                        b: torch.Tensor) -> torch.Tensor:
    """x0_i = A_iᵀ (A_i A_iᵀ)⁻¹ b_i — the min-norm local solutions, for b
    (m, p) or a batch (k, m, p)."""
    return blockops.brmatvec(factors.A, _gram_solve(factors.chol, b))


def _fused(family: str, A, k: int, dtype: torch.dtype) -> bool:
    """The engine verdict (``kernels.ops.use_fused``) of ``family``'s
    kernel pair on the operand A (dense, or the ``_sparse`` family's on a
    ``SparseBlocks``) with k right-hand sides in ``dtype``, asked with
    A's stored dtype as the reference asks it."""
    if blockops.is_sparse(A):
        V = A.vals
        return kops.use_fused(f"{family}_sparse", V.shape[1],
                              blockops.ncols(A), k, V.dtype, w=V.shape[2],
                              device=V.device, compute_dtype=dtype)
    return kops.use_fused(family, A.shape[1], A.shape[2], k, A.dtype,
                          device=A.device, compute_dtype=dtype)


def _resolve(family: str, factors: ProjFactors, k: int,
             dtype: torch.dtype) -> None:
    """Every verdict a kernel-path step of ``family`` on ``factors`` with
    k right-hand sides reads: the engine's, and where it says fused, the
    kernels' k-chunk (``kernels.ops.launch_kc``)."""
    if _fused(family, factors.A, k, dtype):
        M = factors.A.vals if blockops.is_sparse(factors.A) else factors.A
        kops.launch_kc(M, M.shape[2], M.shape[1], k, dtype)


def _row_projections(A, chol, b, xbar):
    """(r, v): the row projections r_i = A_iᵀG_i⁻¹v_i (..., m, n) of
    v = b − A x̄, unfused, for dense or sparse A."""
    v = b - blockops.bmatvec(A, xbar)
    return blockops.brmatvec(A, _gram_solve(chol, v)), v


@register("apc")
class APCSolver(Solver):
    """Accelerated Projection-based Consensus (paper Algorithm 1)."""

    paper_name = "APC"
    supports_kernel = True
    param_names = ("gamma", "eta")
    # the paper's convergence theory (Theorem 1) assumes an exact solution
    # exists, so APC keeps its square-only contract; sparse blocks are fine
    supports = frozenset({"square", "sparse"})
    # The iterates satisfy A_i x_i = b_i exactly (min-norm init, kept by
    # the projection since A_i B_i = I), so the gather result
    # u_i = A_i(x̄ − x_i) IS the residual block A_i x̄ − b_i of the consumed
    # state: the history needs no second read of A per iteration.
    supports_fused_residual = True
    # per-block Gram Cholesky, every factor leaf with a leading m axis
    # (store.FactorStore.blockwise_factors)
    supports_block_store = True

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

    def cast_factors(self, factors, precision):
        return _cast_proj_factors(factors, precision)

    def init(self, factors, b, params):
        x0 = _min_norm_solutions(factors, b)
        return APCState(x=x0, xbar=x0.mean(dim=-2), t=0)

    def resolve_engine(self, factors, k, dtype):
        _resolve("apc", factors, k, dtype)

    def _step_u(self, factors, state, gamma, use_kernel):
        """The worker update (Eq. 2a) and its gather result u, in the
        state's layout.  The kernel path hands the kernels the (m, k, n)
        view of a batched (k, m, n) iterate — a transpose, not a copy —
        where the engine verdict says fused; else the unfused update."""
        batched = state.x.dim() == 3
        if use_kernel:
            use_kernel = _fused("apc", factors.A,
                                state.x.shape[0] if batched else 1,
                                state.x.dtype)
        if not use_kernel:
            return apc_core.worker_update(factors.A, factors.chol, state,
                                          gamma)
        factors = _with_pinv(factors)
        X = state.x.transpose(0, 1) if batched else state.x
        if blockops.is_sparse(factors.A):
            Asp = factors.A
            x_new, u = kops.sparse_proj_update(Asp.vals, Asp.cols, factors.B,
                                               X, state.xbar, gamma)
        else:
            u = kops.proj_gather(factors.A, X, state.xbar)
            x_new = kops.proj_scatter(factors.B, X, state.xbar, u, gamma)
        if batched:
            return x_new.transpose(0, 1), u.transpose(0, 1)
        return x_new, u

    def step(self, factors, b, state, params, *, use_kernel=False):
        x_new, _ = self._step_u(factors, state, params["gamma"], use_kernel)
        return apc_core.master_update(x_new, state, params["eta"])

    def step_residual(self, factors, b, state, params):
        """(new state, ‖A x̄ − b‖² of the consumed state) — the kernel
        path whenever the factors carry B, as in the reference."""
        x_new, u = self._step_u(factors, state, params["gamma"],
                                factors.B is not None)
        return (apc_core.master_update(x_new, state, params["eta"]),
                torch.sum(u * u, dim=(-2, -1)))

    def extract(self, state):
        return state.xbar


@register("consensus")
class ConsensusSolver(APCSolver):
    """Plain projection consensus == APC with gamma = eta = 1."""

    paper_name = "Consensus"

    def default_params(self, sys: BlockSystem):
        return {"gamma": 1.0, "eta": 1.0}

    def analyze(self, sys: BlockSystem):
        mu_min, _ = spectral.mu_extremes(spectral.x_matrix(sys))
        return self.default_params(sys), spectral.consensus_rate(mu_min)


class CimminoState(NamedTuple):
    xbar: torch.Tensor    # (n,) or (k, n) master estimate
    t: int                # iteration counter


@register("cimmino")
class CimminoSolver(Solver):
    """Block Cimmino row projections (Sec 4.5; Proposition 2: APC with
    gamma = 1 and eta = m nu)."""

    paper_name = "B-Cimmino"
    supports_kernel = True
    param_names = ("nu",)
    # the state is the master estimate alone and b enters every step, so
    # a prior state warm-starts perturbed right-hand sides too
    warm_rhs_ok = True
    # the fixed point Σ A_iᵀG_i⁻¹(b_i − A_i x̄) = 0 is the G⁻¹-weighted
    # least-squares optimum, well-defined for inconsistent systems too
    supports = frozenset({"square", "least_squares", "sparse"})
    # The gather result u = A x̄ gives the consumed state's residual
    # blocks directly: A x̄ − b = −v, v = b − u the scatter's operand.
    supports_fused_residual = True
    supports_block_store = True    # per-block Gram Cholesky, leading m axis

    def default_params(self, sys: BlockSystem):
        return self.analyze(sys)[0]

    def analyze(self, sys: BlockSystem):
        X = spectral.x_matrix(sys)
        nu_m, rho = spectral.cimmino_optimal(*spectral.mu_extremes(X))
        return {"nu": nu_m / sys.m}, rho

    def prepare(self, A, params):
        return _proj_prepare(A, params.get("jitter", 0.0))

    def kernel_factors(self, factors):
        return _with_pinv(factors)

    def cast_factors(self, factors, precision):
        return _cast_proj_factors(factors, precision)

    def init(self, factors, b, params):
        """x̄ = 0 in b's dtype: (n,), or (k, n) for a batch b (k, m, p)."""
        return CimminoState(
            xbar=b.new_zeros(b.shape[:-2] + (blockops.ncols(factors.A),)),
            t=0)

    def resolve_engine(self, factors, k, dtype):
        _resolve("cimmino", factors, k, dtype)

    def _r_v(self, factors, b, xbar, use_kernel):
        """(Σ_i r_i, v): the summed row projections r_i = A_iᵀG_i⁻¹v_i and
        v = b − A x̄, the residual source, in b's layout.  The kernel path
        hands the kernels the (m, k, p) view of a batched b (no copy)
        where the engine verdict says fused; else the unfused step."""
        batched = b.dim() == 3
        if use_kernel:
            use_kernel = _fused("cimmino", factors.A,
                                b.shape[0] if batched else 1, b.dtype)
        if not use_kernel:
            r, v = _row_projections(factors.A, factors.chol, b, xbar)
            return r.sum(dim=-2), v
        factors = _with_pinv(factors)
        bw = b.transpose(0, 1) if batched else b
        if blockops.is_sparse(factors.A):
            Asp = factors.A
            R, u = kops.sparse_cimmino_update(Asp.vals, Asp.cols, factors.B,
                                              bw, xbar)
            v = bw - u
        else:
            v = kops.cimmino_residual(bw, kops.cimmino_gather(factors.A,
                                                              xbar))
            R = kops.cimmino_scatter(factors.B, v)
        return R.sum(dim=0), v.transpose(0, 1) if batched else v

    def step(self, factors, b, state, params, *, use_kernel=False):
        r, _ = self._r_v(factors, b, state.xbar, use_kernel)
        return CimminoState(xbar=state.xbar + params["nu"] * r,
                            t=state.t + 1)

    def step_residual(self, factors, b, state, params):
        """(new state, ‖A x̄ − b‖² of the consumed state) — the kernel
        path whenever the factors carry B, as in the reference."""
        r, v = self._r_v(factors, b, state.xbar, factors.B is not None)
        return (CimminoState(xbar=state.xbar + params["nu"] * r,
                             t=state.t + 1),
                torch.sum(v * v, dim=(-2, -1)))

    def extract(self, state):
        return state.xbar

    # ----- least-squares mode ---------------------------------------------
    # The Cimmino fixed point minimizes Σᵢ ‖L_i⁻¹(A_i x − b_i)‖², the
    # Gram-whitened least-squares problem: ``ls_moment`` is exactly the
    # update direction (zero at the optimum), ``ls_reference`` solves the
    # whitened system directly, in numpy on the host.
    def ls_moment(self, factors, A, b, x, params):
        return _row_projections(A, factors.chol, b, x)[0].sum(dim=-2)

    def ls_reference(self, sys: BlockSystem) -> torch.Tensor:
        A = sys.A_blocks.cpu().double().numpy()
        b = sys.b_blocks.cpu().double().numpy()
        rows, rhs = [], []
        for Ai, bi in zip(A, b):
            L = np.linalg.cholesky(Ai @ Ai.T)
            rows.append(np.linalg.solve(L, Ai))       # L_i⁻¹ A_i
            rhs.append(np.linalg.solve(L, bi))        # L_i⁻¹ b_i
        x, *_ = np.linalg.lstsq(np.concatenate(rows), np.concatenate(rhs),
                                rcond=None)
        return torch.as_tensor(x, dtype=sys.b_blocks.dtype,
                               device=sys.device)
