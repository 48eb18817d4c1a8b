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

The ``mesh_*`` hooks run the same maths on a rank's shards
(``solvers/mesh.py``).  With n sharded over the model axis, the Gram is
summed over it before its Cholesky (the jitter from the FULL Gram's
trace), the pinv factor B_loc = A_locᵀ G⁻¹ is shard-local, and the
kernel path launches the gather and the scatter apart, with the sum of u
over the model axis between them: ``proj_gather`` → ``psum_model`` →
``proj_scatter`` (APC, consensus), ``cimmino_gather`` → ``psum_model`` →
``cimmino_scatter`` (Cimmino), each on the (p, n/model) shard.  The
sparse kernels run per worker, with the model axis off.  As in the
reference, the mesh's kernel path asks no engine verdict.

The ``red_*`` hooks run redundant execution (``solvers/redundant.py``):
factors and b replicated to (m, r, ...) along the cyclic assignment, every
replica updated, the master sum over the workers masked by the (m, r)
selection weights W so each block counts once — torch library ops
(einsum, batched Cholesky solves), as the reference's are XLA ops: the
replicated layout has no kernel.  ``lift_state`` warm-starts a new
partition from a global estimate (the elastic runtime's repartition).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import apc as apc_core
from repro_torch.core import blockops
from repro_torch.core import spectral
from repro_torch.core.apc import (APCState, _gram_chol, _gram_solve,
                                  _jittered_chol)
from repro_torch.core.partition import BlockSystem
from repro_torch.kernels import ops as kops

from .api import LOCAL_PSUM, Solver
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


def _row_projections(A, chol, b, xbar, ctx=LOCAL_PSUM):
    """(r, v): the row projections r_i = A_iᵀG_i⁻¹v_i (..., m, n) of
    v = b − A x̄, unfused, for dense or sparse A (on the mesh: from local
    shards, A x̄ summed over the model axis)."""
    v = b - ctx.psum_model(blockops.bmatvec(A, xbar))
    return blockops.brmatvec(A, _gram_solve(chol, v)), v


def _cho_solve_replicas(chol, u):
    """G⁻¹u per replica: chol (m, r, p, p), u (m, r, p) — the Cholesky
    factor's two triangular solves, batched over the m·r replicas.  On the
    card they are cuBLAS's batched trsm, which a graph captures; MAGMA's
    batched ``cholesky_solve`` cannot be captured, and cuSOLVER's is
    several times slower at the main path's shapes (``chip_smoke.py``
    phase 18 times the three)."""
    y = torch.linalg.solve_triangular(chol, u.unsqueeze(-1), upper=False)
    return torch.linalg.solve_triangular(chol.transpose(-1, -2), y,
                                         upper=True).squeeze(-1)


def _masked_sum(W, v):
    """Σ_i Σ_k W[i, k] v[i, k] (the block-unique sum): W (m, r), v (m, r,
    n) -> (n,)."""
    return torch.einsum("mr,mrn->n", W.to(v.dtype), v)


def _mesh_gram_chol(A, jitter: float, ctx):
    """Cholesky of the full Gram A_i A_iᵀ from column-sharded blocks."""
    return _jittered_chol(ctx.psum_model(blockops.bgram(A)), jitter)


def _proj_placements(use_kernel: bool) -> ProjFactors:
    """The projection factors' placements (a sparse operand's ``A`` is
    patched in by the mesh backend)."""
    return ProjFactors(A=("w", None, "n"), chol=("w", None, None),
                       B=("w", "n", None) if use_kernel else None)


def _mesh_factors(factors: ProjFactors, use_kernel: bool) -> ProjFactors:
    """Global factors for the mesh: the pinv factors ensured on the
    kernel path (idempotent), dropped otherwise (kernel-only)."""
    return _with_pinv(factors) if use_kernel else factors._replace(B=None)


def _mesh_prepare(A, params, ctx, use_kernel: bool) -> ProjFactors:
    """On-mesh prepare: the full Gram's Cholesky; on the kernel path
    B_loc = A_locᵀ G⁻¹, shard-local given that Cholesky (the solve acts
    on the p axis only), so no rank holds the whole A."""
    factors = ProjFactors(A=A, chol=_mesh_gram_chol(
        A.vals if blockops.is_sparse(A) else A, params.get("jitter", 0.0),
        ctx))
    return _with_pinv(factors) if use_kernel else factors


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

    # ----- mesh backend ---------------------------------------------------
    def mesh_placements(self, use_kernel=False):
        return (_proj_placements(use_kernel),
                APCState(x=("w", "n"), xbar=("n",), t=None))

    def mesh_factors(self, factors, use_kernel=False):
        return _mesh_factors(factors, use_kernel)

    def mesh_prepare(self, A, params, ctx, use_kernel=False):
        return _mesh_prepare(A, params, ctx, use_kernel)

    def mesh_init(self, factors, b, params, ctx):
        x0 = _min_norm_solutions(factors, b)
        m = ctx.workers_total(x0.shape[-2])
        return APCState(x=x0, xbar=ctx.psum_workers(x0.sum(dim=-2)) / m,
                        t=0)

    def _mesh_step_u(self, factors, state, gamma, ctx, use_kernel):
        """Eq. 2a on local shards: (x_new, the full u = A_i(x̄ − x_i)), in
        the state's layout.  The kernel path: the gather on the shard, u
        summed over the model axis, the scatter (the sparse pair per
        worker, whose u is already full)."""
        if not (use_kernel and factors.B is not None):
            d = state.xbar[..., None, :] - state.x
            u = ctx.psum_model(blockops.bmatvec_each(factors.A, d))
            proj = d - blockops.brmatvec(factors.A,
                                         _gram_solve(factors.chol, u))
            return state.x + gamma * proj, u
        batched = state.x.dim() == 3
        X = state.x.transpose(0, 1) if batched else state.x
        if blockops.is_sparse(factors.A):
            Asp = factors.A
            x_new, u = kops.sparse_proj_update(Asp.vals, Asp.cols, factors.B,
                                               X, state.xbar, gamma)
            u = ctx.psum_model(u)
        else:
            u = ctx.psum_model(kops.proj_gather(factors.A, X, state.xbar))
            x_new = kops.proj_scatter(factors.B, X, state.xbar, u, gamma)
        if batched:
            return x_new.transpose(0, 1), u.transpose(0, 1)
        return x_new, u

    def _mesh_master(self, x_new, state, eta, ctx):
        """Eq. 2b: x̄ <- (eta/m) Σ_i x_i + (1 − eta) x̄, the sum over the
        workers an ``all_reduce``."""
        m = ctx.workers_total(x_new.shape[-2])
        s = ctx.psum_workers(x_new.sum(dim=-2))
        return APCState(x=x_new, xbar=(eta / m) * s + (1.0 - eta) * state.xbar,
                        t=state.t + 1)

    def mesh_step(self, factors, b, state, params, ctx, *, use_kernel=False):
        x_new, _ = self._mesh_step_u(factors, state, params["gamma"], ctx,
                                     use_kernel)
        return self._mesh_master(x_new, state, params["eta"], ctx)

    def mesh_step_residual(self, factors, b, state, params, ctx):
        """The mesh step and the consumed state's global ‖A x̄ − b‖², from
        the gather results — the kernel path whenever the factors carry
        B, as in the reference."""
        x_new, u = self._mesh_step_u(factors, state, params["gamma"], ctx,
                                     True)
        return (self._mesh_master(x_new, state, params["eta"], ctx),
                ctx.psum_workers(torch.sum(u * u, dim=(-2, -1))))

    # ----- redundant execution (solvers/redundant.py) ---------------------
    # The internal state keeps APCState with x in the replicated (m, r, n)
    # layout; x̄ stays global.  Eq. 2b becomes the W-masked block-unique
    # mean, the same sum over the workers as above.
    supports_redundancy = True

    def red_init(self, factors, b, params, W0, ctx):
        w = _cho_solve_replicas(factors.chol, b)
        x0 = torch.einsum("mrpn,mrp->mrn", factors.A, w)  # min-norm a slot
        m = ctx.workers_total(x0.shape[0])
        return APCState(x=x0, xbar=ctx.psum_workers(_masked_sum(W0, x0)) / m,
                        t=0)

    def red_step(self, factors, b, state, params, W, ctx):
        gamma, eta = params["gamma"], params["eta"]
        d = state.xbar[None, None, :] - state.x          # (m, r, n)
        u = ctx.psum_model(torch.einsum("mrpn,mrn->mrp", factors.A, d))
        w = _cho_solve_replicas(factors.chol, u)
        proj = d - torch.einsum("mrpn,mrp->mrn", factors.A, w)
        x_new = state.x + gamma * proj                   # every replica
        m = ctx.workers_total(x_new.shape[0])
        s = ctx.psum_workers(_masked_sum(W, x_new))
        return APCState(x=x_new,
                        xbar=(eta / m) * s + (1.0 - eta) * state.xbar,
                        t=state.t + 1)

    def red_expand(self, state, assign):
        x = torch.as_tensor(state.x)
        return APCState(x=x[torch.as_tensor(assign.holder, device=x.device)],
                        xbar=state.xbar, t=state.t)

    def red_collapse(self, state, assign):
        # slot 0 of worker j holds block j, and replicas are identical
        return APCState(x=state.x[:, 0], xbar=state.xbar, t=state.t)

    def red_state_placements(self, spl):
        return APCState(x=("w", None, "n"), xbar=("n",), t=None)

    # ----- cross-partition warm start (solvers/elastic.py) ----------------
    # APC states belong to one partition: each x_i satisfies A_i x_i = b_i
    # for ITS blocks.  The lift projects the global estimate onto every new
    # block's feasible set, x_i = x + A_iᵀG_i⁻¹(b_i − A_i x), so the
    # invariant the step relies on holds from the first iteration after a
    # repartition, with x̄ carrying x verbatim.
    supports_lift = True

    def lift_state(self, factors, b, params, x):
        v = b - blockops.bmatvec(factors.A, x)           # (m, p)
        xi = x[None, :] + blockops.brmatvec(factors.A,
                                            _gram_solve(factors.chol, v))
        return APCState(x=xi, xbar=x, t=0)


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

    # ----- mesh backend ---------------------------------------------------
    def mesh_placements(self, use_kernel=False):
        return (_proj_placements(use_kernel),
                CimminoState(xbar=("n",), t=None))

    def mesh_factors(self, factors, use_kernel=False):
        return _mesh_factors(factors, use_kernel)

    def mesh_prepare(self, A, params, ctx, use_kernel=False):
        return _mesh_prepare(A, params, ctx, use_kernel)

    def _mesh_r_v(self, factors, b, xbar, ctx, use_kernel):
        """(the local workers' Σ_i r_i, the full v = b − A x̄) from local
        shards, in b's layout.  The kernel path: the gather on the shard,
        u summed over the model axis, the scatter (the sparse pair per
        worker)."""
        if not (use_kernel and factors.B is not None):
            r, v = _row_projections(factors.A, factors.chol, b, xbar, ctx)
            return r.sum(dim=-2), v
        batched = b.dim() == 3
        bw = b.transpose(0, 1) if batched else b
        if blockops.is_sparse(factors.A):
            Asp = factors.A
            R, u = kops.sparse_cimmino_update(Asp.vals, Asp.cols, factors.B,
                                              bw, xbar)
            v = bw - ctx.psum_model(u)
        else:
            v = kops.cimmino_residual(bw, ctx.psum_model(
                kops.cimmino_gather(factors.A, xbar)))
            R = kops.cimmino_scatter(factors.B, v)
        return R.sum(dim=0), v.transpose(0, 1) if batched else v

    def mesh_step(self, factors, b, state, params, ctx, *, use_kernel=False):
        r, _ = self._mesh_r_v(factors, b, state.xbar, ctx, use_kernel)
        return CimminoState(
            xbar=state.xbar + params["nu"] * ctx.psum_workers(r),
            t=state.t + 1)

    def mesh_step_residual(self, factors, b, state, params, ctx):
        """The mesh step and ‖A x̄ − b‖² of the consumed state, from the
        gather pass (v = b − A x̄)."""
        r, v = self._mesh_r_v(factors, b, state.xbar, ctx, True)
        return (CimminoState(
            xbar=state.xbar + params["nu"] * ctx.psum_workers(r),
            t=state.t + 1),
            ctx.psum_workers(torch.sum(v * v, dim=(-2, -1))))

    # ----- redundant execution (solvers/redundant.py) ---------------------
    # The state is the master estimate alone (already global-shaped): the
    # masked sum of the row projections replaces the plain one.
    supports_redundancy = True

    def red_init(self, factors, b, params, W0, ctx):
        return CimminoState(xbar=factors.A.new_zeros(factors.A.shape[3]),
                            t=0)

    def red_step(self, factors, b, state, params, W, ctx):
        u = ctx.psum_model(torch.einsum("mrpn,n->mrp", factors.A,
                                        state.xbar))
        w = _cho_solve_replicas(factors.chol, b - u)
        r = torch.einsum("mrpn,mrp->mrn", factors.A, w)  # row projections
        s = ctx.psum_workers(_masked_sum(W, r))
        return CimminoState(xbar=state.xbar + params["nu"] * s,
                            t=state.t + 1)

    # ----- cross-partition warm start (solvers/elastic.py) ----------------
    # The state is the master estimate alone and carries no per-block
    # invariant, so it lifts across any repartition verbatim.
    supports_lift = True

    def lift_state(self, factors, b, params, x):
        return CimminoState(xbar=x, t=0)

    # ----- least-squares mode ---------------------------------------------
    # The Cimmino fixed point minimizes Σᵢ ‖L_i⁻¹(A_i x − b_i)‖², the
    # Gram-whitened least-squares problem: ``ls_moment`` is exactly the
    # update direction (zero at the optimum), ``ls_reference`` solves the
    # whitened system directly, in numpy on the host.
    def ls_moment(self, factors, A, b, x, params, ctx=LOCAL_PSUM):
        r = _row_projections(A, factors.chol, b, x, ctx)[0]
        return ctx.psum_workers(r.sum(dim=-2))

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
