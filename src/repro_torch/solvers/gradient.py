"""Gradient-family solvers: DGD, D-NAG, D-HBM and preconditioned D-HBM
(counterpart of ``repro.solvers.gradient``, local backend).

Each worker computes its partial gradient g_i = A_i^T (A_i x - b_i); the
master sums them.  P-DHBM (paper Sec 6) premultiplies each local block by
S_i = (A_i A_i^T)^{-1/2} so that heavy-ball attains the APC rate — S
depends only on A, so it lives in ``prepare``; the transformed RHS S_i b_i
is cached in the state at ``init`` time.  The family has no kernel: its
two products per step go through ``core.blockops`` (dense or sparse
blocks), as the reference left them to XLA.  Every hook is
batch-polymorphic (x (k, n), b (k, m, p)).

On the mesh (``solvers/mesh.py``) each rank sums its workers' partial
gradients over its column shard, A x summed over the model axis first,
and the master's sum is an ``all_reduce`` over the workers; P-DHBM's
(A_iA_iᵀ)^{-1/2} comes from the Gram summed over the model axis.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import blockops
from repro_torch.core import spectral
from repro_torch.core.partition import BlockSystem
from repro_torch.core.precond import block_inv_sqrt

from .api import LOCAL_PSUM, Solver
from .registry import register


class GradFactors(NamedTuple):
    A: object            # (m, p, n) row blocks, or a blockops.SparseBlocks


class PrecondFactors(NamedTuple):
    C: torch.Tensor      # (m, p, n) preconditioned blocks S_i A_i
    S: torch.Tensor      # (m, p, p) per-worker (A_i A_i^T)^{-1/2}


def _grad(A, b, x):
    """Full gradient sum_i A_i^T (A_i x - b_i) of (1/2)||Ax-b||^2, for x
    (n,) / b (m, p) or a batch x (k, n) / b (k, m, p)."""
    return blockops.brmatvec_sum(A, blockops.bmatvec(A, x) - b)


class _GradientSolver(Solver):
    """Shared lifecycle of the gradient family: the summed gradient of
    (1/2)||Cx-d||^2 over ``_blocks``/``_rhs``, handed to the per-solver
    master update ``_update``.

    The iteration re-reads b every step, so a prior state warm-starts a
    perturbed right-hand side too (``warm_rhs_ok``) — except P-DHBM,
    whose state caches S b.

    The family is gradient descent on (1/2)||Ax-b||^2, whose minimizer is
    the least-squares solution: inconsistent systems are first-class,
    with the plain normal equations as the optimality moment.
    """

    warm_rhs_ok = True
    supports = frozenset({"square", "least_squares", "sparse"})

    def prepare(self, A, params):
        return GradFactors(A=A)

    def _blocks(self, factors):
        """The (m, p, n) row blocks the gradient runs over."""
        return factors.A

    def _rhs(self, factors, b, state):
        """The right-hand side paired with ``_blocks``."""
        return b

    def _update(self, state, g, params):
        """Master update from the summed gradient g (override)."""
        raise NotImplementedError

    def step(self, factors, b, state, params, *, use_kernel=False):
        g = _grad(self._blocks(factors), self._rhs(factors, b, state),
                  state.x)
        return self._update(state, g, params)

    def _zeros(self, factors, b):
        """x = 0 in the blocks' dtype: (n,), or (k, n) for a batch b."""
        A = self._blocks(factors)
        return b.new_zeros(b.shape[:-2] + (blockops.ncols(A),),
                           dtype=blockops.block_dtype(A))

    def extract(self, state):
        return state.x

    # ----- least-squares mode ---------------------------------------------
    def ls_moment(self, factors, A, b, x, params, ctx=LOCAL_PSUM):
        """Normal-equations optimality moment Aᵀ(Ax − b) (summed over the
        mesh through ``ctx``)."""
        r = ctx.psum_model(blockops.bmatvec(A, x)) - b
        return ctx.psum_workers(blockops.brmatvec_sum(A, r))

    def ls_reference(self, sys: BlockSystem) -> torch.Tensor:
        """numpy ``lstsq`` of the dense system, on the host."""
        A, b = (t.cpu().double().numpy() for t in sys.dense())
        x, *_ = np.linalg.lstsq(A, b, rcond=None)
        return torch.as_tensor(x, dtype=sys.b_blocks.dtype,
                               device=sys.device)

    # ----- mesh backend ---------------------------------------------------
    #: the state's placements (per solver)
    _mesh_state: tuple = ()

    def mesh_placements(self, use_kernel=False):
        return GradFactors(A=("w", None, "n")), self._mesh_state

    def mesh_prepare(self, A, params, ctx, use_kernel=False):
        return GradFactors(A=A)

    def mesh_step(self, factors, b, state, params, ctx, *, use_kernel=False):
        A = self._blocks(factors)
        Ax = ctx.psum_model(blockops.bmatvec(A, state.x))
        g = ctx.psum_workers(blockops.brmatvec_sum(
            A, Ax - self._rhs(factors, b, state)))
        return self._update(state, g, params)


class DGDState(NamedTuple):
    x: torch.Tensor
    t: int


@register("dgd")
class DGDSolver(_GradientSolver):
    """Distributed gradient descent, Eq. (8)."""

    paper_name = "DGD"
    param_names = ("alpha",)

    def default_params(self, sys: BlockSystem):
        return self.analyze(sys)[0]

    def analyze(self, sys: BlockSystem):
        alpha, rho = spectral.dgd_optimal(*spectral.ata_extremes(sys))
        return {"alpha": alpha}, rho

    def init(self, factors, b, params):
        return DGDState(x=self._zeros(factors, b), t=0)

    def _update(self, state, g, params):
        return DGDState(x=state.x - params["alpha"] * g, t=state.t + 1)

    _mesh_state = DGDState(x=("n",), t=None)


class DNAGState(NamedTuple):
    x: torch.Tensor
    y_prev: torch.Tensor
    t: int


@register("dnag")
class DNAGSolver(_GradientSolver):
    """Distributed Nesterov accelerated gradient, Eq. (10)."""

    paper_name = "D-NAG"
    param_names = ("alpha", "beta")

    def default_params(self, sys: BlockSystem):
        return self.analyze(sys)[0]

    def analyze(self, sys: BlockSystem):
        a, b_, rho = spectral.dnag_optimal(*spectral.ata_extremes(sys))
        return {"alpha": a, "beta": b_}, rho

    def init(self, factors, b, params):
        z = self._zeros(factors, b)
        return DNAGState(x=z, y_prev=z, t=0)

    def _update(self, state, g, params):
        alpha, beta = params["alpha"], params["beta"]
        y = state.x - alpha * g
        return DNAGState(x=(1.0 + beta) * y - beta * state.y_prev, y_prev=y,
                         t=state.t + 1)

    _mesh_state = DNAGState(x=("n",), y_prev=("n",), t=None)


class DHBMState(NamedTuple):
    x: torch.Tensor
    z: torch.Tensor
    t: int


@register("dhbm")
class DHBMSolver(_GradientSolver):
    """Distributed heavy-ball method, Eq. (12)."""

    paper_name = "D-HBM"
    param_names = ("alpha", "beta")

    def default_params(self, sys: BlockSystem):
        return self.analyze(sys)[0]

    def analyze(self, sys: BlockSystem):
        a, b_, rho = spectral.dhbm_optimal(*spectral.ata_extremes(sys))
        return {"alpha": a, "beta": b_}, rho

    def init(self, factors, b, params):
        z = self._zeros(factors, b)
        return DHBMState(x=z, z=z, t=0)

    def _update(self, state, g, params):
        z_new = params["beta"] * state.z + g
        return DHBMState(x=state.x - params["alpha"] * z_new, z=z_new,
                         t=state.t + 1)

    _mesh_state = DHBMState(x=("n",), z=("n",), t=None)


class PDHBMState(NamedTuple):
    x: torch.Tensor
    z: torch.Tensor
    t: int
    d: torch.Tensor      # (m, p) or (k, m, p) cached RHS S_i b_i


@register("pdhbm")
class PDHBMSolver(DHBMSolver):
    """D-HBM on the Sec-6 preconditioned system — matches the APC rate.

    C^T C = m X exactly, so the optimal (alpha, beta) come from the
    spectrum of X scaled by m, with no eigensolve on C itself.
    """

    paper_name = "P-DHBM"
    warm_rhs_ok = False     # the state caches S b — stale under a new RHS
    # the preconditioner eigendecomposes the dense blocks, and the
    # transformed system is only equivalent for consistent systems
    supports = frozenset({"square"})

    def analyze(self, sys: BlockSystem):
        mu_min, mu_max = spectral.mu_extremes(spectral.x_matrix(sys))
        a, b_, rho = spectral.dhbm_optimal(sys.m * mu_min, sys.m * mu_max)
        return {"alpha": a, "beta": b_}, rho

    def prepare(self, A, params):
        S = block_inv_sqrt(A)
        C = S @ A.to(torch.float64)
        return PrecondFactors(C=C.to(A.dtype), S=S.to(A.dtype))

    def init(self, factors, b, params):
        z = self._zeros(factors, b)
        return PDHBMState(x=z, z=z, t=0,
                          d=torch.einsum("mpq,...mq->...mp", factors.S, b))

    def _blocks(self, factors):
        return factors.C

    def _rhs(self, factors, b, state):
        return state.d

    def _update(self, state, g, params):
        z_new = params["beta"] * state.z + g
        return PDHBMState(x=state.x - params["alpha"] * z_new, z=z_new,
                          t=state.t + 1, d=state.d)

    _mesh_state = PDHBMState(x=("n",), z=("n",), t=None, d=("w", None))

    def mesh_placements(self, use_kernel=False):
        return (PrecondFactors(C=("w", None, "n"), S=("w", None, None)),
                self._mesh_state)

    def mesh_prepare(self, A, params, ctx, use_kernel=False):
        """On-mesh (A_iA_iᵀ)^{-1/2} in A's dtype: the Gram summed over the
        column shards, the p x p inverse square root an ``eigh`` on every
        worker's, its eigenvalues clamped at the dtype's tiny (as
        ``core.precond`` clamps) so a rank-deficient block gives a large
        but finite preconditioner."""
        G = ctx.psum_model(blockops.bgram(A))
        w, V = torch.linalg.eigh(G)
        w = torch.clamp_min(w, torch.finfo(w.dtype).tiny)
        S = torch.einsum("mpq,mq,mrq->mpr", V, 1.0 / torch.sqrt(w), V)
        return PrecondFactors(C=S @ A, S=S)
