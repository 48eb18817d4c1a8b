"""Modified consensus-ADMM (paper Sec 4.4; counterpart of
``repro.solvers.admm``, local backend).

Native consensus-ADMM with the y_i-update disabled (y_i == 0), which the
paper reports as a significant speedup for consistent systems.  Each
worker solves its p x p (not n x n) system by the matrix inversion lemma:

    (A^T A + xi I)^{-1} v = (v - A^T (G + xi I)^{-1} A v) / xi.

No kernel: the per-step products go through ``core.blockops`` (dense
or sparse blocks), as the reference left them to XLA.  Every hook is
batch-polymorphic.  On the mesh (``solvers/mesh.py``) the Gram and A_i v
are summed over the model axis, and x̄ is the workers' ``all_reduce``
over m.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import blockops
from repro_torch.core.apc import _gram_solve
from repro_torch.core.partition import BlockSystem

from .api import Solver
from .registry import register


class ADMMFactors(NamedTuple):
    A: object            # (m, p, n) row blocks, or a blockops.SparseBlocks
    chol: torch.Tensor   # (m, p, p) Cholesky of G + xi I


class ADMMState(NamedTuple):
    xbar: torch.Tensor   # (n,) or (k, n) consensus estimate
    t: int               # iteration counter
    Atb: torch.Tensor    # (m, n) or (k, m, n) cached A_i^T b_i


@register("madmm")
class MADMMSolver(Solver):
    paper_name = "M-ADMM"
    param_names = ("xi",)
    # the y_i == 0 simplification is only exact for consistent systems
    # (paper Sec 4.4), so no least-squares mode; sparse blocks are fine
    supports = frozenset({"square", "sparse"})

    def default_params(self, sys: BlockSystem):
        return {"xi": 1.0}

    def prepare(self, A, params):
        G = blockops.bgram(A)
        eye = torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)
        return ADMMFactors(A=A,
                           chol=torch.linalg.cholesky(G + params["xi"] * eye))

    def init(self, factors, b, params):
        A = factors.A
        return ADMMState(
            xbar=b.new_zeros(b.shape[:-2] + (blockops.ncols(A),),
                             dtype=blockops.block_dtype(A)),
            t=0, Atb=blockops.brmatvec(A, b))

    def step(self, factors, b, state, params, *, use_kernel=False):
        xi = params["xi"]
        v = state.Atb + xi * state.xbar[..., None, :]
        w = _gram_solve(factors.chol, blockops.bmatvec_each(factors.A, v))
        x_new = (v - blockops.brmatvec(factors.A, w)) / xi
        return ADMMState(xbar=x_new.mean(dim=-2), t=state.t + 1,
                         Atb=state.Atb)

    def extract(self, state):
        return state.xbar

    # ----- mesh backend ---------------------------------------------------
    def mesh_placements(self, use_kernel=False):
        return (ADMMFactors(A=("w", None, "n"), chol=("w", None, None)),
                ADMMState(xbar=("n",), t=None, Atb=("w", "n")))

    def mesh_prepare(self, A, params, ctx, use_kernel=False):
        G = ctx.psum_model(blockops.bgram(A))
        eye = torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)
        return ADMMFactors(A=A,
                           chol=torch.linalg.cholesky(G + params["xi"] * eye))

    def mesh_step(self, factors, b, state, params, ctx, *, use_kernel=False):
        xi = params["xi"]
        v = state.Atb + xi * state.xbar[..., None, :]
        Av = ctx.psum_model(blockops.bmatvec_each(factors.A, v))
        x_new = (v - blockops.brmatvec(factors.A,
                                       _gram_solve(factors.chol, Av))) / xi
        m = ctx.workers_total(x_new.shape[-2])
        return ADMMState(xbar=ctx.psum_workers(x_new.sum(dim=-2)) / m,
                         t=state.t + 1, Atb=state.Atb)
