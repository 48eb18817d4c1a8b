"""APC building blocks (paper Algorithm 1), workers as a batch dimension.

Counterpart of the building blocks of ``repro.core.apc``: the state, the
per-worker Gram Cholesky factors, the null-space projection and the
unfused iteration.  The deprecated ``solve`` shim is ROADMAP item A18;
``repro_torch.solvers.get("apc")`` is the solve surface.

Worker update (Eq. 2a):   x_i <- x_i + gamma * P_i (xbar - x_i)
Master update (Eq. 2b):   xbar <- (eta/m) sum_i x_i + (1-eta) xbar

with P_i = I - A_i^T (A_i A_i^T)^{-1} A_i, applied as two matvecs and one
Cholesky solve against the stored factor L_i of G_i = A_i A_i^T.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import blockops

class APCState(NamedTuple):
    """Checkpointable iteration state (global shapes)."""
    x: torch.Tensor       # (m, n) worker solutions, all satisfy A_i x_i = b_i
    xbar: torch.Tensor    # (n,)  master estimate
    t: int                # iteration counter


def _gram_chol(A: torch.Tensor, jitter: float) -> torch.Tensor:
    """Cholesky factors of the Grams A_i A_i^T of (..., p, n) blocks, with
    the trace-scaled jitter ``jitter * tr(G)/p * I`` when nonzero."""
    return _jittered_chol(A @ A.transpose(-1, -2), jitter)


def _jittered_chol(G: torch.Tensor, jitter: float) -> torch.Tensor:
    """Cholesky factors of the (..., p, p) Grams G, jittered by
    ``jitter * tr(G)/p * I`` when nonzero."""
    if jitter:
        p = G.shape[-1]
        tr = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)[..., None, None]
        G = G + jitter * tr / p * torch.eye(p, dtype=G.dtype,
                                            device=G.device)
    return torch.linalg.cholesky(G)


def _gram_solve(chol: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) y = u per worker: chol (m, p, p), u (m, p) or a batch
    (..., m, p).  A batch's right-hand sides of each worker are the
    columns of one solve: broadcast against them, the factors would be
    copied once per batch row (at k = 8 on the main path, 4.3 GB)."""
    if u.dim() == chol.dim() - 1:
        return torch.cholesky_solve(u.unsqueeze(-1), chol).squeeze(-1)
    lead, (m, p) = u.shape[:-2], u.shape[-2:]
    cols = u.reshape(-1, m, p).permute(1, 2, 0)             # (m, p, K)
    y = torch.cholesky_solve(cols, chol)
    return y.permute(2, 0, 1).reshape(*lead, m, p)


def project_nullspace(A: torch.Tensor, chol: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """P_i v_i = v_i - A_i^T G_i^{-1} A_i v_i — projection onto each
    null(A_i) — for (m, p, n) blocks and per-worker (..., m, n) vectors."""
    return _project_u(A, chol, v)[0]


def _project_u(A, chol, v):
    """(P_i v_i, A_i v_i): the projection and its gather result, for
    dense or sparse (``blockops.SparseBlocks``) blocks A."""
    u = blockops.bmatvec_each(A, v)
    return v - blockops.brmatvec(A, _gram_solve(chol, u)), u


def worker_update(A: torch.Tensor, chol: torch.Tensor, state: APCState,
                  gamma: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Eq. 2a for every worker, unfused: (x_new, u) with u = A_i(x̄ − x_i)
    the gather result.  States may carry a leading (k,) batch axis."""
    d = state.xbar[..., None, :] - state.x
    proj, u = _project_u(A, chol, d)
    return state.x + gamma * proj, u


def master_update(x_new: torch.Tensor, state: APCState,
                  eta: float) -> APCState:
    """Eq. 2b: x̄ <- eta * mean_i x_i + (1 - eta) x̄."""
    xbar_new = eta * x_new.mean(dim=-2) + (1.0 - eta) * state.xbar
    return APCState(x=x_new, xbar=xbar_new, t=state.t + 1)


def apc_step(A: torch.Tensor, chol: torch.Tensor, state: APCState,
             gamma: float, eta: float) -> APCState:
    """One full unfused APC iteration (all workers + master)."""
    return master_update(worker_update(A, chol, state, gamma)[0], state,
                         eta)


def solve(sys, *, iters: int = 1000, gamma: Optional[float] = None,
          eta: Optional[float] = None, use_kernel: bool = False,
          jitter: float = 0.0):
    """Deprecated shim — delegates to ``repro_torch.solvers.get("apc")
    .solve`` (the reference's ``repro.core.apc.solve``, silent as it is).

    New code goes through the registry, which also provides
    ``solve_many`` and warm starts (``ExecutionPlan(warm_state=...)``).
    """
    from repro_torch import solvers
    return solvers.get("apc").solve(
        sys, iters=iters, plan=solvers.ExecutionPlan(kernel=use_kernel),
        gamma=gamma, eta=eta, jitter=jitter)


def __getattr__(name):
    # lazy alias of the unified result type (no import cycle at init)
    if name == "SolveResult":
        from repro_torch.solvers.api import SolveResult
        return SolveResult
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
