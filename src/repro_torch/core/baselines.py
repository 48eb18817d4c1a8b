"""Deprecated shims for the paper's baseline solvers (Section 4).

Counterpart of ``repro.core.baselines``.  The implementations live in the
``repro_torch.solvers`` registry — one lifecycle (prepare/init/step), one
result type, ``solve_many`` and warm starts for every method.  These
wrappers keep the historical call signatures, silent as the reference's
are:

  dgd        Distributed Gradient Descent                      (Sec 4.1)
  dnag       Distributed Nesterov Accelerated Gradient         (Sec 4.2)
  dhbm       Distributed Heavy-Ball Method                     (Sec 4.3)
  madmm      Modified consensus-ADMM (y_i == 0 speedup)        (Sec 4.4)
  cimmino    Block Cimmino row-projection method               (Sec 4.5)
  consensus  Plain projection consensus of Mou/Liu/Morse [11,14]
  apc        APC via the same uniform record (benchmark drivers)

``History`` is an alias of ``repro_torch.solvers.SolveResult``.
"""
from __future__ import annotations

from typing import Optional

import torch

from .partition import BlockSystem


def _solve(name: str, sys: BlockSystem, iters: int, **params):
    from repro_torch import solvers
    return solvers.get(name).solve(sys, iters=iters, **params)


def dgd(sys: BlockSystem, *, iters: int = 1000,
        alpha: Optional[float] = None):
    """Distributed gradient descent, Eq. (8)."""
    return _solve("dgd", sys, iters, alpha=alpha)


def dnag(sys: BlockSystem, *, iters: int = 1000,
         alpha: Optional[float] = None, beta: Optional[float] = None):
    """Distributed Nesterov accelerated gradient, Eq. (10)."""
    return _solve("dnag", sys, iters, alpha=alpha, beta=beta)


def dhbm(sys: BlockSystem, *, iters: int = 1000,
         alpha: Optional[float] = None, beta: Optional[float] = None):
    """Distributed heavy-ball method, Eq. (12)."""
    return _solve("dhbm", sys, iters, alpha=alpha, beta=beta)


def madmm(sys: BlockSystem, *, iters: int = 1000, xi: float = 1.0):
    """Modified consensus-ADMM (Sec 4.4)."""
    return _solve("madmm", sys, iters, xi=xi)


def cimmino(sys: BlockSystem, *, iters: int = 1000,
            nu: Optional[float] = None):
    """Block Cimmino: r_i = A_i^+ (b_i - A_i xbar); xbar += nu sum r_i."""
    return _solve("cimmino", sys, iters, nu=nu)


def consensus(sys: BlockSystem, *, iters: int = 1000):
    """Plain projection consensus [11,14]: APC with gamma = eta = 1."""
    return _solve("consensus", sys, iters)


def apc(sys: BlockSystem, *, iters: int = 1000, gamma=None, eta=None):
    """APC through the same uniform record (for benchmark drivers)."""
    return _solve("apc", sys, iters, gamma=gamma, eta=eta)


def _full_grad(sys: BlockSystem, x: torch.Tensor) -> torch.Tensor:
    """g = A^T (A x - b), summed over workers (kept for benchmarks/tests)."""
    from repro_torch.solvers.gradient import _grad
    return _grad(sys.A_op, sys.b_blocks, x)


ALL_METHODS = {
    "DGD": dgd,
    "D-NAG": dnag,
    "D-HBM": dhbm,
    "M-ADMM": madmm,
    "B-Cimmino": cimmino,
    "Consensus": consensus,
    "APC": apc,
}


def __getattr__(name):
    # lazy alias (no import cycle at package-init time)
    if name == "History":
        from repro_torch.solvers.api import SolveResult
        return SolveResult
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
