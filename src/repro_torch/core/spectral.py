"""Spectral analysis and the optimal APC hyper-parameters (Theorem 1).

Counterpart of ``repro.core.spectral`` for what the APC solver needs:
``x_matrix``, ``mu_extremes``, ``apc_optimal`` and ``convergence_time``.
Analysis-time work, done once per system: X and its eigenvalues are
computed with torch on the system's device in float64 (the reference's
numpy loop would take minutes at the sizes one card solves).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .partition import BlockSystem


def x_matrix(sys: BlockSystem) -> torch.Tensor:
    """X = (1/m) sum_i A_i^T (A_i A_i^T)^{-1} A_i  (n x n, symmetric PSD).

    Accumulated one worker at a time, so the transient memory is one
    (p, n) solve beside the (n, n) result.
    """
    A = sys.A_blocks.to(torch.float64)
    m, _, n = A.shape
    X = torch.zeros((n, n), dtype=torch.float64, device=A.device)
    for i in range(m):
        Ai = A[i]
        G = Ai @ Ai.T                                  # (p, p) Gram
        X.addmm_(Ai.T, torch.linalg.solve(G, Ai))
    return X / m


def mu_extremes(X: torch.Tensor) -> tuple[float, float]:
    """(mu_min, mu_max) of X.  Eigenvalues lie in [0, 1]."""
    w = torch.linalg.eigvalsh(X)
    return float(w[0]), float(w[-1])


@dataclasses.dataclass(frozen=True)
class APCParams:
    gamma: float
    eta: float
    rho: float  # optimal spectral radius (convergence rate)


def apc_optimal(mu_min: float, mu_max: float) -> APCParams:
    """Solve Theorem 1's optimality system.

      mu_max * eta * gamma = (1 + rho)^2
      mu_min * eta * gamma = (1 - rho)^2,   rho = sqrt((gamma-1)(eta-1))

    Dividing gives rho = (sqrt(kappa)-1)/(sqrt(kappa)+1).  With
    s = eta*gamma = (1+rho)^2/mu_max and gamma + eta = s + 1 - rho^2,
    gamma and eta are the two roots of z^2 - (s + 1 - rho^2) z + s = 0.
    """
    if mu_min <= 0:
        raise ValueError("mu_min must be > 0 (system must be solvable)")
    k = mu_max / mu_min
    rho = (math.sqrt(k) - 1.0) / (math.sqrt(k) + 1.0)
    s = (1.0 + rho) ** 2 / mu_max           # eta * gamma
    q = s + 1.0 - rho ** 2                  # eta + gamma
    disc = max(q * q - 4.0 * s, 0.0)        # numeric guard at mu_max == 1
    r = math.sqrt(disc)
    z2 = (q + r) / 2.0                      # large root: no cancellation
    z1 = s / z2 if z2 > 0 else 0.0          # small root via z1 * z2 = s
    # gamma must lie in [0, 2]; the smaller root does
    gamma, eta = (z1, z2) if z1 <= 2.0 else (z2, z1)
    return APCParams(gamma=gamma, eta=eta, rho=rho)


def convergence_time(rho: float) -> float:
    """T = 1 / (-log rho)   (paper Section 5; ~ 1/(1-rho))."""
    if rho >= 1.0:
        return float("inf")
    if rho <= 0.0:
        return 0.0
    return 1.0 / (-math.log(rho))
