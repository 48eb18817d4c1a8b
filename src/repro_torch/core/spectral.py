"""Spectral analysis and the optimal hyper-parameters of every solver.

Counterpart of ``repro.core.spectral``: the X matrix and its extremes,
the extremes of AᵀA, Theorem 1's APC optimum and the Section-4 closed
forms of the baselines, and ``rates_summary``.  Analysis-time work, done
once per system: X, AᵀA and their eigenvalues are computed with torch on
the system's device in float64 (the reference's numpy loop would take
minutes at the sizes one card solves).
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
    return X.div_(m)


# cuSOLVER's syevd, PyTorch's default eigensolver on CUDA, rejects an
# n = 32768 matrix (CUSOLVER_STATUS_INVALID_VALUE from its buffer-size
# query; torch 2.11 with CUDA 12.8 on an H100); MAGMA's solves it.
_CUSOLVER_EIGH_MAX_N = 32767


def eigvalsh(M: torch.Tensor) -> torch.Tensor:
    """Ascending eigenvalues of the symmetric matrix M, by MAGMA for a
    CUDA matrix larger than cuSOLVER takes, else by PyTorch's default."""
    if not (M.is_cuda and M.shape[-1] > _CUSOLVER_EIGH_MAX_N):
        return torch.linalg.eigvalsh(M)
    backend = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("magma")
    try:
        return torch.linalg.eigvalsh(M)
    finally:
        torch.backends.cuda.preferred_linalg_library(backend)


def mu_extremes(X: torch.Tensor) -> tuple[float, float]:
    """(mu_min, mu_max) of X.  Eigenvalues lie in [0, 1]."""
    w = eigvalsh(X)
    return float(w[0]), float(w[-1])


def kappa(X: torch.Tensor) -> float:
    """Condition number mu_max / mu_min of X."""
    mu_min, mu_max = mu_extremes(X)
    return mu_max / mu_min


def ata_extremes(sys: BlockSystem) -> tuple[float, float]:
    """(lambda_min, lambda_max) of AᵀA — drives the gradient-family rates."""
    A = sys.dense()[0].to(torch.float64)
    w = eigvalsh(A.T @ A)
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


def apc_rate(mu_min: float, mu_max: float) -> float:
    """Theorem 1's optimal APC rate rho for the extremes of X."""
    return apc_optimal(mu_min, mu_max).rho


def dgd_optimal(lmin: float, lmax: float) -> tuple[float, float]:
    """(alpha*, rho*) for distributed gradient descent on ||Ax-b||^2:
    alpha = 2/(lmin+lmax), rho = (kappa-1)/(kappa+1)."""
    alpha = 2.0 / (lmin + lmax)
    rho = (lmax - lmin) / (lmax + lmin)
    return alpha, rho


def dnag_optimal(lmin: float, lmax: float) -> tuple[float, float, float]:
    """(alpha*, beta*, rho*) for Nesterov on a quadratic (Lessard et al.):
    alpha = 4/(3 lmax + lmin), beta = (s-2)/(s+2), rho = 1 - 2/s with
    s = sqrt(3 kappa + 1)."""
    k = lmax / lmin
    alpha = 4.0 / (3.0 * lmax + lmin)
    s = math.sqrt(3.0 * k + 1.0)
    beta = (s - 2.0) / (s + 2.0)
    rho = 1.0 - 2.0 / s
    return alpha, beta, rho


def dhbm_optimal(lmin: float, lmax: float) -> tuple[float, float, float]:
    """(alpha*, beta*, rho*) for heavy-ball on a quadratic (Polyak):
    alpha = (2/(sqrt(lmax)+sqrt(lmin)))^2, beta = rho^2,
    rho = (sqrt(kappa)-1)/(sqrt(kappa)+1)."""
    sl, sm = math.sqrt(lmax), math.sqrt(lmin)
    alpha = (2.0 / (sl + sm)) ** 2
    rho = (sl - sm) / (sl + sm)
    return alpha, rho ** 2, rho


def cimmino_optimal(mu_min: float, mu_max: float) -> tuple[float, float]:
    """(nu*m, rho*) for block Cimmino: the error iteration is
    e <- (I - nu m X) e, optimal at nu m = 2/(mu_min+mu_max) with
    rho = (kappa-1)/(kappa+1).  The caller divides by m."""
    nu_m = 2.0 / (mu_min + mu_max)
    rho = (mu_max - mu_min) / (mu_max + mu_min)
    return nu_m, rho


def consensus_rate(mu_min: float) -> float:
    """Plain projection consensus: rho = 1 - mu_min(X)."""
    return 1.0 - mu_min


def convergence_time(rho: float) -> float:
    """T = 1 / (-log rho)   (paper Section 5; ~ 1/(1-rho))."""
    if rho >= 1.0:
        return float("inf")
    if rho <= 0.0:
        return 0.0
    return 1.0 / (-math.log(rho))


def rates_summary(sys: BlockSystem) -> dict[str, float]:
    """Optimal convergence rates of every method in the paper for ``sys``
    (the reference's keys)."""
    mu_min, mu_max = mu_extremes(x_matrix(sys))
    lmin, lmax = ata_extremes(sys)
    return {
        "mu_min": mu_min,
        "mu_max": mu_max,
        "kappa_X": mu_max / mu_min,
        "kappa_AtA": lmax / lmin,
        "DGD": dgd_optimal(lmin, lmax)[1],
        "D-NAG": dnag_optimal(lmin, lmax)[2],
        "D-HBM": dhbm_optimal(lmin, lmax)[2],
        "Consensus": consensus_rate(mu_min),
        "B-Cimmino": cimmino_optimal(mu_min, mu_max)[1],
        "APC": apc_optimal(mu_min, mu_max).rho,
    }
