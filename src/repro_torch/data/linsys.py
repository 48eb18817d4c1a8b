"""Dense linear-system generators for the APC experiments.

Counterpart of the dense generators of ``repro.data.linsys``.  Every
generator draws the same numpy arrays in the same order as the
reference, so for the same seed the float64 systems are bit-identical;
the arrays then move to ``device`` (``cuda`` unless the caller passes
``device="cpu"``).  The sparse generators and ``tall_gaussian(noise>0)``
(least-squares systems) are ROADMAP item A9.

All generators return a ``BlockSystem`` carrying the ground truth
``x_true`` so the relative error can be tracked.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import device as dev
from repro_torch.core.partition import BlockSystem, partition
from repro_torch.device import DEFAULT_DTYPE


def _finalize(A: np.ndarray, m: int, rng: np.random.Generator,
              dtype, device) -> BlockSystem:
    """Draw x*, form b = A x*, partition into m row blocks.

    The system is consistent by construction (b = A x*), so it is tagged
    ``mode="square"`` even when tall.
    """
    _, n = A.shape
    x_true = rng.standard_normal(n)
    b = A @ x_true
    t = lambda a: torch.as_tensor(a).to(dtype)       # noqa: E731
    return partition(t(A), t(b), m, x_true=t(x_true), mode="square",
                     device=dev.resolve(device))


# ---------------------------------------------------------------------------
# Random ensembles (paper Table 2 rows 4-6)
# ---------------------------------------------------------------------------


def standard_gaussian(n: int = 500, m: int = 4, *, N: Optional[int] = None,
                      seed: int = 0, dtype=DEFAULT_DTYPE,
                      device=None) -> BlockSystem:
    """i.i.d. N(0,1) entries.  Paper: 'STANDARD GAUSSIAN (500x500)'."""
    rng = np.random.default_rng(seed)
    N = n if N is None else N
    A = rng.standard_normal((N, n))
    return _finalize(A, m, rng, dtype, device)


def nonzero_mean_gaussian(n: int = 500, m: int = 4, *, mean: float = 1.0,
                          N: Optional[int] = None, seed: int = 0,
                          dtype=DEFAULT_DTYPE, device=None) -> BlockSystem:
    """N(mean, 1) entries — the paper's largest APC gap (Table 2 row 5)."""
    rng = np.random.default_rng(seed)
    N = n if N is None else N
    A = rng.standard_normal((N, n)) + mean
    return _finalize(A, m, rng, dtype, device)


def tall_gaussian(N: int = 1000, n: int = 500, m: int = 4, *, seed: int = 0,
                  noise: float = 0.0, dtype=DEFAULT_DTYPE,
                  device=None) -> BlockSystem:
    """Overdetermined consistent Gaussian system.  Paper: 'STANDARD TALL
    GAUSSIAN'.  ``noise > 0`` (an inconsistent least-squares system) is
    ROADMAP item A9."""
    if noise != 0.0:
        raise NotImplementedError(
            "tall_gaussian(noise>0) builds a least-squares system, which "
            "is not ported yet (ROADMAP A9)")
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((N, n))
    return _finalize(A, m, rng, dtype, device)


# ---------------------------------------------------------------------------
# Spectrum-controlled proxies for the Matrix Market problems
# ---------------------------------------------------------------------------


def _spectrum_matrix(N: int, n: int, singvals: np.ndarray,
                     rng: np.random.Generator) -> np.ndarray:
    """A = U diag(s) V^T with Haar-random U, V and prescribed spectrum."""
    k = min(N, n)
    U, _ = np.linalg.qr(rng.standard_normal((N, k)))
    V, _ = np.linalg.qr(rng.standard_normal((n, k)))
    return (U * singvals) @ V.T


def _log_spectrum(k: int, cond: float) -> np.ndarray:
    """Log-uniformly spaced singular values in [1/cond, 1]."""
    return np.logspace(0.0, -np.log10(cond), k)


@dataclasses.dataclass(frozen=True)
class MatrixMarketProxy:
    name: str
    N: int
    n: int
    cond: float        # target kappa(A) — matches the published problem class
    m: int             # workers used in the paper's figures


# The same proxies as the reference (see repro.data.linsys for how each
# condition number follows from the paper's published DGD times).
MM_PROXIES = {
    "qc324": MatrixMarketProxy("QC324", 324, 324, 5.0e3, 4),
    "orsirr1": MatrixMarketProxy("ORSIRR 1", 1030, 1030, 7.7e4, 4),
    "ash608": MatrixMarketProxy("ASH608", 608, 188, 3.0, 4),
}


def matrix_market_proxy(key: str, m: Optional[int] = None, *, seed: int = 0,
                        dtype=DEFAULT_DTYPE, device=None) -> BlockSystem:
    """Spectrum-matched proxy for a Matrix Market problem."""
    spec = MM_PROXIES[key]
    rng = np.random.default_rng(seed)
    N, n = spec.N, spec.n
    m = spec.m if m is None else m
    rem = (-N) % m                  # pad N up so m | N by duplicated rows
    s = _log_spectrum(min(N, n), spec.cond)
    A = _spectrum_matrix(N, n, s, rng)
    if rem:
        idx = rng.integers(0, N, size=rem)
        A = np.concatenate([A, A[idx] * 1.0], axis=0)
    return _finalize(A, m, rng, dtype, device)


def conditioned_gaussian(n: int, m: int, cond: float, *, seed: int = 0,
                         N: Optional[int] = None, dtype=DEFAULT_DTYPE,
                         device=None) -> BlockSystem:
    """Gaussian-basis matrix with exactly prescribed condition number."""
    rng = np.random.default_rng(seed)
    N = n if N is None else N
    s = _log_spectrum(min(N, n), cond)
    A = _spectrum_matrix(N, n, s, rng)
    return _finalize(A, m, rng, dtype, device)


# The dense entries of the reference's ALL_PROBLEMS; each takes the seed
# plus the port's dtype=/device=.
ALL_PROBLEMS = {
    "qc324": lambda seed=0, **kw: matrix_market_proxy("qc324", seed=seed,
                                                      **kw),
    "orsirr1": lambda seed=0, **kw: matrix_market_proxy("orsirr1",
                                                        seed=seed, **kw),
    "ash608": lambda seed=0, **kw: matrix_market_proxy("ash608", seed=seed,
                                                       **kw),
    "std_gaussian": lambda seed=0, **kw: standard_gaussian(seed=seed, **kw),
    "nonzero_mean": lambda seed=0, **kw: nonzero_mean_gaussian(seed=seed,
                                                               **kw),
    "tall_gaussian": lambda seed=0, **kw: tall_gaussian(seed=seed, **kw),
}
