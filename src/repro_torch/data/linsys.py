"""Linear-system generators for the APC experiments.

Counterpart of ``repro.data.linsys``: the dense ensembles and
Matrix-Market proxies, the least-squares ``tall_gaussian(noise>0)`` and
the block-sparse ensembles.  Every generator draws the same numpy arrays
in the same order as the reference, so for the same seed the float64
systems are bit-identical; the arrays then move to ``device`` (``cuda``
unless the caller passes ``device="cpu"``).

All generators return a ``BlockSystem`` carrying the ground truth
``x_true`` so the relative error can be tracked.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import device as dev
from repro_torch.core.partition import BlockSystem, as_sparse, partition
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
    """Overdetermined Gaussian system.  Paper: 'STANDARD TALL GAUSSIAN'.

    With ``noise=0`` the system is consistent by construction (``b = A
    x*``, mode ``"square"``), the paper's setting.  ``noise > 0`` adds
    ``noise * e`` (i.i.d. standard normal ``e``) to ``b``: the system is
    then inconsistent, tagged ``mode="least_squares"``, and ``x_true`` is
    the LS optimum ``argmin ‖Ax−b‖`` (numpy ``lstsq`` on the host).
    """
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((N, n))
    if noise == 0.0:
        return _finalize(A, m, rng, dtype, device)
    x_star = rng.standard_normal(n)          # same draw order as _finalize
    b = A @ x_star + noise * rng.standard_normal(N)
    x_ls = np.linalg.lstsq(A, b, rcond=None)[0]
    t = lambda a: torch.as_tensor(a).to(dtype)       # noqa: E731
    return partition(t(A), t(b), m, x_true=t(x_ls), mode="least_squares",
                     device=dev.resolve(device))


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


# ---------------------------------------------------------------------------
# Block-sparse ensembles
# ---------------------------------------------------------------------------


def banded_system(n: int = 512, m: int = 4, *, bandwidth: int = 8,
                  seed: int = 0, dtype=DEFAULT_DTYPE,
                  device=None) -> BlockSystem:
    """Diagonally-dominant banded system (half-bandwidth ``bandwidth``).

    Each worker block touches only ~``p + 2*bandwidth`` of the ``n``
    columns, so the compressed sparse operand does a small fraction of
    the dense work; dominance keeps the system well conditioned.

    The same draws and the same floating-point sums as the reference
    (its ``A += np.diag(d, k=off)`` places each diagonal into zeros, and
    a row sum over a C-contiguous array is computed row by row), without
    its n x n temporaries: those take minutes at n = 32768.
    """
    rng = np.random.default_rng(seed)
    A = np.zeros((n, n))
    for off in range(-bandwidth, bandwidth + 1):
        d = rng.standard_normal(n - abs(off))
        i = np.arange(n - abs(off))
        A[i + max(-off, 0), i + max(off, 0)] = d
    diag = np.empty(n)
    for r0 in range(0, n, 1024):                     # row sums in slabs
        diag[r0:r0 + 1024] = np.abs(A[r0:r0 + 1024]).sum(axis=1) + 1.0
    A[np.arange(n), np.arange(n)] += diag            # dominance
    return as_sparse(_finalize(A, m, rng, dtype, device))


def block_sparse_system(n: int = 512, m: int = 4, *, density: float = 0.1,
                        seed: int = 0, dtype=DEFAULT_DTYPE,
                        device=None) -> BlockSystem:
    """Each worker block supported on its own random ``density * n``-column
    subset (every column covered by at least one block, so the system
    stays structurally square); Gaussian values on the support."""
    if not 0.0 < density <= 1.0:
        raise ValueError(f"density={density} not in (0, 1]")
    rng = np.random.default_rng(seed)
    if n % m:
        raise ValueError(f"m={m} must divide n={n}")
    p = n // m
    w = max(int(round(density * n)), p)
    A = np.zeros((n, n))
    owners = rng.permutation(n).reshape(m, p)        # cover every column
    for i in range(m):
        extra = np.setdiff1d(np.arange(n), owners[i], assume_unique=False)
        pick = np.concatenate(
            [owners[i], rng.choice(extra, size=w - p, replace=False)])
        block = np.zeros((p, n))
        block[:, np.sort(pick)] = rng.standard_normal((p, w))
        A[i * p:(i + 1) * p] = block
    return as_sparse(_finalize(A, m, rng, dtype, device))


def sparse_matrix_market_proxy(key: str, m: Optional[int] = None, *,
                               bandwidth: int = 8, seed: int = 0,
                               dtype=DEFAULT_DTYPE,
                               device=None) -> BlockSystem:
    """Sparse spectrum-controlled proxy for a Matrix Market problem: the
    log-spaced spectrum on the generalized diagonal plus a banded
    perturbation well below the smallest singular value.  Tall problems
    (ASH608) duplicate rows to reach ``m | N``, as
    :func:`matrix_market_proxy` does."""
    spec = MM_PROXIES[key]
    rng = np.random.default_rng(seed)
    N, n = spec.N, spec.n
    m = spec.m if m is None else m
    k = min(N, n)
    s = _log_spectrum(k, spec.cond)
    A = np.zeros((N, n))
    A[np.arange(k), np.arange(k)] = s
    if N > k:                                        # tall: duplicate rows
        A[k:] = A[np.arange(N - k) % k]
    eps = 0.02 * s.min()
    rows = np.arange(N)[:, None]
    cols = np.arange(-bandwidth, bandwidth + 1)[None, :] + (
        rows * n) // max(N, 1)
    valid = (cols >= 0) & (cols < n)
    pert = eps * rng.standard_normal(cols.shape) * valid
    np.add.at(A, (np.broadcast_to(rows, cols.shape)[valid],
                  cols[valid]), pert[valid])
    rem = (-A.shape[0]) % m
    if rem:
        idx = rng.integers(0, A.shape[0], size=rem)
        A = np.concatenate([A, A[idx] * 1.0], axis=0)
    return as_sparse(_finalize(A, m, rng, dtype, device))


# The reference's ALL_PROBLEMS; each entry takes the seed plus the port's
# dtype=/device=.
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
    "tall_noisy": lambda seed=0, **kw: tall_gaussian(seed=seed, noise=0.5,
                                                     **kw),
    "banded": lambda seed=0, **kw: banded_system(seed=seed, **kw),
    "block_sparse": lambda seed=0, **kw: block_sparse_system(seed=seed,
                                                             **kw),
    "qc324_sparse": lambda seed=0, **kw: sparse_matrix_market_proxy(
        "qc324", seed=seed, **kw),
    "ash608_sparse": lambda seed=0, **kw: sparse_matrix_market_proxy(
        "ash608", seed=seed, **kw),
}
