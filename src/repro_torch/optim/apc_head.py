"""APC as a least-squares engine inside the LM framework (the port's
counterpart of ``repro.optim.apc_head``).

Closed-form fits of linear maps on top of frozen hidden states — linear
probes, LM-head calibration, value heads — are ridge problems
``min_w ||H w - y||^2 + lam ||w||^2`` whose normal equations
``(H^T H + lam I) w = H^T y`` are the paper's setting: ``fit_probe``
builds the (n x n) normal system in float64 and solves it by APC over m
row blocks (the port's ``core.apc.solve``), m reduced until it divides n
(the paper's even split).
"""
from __future__ import annotations

import torch

from repro_torch import device as dev
from repro_torch.core import apc, partition


def normal_system(H: torch.Tensor, y: torch.Tensor, lam: float = 1e-3):
    """Form (A, b) = (H^T H + lam I, H^T y) for the ridge normal equations.

    H (T, n) hidden states, y (T,) regression target (one column of Y).
    """
    n = H.shape[1]
    A = H.T @ H + lam * torch.eye(n, dtype=H.dtype, device=H.device)
    b = H.T @ y
    return A, b


def fit_probe(H, y, *, m: int = 8, lam: float = 1e-3, iters: int = 500,
              dtype: torch.dtype = torch.float64, device=None):
    """Fit w = argmin ||H w - y||^2 + lam||w||^2 via APC on the normal
    equations, distributed over m row-blocks.  Returns (w,
    residual_history).  H and y go to ``device`` (a tensor without one
    stays where it is; anything else resolves to ``cuda`` unless asked
    otherwise) in ``dtype``."""
    H = dev.as_tensor(H, device=device).to(dtype)
    y = dev.as_tensor(y, device=H.device).to(dtype)
    A, b = normal_system(H, y, lam)
    n = A.shape[0]
    mm = m
    while n % mm != 0:           # keep the paper's even-split assumption
        mm -= 1
    sys_ = partition.partition(A, b, mm)
    res = apc.solve(sys_, iters=iters)
    return res.x, res.residuals


def probe_loss(H, y, w) -> float:
    r = H @ w - y
    return float(torch.mean(r * r))
