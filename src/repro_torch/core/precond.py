"""Distributed preconditioning (paper Section 6; counterpart of
``repro.core.precond``).

Each worker premultiplies its local system by (A_i A_i^T)^{-1/2}, locally
and in parallel (O(p^2 n) one-time work).  The transformed global system
C x = d has kappa(C^T C) = kappa(X), so distributed heavy-ball on it
attains the APC rate.  The p x p inverse square roots come from
``torch.linalg.eigh`` of all m Grams at once, in float64 on the system's
device.  ``repro_torch.solvers.get("pdhbm")`` is the solve surface;
``preconditioned_dhbm`` is its deprecated shim.
"""
from __future__ import annotations

from typing import Optional

import torch

from .partition import BlockSystem


def _inv_sqrt_psd(G: torch.Tensor) -> torch.Tensor:
    """G^{-1/2} of symmetric PD (..., p, p) matrices by eigendecomposition;
    eigenvalues are clamped at 1e-300 as in the reference, so a
    rank-deficient block gives a huge but finite factor."""
    w, V = torch.linalg.eigh(G)
    w = torch.clamp(w, min=1e-300)
    return (V / torch.sqrt(w)[..., None, :]) @ V.transpose(-1, -2)


def block_inv_sqrt(A: torch.Tensor) -> torch.Tensor:
    """S_i = (A_i A_i^T)^{-1/2} of the (m, p, n) blocks, in float64."""
    A64 = A.to(torch.float64)
    return _inv_sqrt_psd(A64 @ A64.transpose(-1, -2))


def precondition(sys: BlockSystem) -> BlockSystem:
    """The transformed system C x = d (same solution set), in the
    system's dtype on its device."""
    S = block_inv_sqrt(sys.A_blocks)
    C = S @ sys.A_blocks.to(torch.float64)
    d = torch.einsum("mpq,mq->mp", S, sys.b_blocks.to(torch.float64))
    dt = sys.A_blocks.dtype
    return BlockSystem(C.to(dt), d.to(dt), sys.x_true)


def preconditioned_dhbm(sys: BlockSystem, *, iters: int = 1000,
                        alpha: Optional[float] = None,
                        beta: Optional[float] = None):
    """Deprecated shim — delegates to ``repro_torch.solvers.get("pdhbm")``
    (the reference's, silent as it is).

    C^T C = m X exactly, so the optimal (alpha, beta) come from the
    spectrum of X without an eigensolve on C.
    """
    from repro_torch import solvers
    return solvers.get("pdhbm").solve(sys, iters=iters, alpha=alpha,
                                      beta=beta)
