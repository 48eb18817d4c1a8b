"""Block-matrix operations over the dense ``(m, p, n)`` worker blocks.

Counterpart of the dense half of ``repro.core.blockops``: the same
contractions, written as ``torch.einsum``.  The sparse ``SparseBlocks``
operand is ROADMAP item A9.
"""
from __future__ import annotations

import torch


def bmatvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-block matvec ``A_i x`` -> (m, p) for a shared ``(n,)`` x."""
    return torch.einsum("mpn,n->mp", A, x)


def bmatvec_each(A: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """Per-block matvec ``A_i d_i`` -> (m, p) for per-block ``(m, n)`` D."""
    return torch.einsum("mpn,mn->mp", A, D)


def bmatvec_many(A: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Batched ``A_i x_k`` -> (k, m, p) for a ``(k, n)`` RHS batch."""
    return torch.einsum("mpn,kn->kmp", A, X)


def brmatvec(A: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Per-block transpose matvec ``A_i^T u_i`` -> (m, n)."""
    return torch.einsum("mpn,mp->mn", A, u)


def brmatvec_sum(A: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Summed transpose matvec ``sum_i A_i^T u_i`` -> (n,)."""
    return torch.einsum("mpn,mp->n", A, u)


def bgram(A: torch.Tensor) -> torch.Tensor:
    """Per-block Gram ``A_i A_i^T`` -> (m, p, p)."""
    return torch.einsum("mpn,mqn->mpq", A, A)
