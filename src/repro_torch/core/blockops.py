"""Block-matrix operations over dense or block-sparse worker blocks.

Counterpart of ``repro.core.blockops``: the solvers express their
per-iteration linear algebra through this small operator set, so one
code path serves the dense ``(m, p, n)`` stack and the compressed
:class:`SparseBlocks` operand.  The dense branches are ``torch.einsum``
contractions; the sparse branches touch only each block's supported
columns, gathering with ``torch.take_along_dim``/indexing and scattering
back with ``scatter_add``/``index_add`` on int64 indices.  These are the
plain, unfused sparse path; the fused one is ``kernels.ops``.

Blocks stored in a narrower dtype than the vector they meet (bfloat16
under ``precision="mixed"``) are promoted to the vector's dtype first,
as JAX's promotion does; ``torch.einsum`` would refuse the pair.

Every operation is batch-polymorphic: vectors may carry leading batch
axes (x (n,) or (k, n); per-block (m, n) or (k, m, n); (m, p) or
(k, m, p)), as the port's solvers write the reference's vmaps out.

Representation (as in the reference).  Block ``i`` of a sparse system
stores its ``w`` supported column indices ``cols[i]`` and the ``(p, w)``
values on that support.  Blocks with a smaller support are padded to the
common ``w`` with the index of one all-zero column, so padded entries
carry exact zeros and every contraction below is exact without masks.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class SparseBlocks(NamedTuple):
    """Block-sparse operand: per-block column support + values.

    Attributes:
      vals: (m, p, w) values of each block on its column support.
      cols: (m, w) int64 global column indices on the same device;
        padded slots point at all-zero columns, so their values are
        exact zeros.
      span: (n,) zeros, the carrier of the global column count, which no
        other field records.
    """

    vals: torch.Tensor
    cols: torch.Tensor
    span: torch.Tensor


def is_sparse(A) -> bool:
    return isinstance(A, SparseBlocks)


def ncols(A) -> int:
    """Global column count ``n`` of either operand kind."""
    return A.span.shape[0] if is_sparse(A) else A.shape[2]


def block_shape(A) -> tuple[int, int]:
    """(m, p) of either operand kind."""
    return tuple((A.vals if is_sparse(A) else A).shape[:2])


def block_dtype(A) -> torch.dtype:
    """Element dtype of either operand kind."""
    return A.vals.dtype if is_sparse(A) else A.dtype


def _promoted(V: torch.Tensor, x: torch.Tensor):
    """(V, x) in their promoted dtype (no copy where it is theirs)."""
    dt = torch.promote_types(V.dtype, x.dtype)
    return V.to(dt), x.to(dt)


def _gather(A: SparseBlocks, D: torch.Tensor) -> torch.Tensor:
    """Per-block support columns of (..., m, n) D -> (..., m, w)."""
    return torch.take_along_dim(D, A.cols.expand(D.shape[:-1] + (-1,)),
                                dim=-1)


def _contr(A: SparseBlocks, u: torch.Tensor) -> torch.Tensor:
    """A_iᵀ u_i on the support: (..., m, p) -> (..., m, w)."""
    return torch.einsum("mpw,...mp->...mw", *_promoted(A.vals, u))


def bmatvec(A, x):
    """Per-block matvec ``A_i x`` -> (..., m, p) for a shared (..., n) x."""
    if is_sparse(A):
        return torch.einsum("mpw,...mw->...mp",
                            *_promoted(A.vals, x[..., A.cols]))
    return torch.einsum("mpn,...n->...mp", *_promoted(A, x))


def bmatvec_each(A, D):
    """Per-block matvec ``A_i d_i`` -> (..., m, p) for per-block
    (..., m, n) D."""
    if is_sparse(A):
        return torch.einsum("mpw,...mw->...mp",
                            *_promoted(A.vals, _gather(A, D)))
    return torch.einsum("mpn,...mn->...mp", *_promoted(A, D))


def bmatvec_many(A, X):
    """Batched ``A_i x_k`` -> (k, m, p) for a (k, n) RHS batch."""
    return bmatvec(A, X)


def brmatvec(A, u):
    """Per-block transpose matvec ``A_i^T u_i`` -> (..., m, n)."""
    if is_sparse(A):
        c = _contr(A, u)
        out = c.new_zeros(c.shape[:-1] + (ncols(A),))
        return out.scatter_add_(-1, A.cols.expand(c.shape), c)
    return torch.einsum("mpn,...mp->...mn", *_promoted(A, u))


def brmatvec_sum(A, u):
    """Summed transpose matvec ``sum_i A_i^T u_i`` -> (..., n)."""
    if is_sparse(A):
        c = _contr(A, u)
        out = c.new_zeros(c.shape[:-2] + (ncols(A),))
        return out.index_add_(-1, A.cols.reshape(-1),
                              c.reshape(c.shape[:-2] + (-1,)))
    return torch.einsum("mpn,...mp->...n", *_promoted(A, u))


def brmatvec_sum_many(A, U):
    """Batched summed transpose matvec -> (k, n) for (k, m, p) U."""
    return brmatvec_sum(A, U)


def bgram(A):
    """Per-block Gram ``A_i A_i^T`` -> (m, p, p); exact for sparse
    operands, whose padded columns hold zeros."""
    V = A.vals if is_sparse(A) else A
    return V @ V.transpose(-1, -2)


def densify(A):
    """A ``SparseBlocks`` operand as the dense (m, p, n) stack."""
    if not is_sparse(A):
        return A
    m, p, w = A.vals.shape
    out = A.vals.new_zeros((m, p, ncols(A)))
    return out.scatter_add_(2, A.cols[:, None, :].expand(m, p, w), A.vals)
