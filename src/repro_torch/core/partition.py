"""Row-block partitioning of a linear system across workers.

Counterpart of ``repro.core.partition``.  The blocks are stacked as one
``(m, p, n)`` tensor so the worker fleet is a batch dimension, never a
Python loop over workers.  A system carries two tags beyond its blocks:

* ``mode`` — ``"square"`` (an exact solution exists; residuals measure
  ``‖Ax−b‖/‖b‖``) or ``"least_squares"`` (residuals measure the LS
  optimality, see ``solvers/api.py``), auto-resolved from the shape when
  not given (``N == n`` -> square).  Generators that build consistent
  tall systems (``b = A x_true``) tag ``mode="square"`` explicitly.
* ``structure`` — ``"dense"`` or ``"sparse"``.  A sparse system keeps the
  dense ``(m, p, n)`` stack (zeros off the support; the spectral analysis
  and ``densified()`` read it) plus a per-block column support ``cols``
  (m, w); ``A_op`` is the compressed ``SparseBlocks`` operand the solvers
  consume, gathered once per system.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch import device as dev
from repro_torch.core import blockops

MODES = ("square", "least_squares")
STRUCTURES = ("dense", "sparse")


@dataclasses.dataclass(frozen=True)
class BlockSystem:
    """A linear system ``Ax = b`` split into ``m`` row blocks.

    Attributes:
      A_blocks: (m, p, n) stacked row blocks.
      b_blocks: (m, p) stacked right-hand sides.
      x_true:   optional (n,) reference solution for error tracking.
      structure: "dense" | "sparse" (sparse adds the ``cols`` support).
      cols:     (m, w) per-block column support (sparse only), held as
                int64 on the blocks' device; padded slots point at
                all-zero columns so the compressed operand is exact.
      mode:     "square" | "least_squares"; auto-resolved from the shape
                when None (N == n -> square).

    A sparse system is checked once, here: every index must lie in
    ``[0, n)``, and an index that appears more than once in a block's
    ``cols`` must name an all-zero column of that block.  ``as_sparse``
    pads that way; the fused kernel path relies on it, because its
    scatter stores each support column's value where the reference adds
    (duplicates of a zero column all store the same value).
    """

    A_blocks: torch.Tensor
    b_blocks: torch.Tensor
    x_true: Optional[torch.Tensor] = None
    structure: str = "dense"
    cols: Optional[torch.Tensor] = None
    mode: Optional[str] = None

    def __post_init__(self):
        if self.structure not in STRUCTURES:
            raise ValueError(f"structure={self.structure!r} not in "
                             f"{STRUCTURES}")
        if self.structure == "sparse":
            if self.cols is None:
                raise ValueError("sparse systems need a (m, w) cols support; "
                                 "build one with partition.as_sparse()")
            cols = torch.as_tensor(self.cols, device=self.device).to(
                torch.int64).contiguous()
            object.__setattr__(self, "cols", cols)
            _check_support(self.A_blocks, cols)
        if self.mode is None:
            object.__setattr__(
                self, "mode",
                "square" if self.N == self.n else "least_squares")
        elif self.mode not in MODES:
            raise ValueError(f"mode={self.mode!r} not in {MODES}")

    @property
    def m(self) -> int:
        return self.A_blocks.shape[0]

    @property
    def p(self) -> int:
        return self.A_blocks.shape[1]

    @property
    def n(self) -> int:
        return self.A_blocks.shape[2]

    @property
    def N(self) -> int:
        return self.m * self.p

    @property
    def device(self) -> torch.device:
        return self.A_blocks.device

    @property
    def is_sparse(self) -> bool:
        return self.structure == "sparse"

    @functools.cached_property
    def A_op(self):
        """The operand the solvers consume: the dense (m, p, n) stack, or
        the compressed ``SparseBlocks`` support of a sparse system
        (gathered on first use and kept)."""
        if not self.is_sparse:
            return self.A_blocks
        m, p, _ = self.A_blocks.shape
        vals = torch.take_along_dim(
            self.A_blocks, self.cols[:, None, :].expand(m, p, -1), dim=2)
        return blockops.SparseBlocks(
            vals=vals, cols=self.cols,
            span=self.A_blocks.new_zeros((self.n,)))

    @property
    def sparsity(self) -> float:
        """Fraction of exactly-zero entries in the block stack."""
        return float((self.A_blocks == 0).sum()) / self.A_blocks.numel()

    def densified(self) -> "BlockSystem":
        """The same system on the dense execution path (parity twin)."""
        return dataclasses.replace(self, structure="dense", cols=None)

    def dense(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Reassemble the global ``(N, n)`` system."""
        return (self.A_blocks.reshape(self.N, self.n),
                self.b_blocks.reshape(self.N))


def _check_support(A_blocks: torch.Tensor, cols: torch.Tensor) -> None:
    """The sparse-system contract, checked once at construction (one
    host read): cols is (m, w) with indices in [0, n), and a repeated
    index in a block names an all-zero column of that block."""
    m, _, n = A_blocks.shape
    if cols.dim() != 2 or cols.shape[0] != m or cols.shape[1] < 1:
        raise ValueError(f"cols has shape {tuple(cols.shape)}; expected "
                         f"({m}, w) with w >= 1")
    if bool((cols < 0).any()) or bool((cols >= n).any()):
        raise ValueError(f"cols holds indices outside [0, {n})")
    s = cols.sort(dim=1).values
    dup = s[:, 1:] == s[:, :-1]                        # (m, w - 1)
    rows, pos = dup.nonzero(as_tuple=True)
    if rows.numel() and bool((A_blocks[rows, :, s[rows, pos]] != 0).any()):
        raise ValueError(
            "cols repeats a column that is nonzero in its block; a block "
            "may repeat only an all-zero column (partition.as_sparse pads "
            "that way), since the sparse kernels store, not add, at each "
            "support column")


def partition(A, b, m: int, *, x_true=None, mode=None,
              device=None) -> BlockSystem:
    """Split ``Ax=b`` into ``m`` even row blocks (the paper's Figure 1).

    Raises if ``m`` does not divide ``N`` (pad upstream with
    :func:`pad_to_blocks`).  Tensors stay on their device unless
    ``device=`` is given; numpy inputs go to the resolved device.
    """
    A = dev.as_tensor(A, device=device)
    b = dev.as_tensor(b, device=A.device)
    N, n = A.shape
    if N % m != 0:
        raise ValueError(f"m={m} must divide N={N}; use pad_to_blocks() first")
    p = N // m
    return BlockSystem(A.reshape(m, p, n), b.reshape(m, p),
                       None if x_true is None
                       else dev.as_tensor(x_true, device=A.device),
                       mode=mode)


def support_cols(support: np.ndarray) -> np.ndarray:
    """The (m, w) int64 ``cols`` of an (m, n) boolean support mask: each
    block's sorted support, padded to the widest block (w >= 1) with the
    block's first all-zero column, as the reference's ``as_sparse``."""
    m = support.shape[0]
    w = max(int(support.sum(axis=1).max()), 1)
    cols = np.zeros((m, w), np.int64)
    for i in range(m):
        idx = np.flatnonzero(support[i])
        if idx.size < w:
            # an all-zero column: its gathered values are exact zeros
            pad = np.flatnonzero(~support[i])[0]
            idx = np.concatenate([idx, np.full(w - idx.size, pad)])
        cols[i] = idx
    return cols


def as_sparse(sys_: BlockSystem) -> BlockSystem:
    """Tag a system sparse, deriving each block's column support from its
    nonzero pattern (the support mask is computed on the system's device;
    only the (m, n) mask comes to the host)."""
    support = (sys_.A_blocks != 0).any(dim=1).cpu().numpy()
    return dataclasses.replace(
        sys_, structure="sparse",
        cols=torch.as_tensor(support_cols(support), device=sys_.device))


def pad_to_blocks(A, b, m: int, *, device=None):
    """Pad (A, b) with duplicated rows so that m | N.

    Duplicating an existing row keeps the solution set unchanged (the
    system stays consistent) while making the even split legal; the
    duplicates are spread across distinct source rows.
    """
    A = dev.as_tensor(A, device=device)
    b = dev.as_tensor(b, device=A.device)
    N = A.shape[0]
    rem = (-N) % m
    if rem == 0:
        return A, b
    idx = torch.as_tensor(np.arange(rem) % N, device=A.device)
    return torch.cat([A, A[idx]], dim=0), torch.cat([b, b[idx]], dim=0)
