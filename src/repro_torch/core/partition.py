"""Row-block partitioning of a linear system across workers.

Counterpart of ``repro.core.partition``, dense structure only.  The
blocks are stacked as one ``(m, p, n)`` tensor so the worker fleet is a
batch dimension, never a Python loop over workers.

``mode`` is ``"square"`` (an exact solution exists; residuals measure
``‖Ax−b‖/‖b‖``) or ``"least_squares"``, auto-resolved from the shape when
not given (``N == n`` -> square).  Generators that build consistent tall
systems (``b = A x_true``) tag ``mode="square"`` explicitly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import device as dev

MODES = ("square", "least_squares")
STRUCTURES = ("dense", "sparse")


@dataclasses.dataclass(frozen=True)
class BlockSystem:
    """A linear system ``Ax = b`` split into ``m`` row blocks.

    Attributes:
      A_blocks: (m, p, n) stacked row blocks.
      b_blocks: (m, p) stacked right-hand sides.
      x_true:   optional (n,) reference solution for error tracking.
      structure: "dense" (the sparse structure is ROADMAP item A9).
      mode:     "square" | "least_squares"; auto-resolved from the shape
                when None (N == n -> square).
    """

    A_blocks: torch.Tensor
    b_blocks: torch.Tensor
    x_true: Optional[torch.Tensor] = None
    structure: str = "dense"
    mode: Optional[str] = None

    def __post_init__(self):
        if self.structure not in STRUCTURES:
            raise ValueError(f"structure={self.structure!r} not in "
                             f"{STRUCTURES}")
        if self.structure == "sparse":
            raise NotImplementedError(
                "sparse block systems are not ported yet (ROADMAP A9)")
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
        return False

    @property
    def A_op(self) -> torch.Tensor:
        """The operand the solvers consume: the dense (m, p, n) stack."""
        return self.A_blocks

    def dense(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Reassemble the global ``(N, n)`` system."""
        return (self.A_blocks.reshape(self.N, self.n),
                self.b_blocks.reshape(self.N))


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
