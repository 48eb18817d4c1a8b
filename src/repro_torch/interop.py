"""Carry the reference's objects across into the port.

The functions take plain numpy arrays (``np.asarray`` of a reference
``BlockSystem``/``ProjFactors``/``APCState`` field), so a system, its
factors or an iteration state of ``repro`` continue in ``repro_torch``
without this package importing anything of ``repro``.  They copy: the
port's tensors never alias the reference's (read-only) buffers.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch import device as dev
from repro_torch.core.apc import APCState
from repro_torch.core.partition import BlockSystem
from repro_torch.solvers.projection import ProjFactors


def system_from_numpy(A_blocks, b_blocks, x_true=None,
                      mode: Optional[str] = None,
                      device=None) -> BlockSystem:
    """A dense ``BlockSystem`` from (m, p, n) / (m, p) / (n,) arrays."""
    t = lambda a: dev.as_tensor(np.array(a), device=device)  # noqa: E731
    return BlockSystem(t(A_blocks), t(b_blocks),
                       None if x_true is None else t(x_true), mode=mode)


def factors_from_numpy(A, chol, B=None, device=None) -> ProjFactors:
    """APC ``ProjFactors`` from (m, p, n) / (m, p, p) / (m, n, p) arrays."""
    t = lambda a: dev.as_tensor(np.array(a, order="C"),  # noqa: E731
                                device=device)
    return ProjFactors(A=t(A), chol=t(chol), B=None if B is None else t(B))


def state_from_numpy(x, xbar, t, device=None) -> APCState:
    """An ``APCState`` from x (m, n) or (k, m, n), x̄ (n,) or (k, n) and
    the iteration counter (a scalar, or the reference's per-row (k,)
    counters after ``solve_many``)."""
    return APCState(x=dev.as_tensor(np.array(x), device=device),
                    xbar=dev.as_tensor(np.array(xbar), device=device),
                    t=int(np.max(np.asarray(t))))
