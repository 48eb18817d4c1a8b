"""Carry the reference's objects across into the port.

The functions take plain numpy arrays (``np.asarray`` of a reference
``BlockSystem`` field, or of each field of a reference state or factors
NamedTuple, or a model's parameter or cache tree of numpy arrays), so a
system, its factors, an iteration state or a model's weights of
``repro`` continue in ``repro_torch`` without this package importing
anything of ``repro``.  They copy: the port's tensors never alias the reference's
(read-only) buffers.  Every state and factors type of the port has its
reference namesake's fields in the same order, so :func:`from_numpy`
converts any of them.  A bfloat16 array (``np.asarray`` of a JAX
bfloat16 array has the ``ml_dtypes`` dtype, which ``torch.as_tensor``
refuses) crosses by its bits, so the reference's ``precision="mixed"``
factors arrive as they are.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import device as dev
from repro_torch.core.blockops import SparseBlocks
from repro_torch.core.partition import BlockSystem
from repro_torch.optim.adamw import AdamWState


def _int64(a, device):
    return dev.as_tensor(np.array(a, dtype=np.int64), device=device)


def _tensor(a, device):
    """A copy of array ``a`` as a tensor; a bfloat16 array by its 16-bit
    patterns, reinterpreted as ``torch.bfloat16``."""
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return dev.as_tensor(a.view(np.int16), device=device).view(
            torch.bfloat16)
    return dev.as_tensor(a, device=device)


def system_from_numpy(A_blocks, b_blocks, x_true=None,
                      mode: Optional[str] = None, cols=None,
                      device=None) -> BlockSystem:
    """A ``BlockSystem`` from (m, p, n) / (m, p) / (n,) arrays; a sparse
    one when the reference's (m, w) ``cols`` support is given."""
    t = lambda a: _tensor(a, device)  # noqa: E731
    A = t(A_blocks)
    return BlockSystem(
        A, t(b_blocks), None if x_true is None else t(x_true),
        structure="dense" if cols is None else "sparse",
        cols=None if cols is None else _int64(cols, A.device), mode=mode)


def from_numpy(cls, *fields, device=None):
    """The port's state or factors NamedTuple ``cls`` (``APCState``,
    ``ProjFactors``, ``CimminoState``, ``DGDState``, ``GradFactors``,
    ``ADMMFactors``, ...) from its reference namesake's fields, in order.
    None stays None; the iteration counter ``t`` — a scalar, or the
    reference's per-row (k,) counters after ``solve_many`` — becomes an
    int; a reference ``SparseBlocks`` operand (a NamedTuple with the
    fields vals, cols, span) becomes the port's, with int64 cols.  The
    sparse factors' compressed Bvals (m, w, p) convert as any array, a
    bfloat16 one by its bits."""
    def convert(name, a):
        if a is None:
            return None
        if name == "t":
            return int(np.max(np.asarray(a)))
        if getattr(a, "_fields", None) == SparseBlocks._fields:
            vals = convert("vals", a.vals)
            return SparseBlocks(vals=vals, cols=_int64(a.cols, vals.device),
                                span=convert("span", a.span))
        return _tensor(a, device)

    if len(fields) != len(cls._fields):
        raise ValueError(f"{cls.__name__} has fields {cls._fields}, got "
                         f"{len(fields)} arrays")
    return cls(*(convert(name, a) for name, a in zip(cls._fields, fields)))



def _tree_from_numpy(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_from_numpy(v, device) for v in tree]
    return None if tree is None else _tensor(tree, device)


def params_from_numpy(tree, device=None):
    """The port's parameter tree from the reference's: nested dicts and
    lists of numpy arrays (``jax.tree.map(np.asarray, params)``), the same
    key paths, each array a tensor of its dtype (bfloat16 by its bits) on
    ``device``."""
    return _tree_from_numpy(tree, device)


def cache_from_numpy(tree, device=None):
    """The port's decode cache from the reference's (``jax.tree.map(
    np.asarray, cache)``), key paths kept, as :func:`params_from_numpy`."""
    return _tree_from_numpy(tree, device)


def adamw_state_from_numpy(step, m, v, device=None):
    """The port's ``optim.adamw.AdamWState`` from the reference's fields
    (``jax.tree.map(np.asarray, state)``): the 0-d int32 step becomes an
    int, the float32 moment trees convert as :func:`params_from_numpy`."""
    return AdamWState(step=int(np.asarray(step)),
                      m=_tree_from_numpy(m, device),
                      v=_tree_from_numpy(v, device))
