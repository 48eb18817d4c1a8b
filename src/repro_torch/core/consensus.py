"""Generic accelerated-consensus combinator (counterpart of
``repro.core.consensus``).

APC's structure — a local contraction toward a global estimate, then the
master average with one-step memory — as a reusable template:

    x_i(t+1) = local_step_i(x_i(t), xbar(t))            # any per-shard map
    xbar(t+1) = (eta/m) sum_i x_i(t+1) + (1-eta) xbar(t)

x_i may be a tensor or a pytree of tensors (nested tuples, lists, dicts),
each leaf with a leading worker axis.  The local steps run under
``torch.func.vmap`` over that axis, as the reference's run under
``jax.vmap``, and the loop is a Python loop where the reference scans.
"""
from __future__ import annotations

from typing import TypeVar

import torch

T = TypeVar("T")


def _tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of ``tree`` and the matching leaves
    of ``rest`` (same structure), keeping the structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [_tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):                  # a NamedTuple
            return type(tree)(*out)
        return type(tree)(out)
    raise TypeError(f"unsupported pytree node {type(tree).__name__}")


def master_average(x_stack: T, xbar: T, eta: float) -> T:
    """Eq. (2b) on pytrees: leaves of x_stack have a leading worker axis."""
    return _tree_map(
        lambda xs, xb: eta * torch.mean(xs, dim=0) + (1.0 - eta) * xb,
        x_stack, xbar)


def consensus_round(local_step, x_stack: T, xbar: T, eta: float,
                    context=None) -> tuple[T, T]:
    """One full round: vmapped local steps then momentum-averaged master.

    context: optional per-worker pytree (leading worker axis) passed to
    ``local_step(context_i, x_i, xbar)`` but NOT averaged — factorizations,
    local data shards, optimizer state, etc.
    """
    if context is None:
        x_new = torch.func.vmap(lambda x, xb: local_step(None, x, xb),
                                in_dims=(0, None))(x_stack, xbar)
    else:
        x_new = torch.func.vmap(local_step, in_dims=(0, 0, None))(
            context, x_stack, xbar)
    return x_new, master_average(x_new, xbar, eta)


def run_consensus(local_step, x_stack: T, xbar: T, *, eta: float,
                  rounds: int, context=None) -> tuple[T, T]:
    """``rounds`` consensus rounds (the reference's ``lax.scan``)."""
    for _ in range(rounds):
        x_stack, xbar = consensus_round(local_step, x_stack, xbar, eta,
                                        context)
    return x_stack, xbar
