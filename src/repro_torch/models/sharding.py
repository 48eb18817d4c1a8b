"""Abstract parameters and the logical-axis rule record (the port's
counterpart of ``repro.models.sharding``).

Parameters are declared as a pytree (nested dicts and lists) of
:class:`ParamSpec` leaves: shape, logical axis names and the init rule.
:func:`init_tree` materializes them from an explicit ``torch.Generator``;
:func:`tree_map`, :func:`tree_leaves` and :func:`tree_unflatten` walk
such trees (dict keys in sorted order, as ``jax.tree`` flattens them).

:class:`Rules` keeps the reference's fields so that call sites read the
same, but this slice runs on one device: :func:`constrain` is the
identity.  ``rules_for_mesh``, ``pspec_tree`` and ``sharding_tree`` (the
mapping of logical axes onto a mesh) are ROADMAP item A19d.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch import device as dev


@dataclasses.dataclass(frozen=True)
class Rules:
    """The reference's logical-axis table: which mesh axis each logical
    axis maps to.  Read by nothing on one device (``constrain`` is the
    identity); kept so that a sharded port (A19d) fills it in."""
    batch: Tuple[str, ...] = ("data",)
    fsdp: Optional[str] = "data"
    tensor: Optional[str] = "model"
    seq_sp: Optional[str] = "model"
    kv_seq: Optional[str] = "model"
    mesh: Any = dataclasses.field(default=None, compare=False)


class ParamSpec(NamedTuple):
    """Abstract parameter: shape + logical axes + init scale."""
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"        # normal | zeros | ones
    scale: float = 1.0


def _is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn: Callable, tree, is_leaf=_is_spec):
    """``fn`` over the leaves of ``tree``, keeping its dicts, lists and
    tuples; a ParamSpec (or what ``is_leaf`` says), a tensor or ``None``
    is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not is_leaf(tree):
        out = [tree_map(fn, t, is_leaf) for t in tree]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree)


def tree_leaves(tree, is_leaf=_is_spec) -> list:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order (dict keys
    sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k],
                                                             is_leaf)]
    if isinstance(tree, (list, tuple)) and not is_leaf(tree):
        return [x for t in tree for x in tree_leaves(t, is_leaf)]
    return [] if tree is None else [tree]


def tree_unflatten(like, leaves):
    """``like``'s tree (dicts, lists, tuples) with its leaves replaced by
    ``leaves``, taken in ``tree_leaves`` order; None stays None."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            made = {k: build(node[k]) for k in sorted(node)}
            return {k: made[k] for k in node}
        if isinstance(node, (list, tuple)):
            out = [build(t) for t in node]
            return out if isinstance(node, list) else tuple(out)
        return None if node is None else next(it)

    return build(like)


def init_tree(abstract, generator: torch.Generator, dtype: torch.dtype,
              device=None):
    """Materialize real parameters (smoke tests, examples, serving with
    random weights).

    The reference's rule: ``zeros`` and ``ones`` as named; a ``normal``
    leaf draws N(0, 1) in ``dtype`` and scales it by ``scale /
    sqrt(fan_in)``, fan_in being ``shape[-2]`` (``shape[-1]`` for a
    vector) — so the (V, D) embedding draws with 1/sqrt(V).  The draws
    come from ``generator`` leaf by leaf, in ``tree_leaves`` order, on the
    generator's device, and are moved to ``device`` (resolved: ``cuda``
    unless asked otherwise) where it differs.
    """
    device = dev.resolve(device)

    def make(spec: ParamSpec):
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=device)
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = spec.scale / (fan_in ** 0.5)
        x = torch.randn(spec.shape, generator=generator, dtype=dtype,
                        device=generator.device)
        # scaled in place: the same bits as ``x * std`` without a second
        # copy of the leaf (a stacked expert bank can be a quarter of the
        # card)
        return x.mul_(std).to(device)

    def build(tree):       # leaves drawn in tree_leaves order
        if isinstance(tree, dict):
            made = {k: build(tree[k]) for k in sorted(tree)}
            return {k: made[k] for k in tree}
        if isinstance(tree, (list, tuple)) and not _is_spec(tree):
            out = [build(t) for t in tree]
            return out if isinstance(tree, list) else tuple(out)
        return make(tree)

    return build(abstract)


def constrain(x, rules: Optional[Rules], *logical_axes):
    """The reference's sharding constraint by logical names: the identity
    on one device (the port's models run unsharded until A19d)."""
    return x
