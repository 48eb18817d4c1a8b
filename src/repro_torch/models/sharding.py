"""Logical-axis sharding (the port's counterpart of
``repro.models.sharding``): one table maps logical tensor axes to mesh
axes.

Parameters are declared as a pytree (nested dicts and lists) of
:class:`ParamSpec` leaves: shape, logical axis names and the init rule.
:func:`init_tree` materializes them from an explicit ``torch.Generator``;
:func:`tree_map`, :func:`tree_leaves` and :func:`tree_unflatten` walk
such trees (dict keys in sorted order, as ``jax.tree`` flattens them).

Rules (production defaults, the reference's):
  batch    -> ("pod", "data")  activations' batch dim (DP across pods too)
  fsdp     -> "data"           weight FSDP shard dim
  tensor   -> "model"          TP: heads / ffn / vocab / experts
  seq_sp   -> "model"          sequence-parallel residual stream between blocks
  kv_seq   -> "model"          decode KV-cache sequence dim
  layers   -> None             stacked layer dim, never sharded

The mechanism is ``torch.distributed.tensor``, torch's counterpart of
GSPMD: on a ``DeviceMesh`` a parameter, a cache leaf or an activation is
a ``DTensor`` whose placements come from its logical axes
(:func:`placements`): mesh dim ``a`` is ``Shard(d)`` where the spec of
tensor dim ``d`` names ``a``, else ``Replicate()``.  A tensor dim named
by two mesh dims (``batch -> ("pod", "data")``) is split pod-major, as
``P(("pod", "data"))`` is.  :func:`constrain` is a ``redistribute``, and
the ops in between propagate their shardings through DTensor's rules.
A logical name with no rule (an axis the mesh lacks) resolves to
``None``, as in the reference; a spec that names one mesh dim twice, or
a pair out of the mesh's order, raises.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch import device as dev


@dataclasses.dataclass(frozen=True)
class Rules:
    """The logical-axis table: the mesh axis (or axes) each logical axis
    maps to, and the concrete mesh where one is known (``None``: one
    device; the models then run unsharded and :func:`constrain` is the
    identity)."""
    batch: Tuple[str, ...] = ("data",)
    fsdp: Optional[str] = "data"
    tensor: Optional[str] = "model"
    seq_sp: Optional[str] = "model"
    kv_seq: Optional[str] = "model"
    mesh: Any = dataclasses.field(default=None, compare=False)

    def resolve(self, logical: Optional[str]):
        if logical is None:
            return None
        v = getattr(self, logical)
        if isinstance(v, tuple):
            return v if len(v) > 1 else (v[0] if v else None)
        return v


def rules_for_mesh(mesh) -> Rules:
    """Rules matching a ``DeviceMesh``'s dim names (the pod axis folds
    into batch/DP), as the reference reads a mesh's ``axis_names``."""
    axes = tuple(mesh.mesh_dim_names)
    batch = tuple(a for a in ("pod", "data") if a in axes)
    has_model = "model" in axes
    return Rules(
        batch=batch or (axes[0],),
        fsdp="data" if "data" in axes else None,
        tensor="model" if has_model else None,
        seq_sp="model" if has_model else None,
        kv_seq="model" if has_model else None,
        mesh=mesh,
    )


def to_pspec(logical_axes: Tuple[Optional[str], ...], rules: Rules) -> tuple:
    """The reference's ``P(...)`` read as a tuple: one entry per dim,
    ``None``, a mesh axis name or a tuple of names."""
    return tuple(rules.resolve(a) for a in logical_axes)


def placements(pspec: tuple, mesh) -> tuple:
    """DTensor placements on ``mesh`` for a spec from :func:`to_pspec`."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(pspec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {pspec}: {axes} is not in the mesh's "
                             f"order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {pspec} names mesh dim {names[i]!r} "
                                 f"twice")
            out[i] = Shard(d)
    return tuple(out)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


@contextlib.contextmanager
def implicit_replication(on: bool = True):
    """Inside (where ``on``), a plain tensor meeting a DTensor in an op
    counts as replicated: the aranges, masks and constants that every
    rank makes alike.  Nests: the previous setting comes back on exit
    (torch's own context resets it to off)."""
    if not on:
        yield
        return
    from torch.distributed.tensor import DTensor
    disp = DTensor._op_dispatcher
    before = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = before


def on_mesh(rules: Optional[Rules]):
    """:func:`implicit_replication` where ``rules`` has a mesh."""
    return implicit_replication(rules is not None and rules.mesh is not None)


def is_pspec(x) -> bool:
    """A leaf of a spec tree (:func:`pspec_tree`): a tuple."""
    return isinstance(x, tuple)


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


def meshed(fn):
    """``fn`` run inside :func:`on_mesh` of its ``rules=`` keyword."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with on_mesh(kwargs.get("rules")):
            return fn(*args, **kwargs)
    return run


def pspec_tree(abstract, rules: Rules):
    """A pytree of ParamSpec -> the same tree of specs (tuples)."""
    return tree_map(lambda s: to_pspec(s.logical, rules), abstract)


def sds_tree(abstract, dtype: torch.dtype):
    """A pytree of ParamSpec -> ``meta`` tensors of its shapes in
    ``dtype`` (the reference's ShapeDtypeStructs; nothing allocated)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype,
                                          device="meta"), abstract)


def sharding_tree(abstract, rules: Rules, mesh):
    """A pytree of ParamSpec -> each leaf's DTensor placements on
    ``mesh``."""
    return tree_map(lambda s: placements(to_pspec(s.logical, rules), mesh),
                    abstract)


def shard_tree(params, abstract, rules: Rules, mesh):
    """Materialized leaves (every rank holding the same full tensors) ->
    DTensors on ``mesh``, each placed by its ParamSpec's logical axes;
    ``requires_grad`` is kept.  The leaves stay on their device."""
    from torch.distributed.tensor import distribute_tensor
    specs = tree_leaves(abstract)
    leaves = tree_leaves(params)
    if len(specs) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves for {len(specs)} specs")

    def place(t, s):
        d = distribute_tensor(t.detach(), mesh,
                              placements(to_pspec(s.logical, rules), mesh))
        return d.requires_grad_(t.requires_grad)

    return tree_unflatten(params, [place(t, s)
                                   for t, s in zip(leaves, specs)])


def local_part(t: torch.Tensor, mesh, pl) -> torch.Tensor:
    """A DTensor of placements ``pl`` from a full tensor ``t`` that every
    rank holds alike: each rank keeps its own piece (no communication)."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    shape, off = compute_local_shape_and_global_offset(t.shape, mesh, pl)
    local = t[tuple(slice(o, o + n) for o, n in zip(off, shape))]
    return from_local(local.contiguous(), mesh, pl, t.shape)


def full_tree(tree):
    """``tree`` with every DTensor leaf gathered to its full (global)
    tensor on every rank; other leaves as they are (checkpoints)."""
    def full(t):
        return t.full_tensor() if is_dtensor(t) else t
    return tree_map(full, tree, is_leaf=lambda x: False)


def from_local(local: torch.Tensor, mesh, pl, shape) -> torch.Tensor:
    """A DTensor of global ``shape`` from this rank's shard ``local``
    (made contiguous, as the global strides say) laid out by placements
    ``pl`` (uneven splits included)."""
    from torch.distributed.tensor import DTensor
    shape = torch.Size(shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local.contiguous(), mesh, pl, run_check=False,
                              shape=shape, stride=stride)


def unflatten(x: torch.Tensor, dim: int, sizes) -> torch.Tensor:
    """``x`` with dim ``dim`` split into ``sizes`` (a reshape).  A DTensor
    split along that dim over mesh dims whose ranks do not divide
    ``sizes[0]`` (6 heads over a 16-way axis, say) is first gathered
    along it, which DTensor leaves to the caller."""
    dim = dim % x.dim()
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate
        mesh = x.device_mesh
        split = [i for i, p in enumerate(x.placements) if p.is_shard(dim)]
        if sizes[0] % math.prod(mesh.size(i) for i in split):
            x = x.redistribute(mesh, [Replicate() if i in split else p
                                      for i, p in enumerate(x.placements)])
    return x.reshape(*x.shape[:dim], *sizes, *x.shape[dim + 1:])


class _GradPlaced(torch.autograd.Function):
    """The identity, whose backward puts the gradient in given
    placements."""

    @staticmethod
    def forward(ctx, x, pl):
        ctx.pl = pl
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g) and tuple(g.placements) != ctx.pl:
            g = g.redistribute(g.device_mesh, ctx.pl)
        return g, None


def merge(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with dims ``dim`` and ``dim + 1`` merged into one (a
    reshape).  On a DTensor the gradient of the merged tensor is put back
    in its forward placements before the reshape's backward splits it:
    DTensor cannot split a gradient whose merged dim arrives split over
    ranks that do not divide ``x.shape[dim]``."""
    dim = dim % x.dim()
    out = x.reshape(*x.shape[:dim], x.shape[dim] * x.shape[dim + 1],
                    *x.shape[dim + 2:])
    if is_dtensor(out) and out.requires_grad:
        out = _GradPlaced.apply(out, tuple(out.placements))
    return out


def constrain(x, rules: Optional[Rules], *logical_axes):
    """The reference's sharding constraint by logical names: a DTensor
    goes to the placements of ``to_pspec(logical_axes)`` on the rules'
    mesh (a ``redistribute``, the identity where it is placed so); a
    plain tensor, or rules without a mesh, pass through."""
    if rules is None or rules.mesh is None or not is_dtensor(x):
        return x
    want = placements(to_pspec(logical_axes, rules), rules.mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(rules.mesh, want)


def mesh_sizes(mesh) -> dict:
    """A mesh's dim sizes by name."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
