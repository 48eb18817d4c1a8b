"""AdamW over a parameter tree (the port's counterpart of
``repro.optim.adamw``).

Plain-tree implementation: the (m, v) moments mirror the parameter tree
and are float32 whatever the parameter dtype (bfloat16-safe).
``clip_norm`` applies global-norm clipping.  ``update`` is out of place,
as the reference's: it returns new parameter tensors (each with its
predecessor's ``requires_grad``) and a new state, computed under
``torch.no_grad()`` with the reference's arithmetic: the clip scale, the
bias corrections ``1 - b**step`` and every moment in float32.

The step counter is a Python int (the reference's 0-d int32 array; the
checkpoint writes it as one).  Leaves may be DTensors (sharded
training): the moments then take their parameters' placements (ZeRO
style, as the reference's state shares its parameters' specs), each
gradient is first redistributed to its parameter's placements, and the
clipping norm is the global one, summed across shards.
``abstract_state`` and ``state_pspecs`` are the dry-run's and the
sharding's views of the state.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.models.sharding import (implicit_replication, is_dtensor,
                                        is_pspec, tree_leaves, tree_map,
                                        tree_unflatten)



@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0


class AdamWState(NamedTuple):
    step: int
    m: dict
    v: dict


def init(params) -> AdamWState:
    """Zero float32 moments on each parameter's device (a DTensor's with
    its placements), step 0."""
    zeros = lambda p: torch.zeros_like(  # noqa: E731
        p, dtype=torch.float32, requires_grad=False)
    return AdamWState(step=0, m=tree_map(zeros, params),
                      v=tree_map(zeros, params))


def abstract_state(params_abstract) -> AdamWState:
    """The state of a tree of ``meta`` parameter tensors, as ``meta``
    tensors (the dry-run: nothing allocated): float32 moments, and the
    step as the reference's 0-d int32."""
    f32 = lambda p: torch.empty(p.shape, dtype=torch.float32,  # noqa: E731
                                device="meta")
    return AdamWState(step=torch.empty((), dtype=torch.int32, device="meta"),
                      m=tree_map(f32, params_abstract),
                      v=tree_map(f32, params_abstract))


def state_pspecs(param_pspecs) -> AdamWState:
    """The state's specs (tuples, ``sharding.to_pspec``): the moments
    mirror the parameters', the step is replicated (``()``)."""
    same = lambda s: s  # noqa: E731
    return AdamWState(step=(), m=tree_map(same, param_pspecs, is_pspec),
                      v=tree_map(same, param_pspecs, is_pspec))


def global_norm(tree) -> torch.Tensor:
    """The float32 2-norm over every leaf of ``tree``."""
    total = sum(torch.sum(torch.square(t.float()))
                for t in tree_leaves(tree))
    return torch.sqrt(total)


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: AdamWState, params, *,
           lr_scale=1.0):
    """One AdamW step.  Returns (new params, new state)."""
    leaves = tree_leaves(params)
    with implicit_replication(any(is_dtensor(p) for p in leaves)):
        return _update(cfg, grads, state, params, lr_scale)


def placed(g, p):
    """Gradient ``g`` in its parameter's placements (a DTensor's partial
    sums reduced, or its shards cut, as the parameter's are)."""
    if is_dtensor(p) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _update(cfg: AdamWConfig, grads, state: AdamWState, params, lr_scale):
    grads = tree_unflatten(params, [placed(g, p) for g, p in zip(
        tree_leaves(grads), tree_leaves(params))])
    step = state.step + 1
    scale = None
    if cfg.clip_norm is not None:
        gn = global_norm(grads)
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-12),
                            max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - _f32(b1) ** _f32(step)
    c2 = 1.0 - _f32(b2) ** _f32(step)
    lr = cfg.lr * lr_scale

    def upd(g, m, v, p):
        g32 = g.float() if scale is None else g.float() * scale
        m_new = b1 * m + (1.0 - b1) * g32
        v_new = b2 * v + (1.0 - b2) * g32 * g32
        mhat = m_new / c1
        vhat = v_new / c2
        p32 = p.float()
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + \
            cfg.weight_decay * p32
        new = (p32 - lr * delta).to(p.dtype)
        return new.requires_grad_(p.requires_grad), m_new, v_new

    out = [upd(*x) for x in zip(*(tree_leaves(t) for t in (
        grads, state.m, state.v, params)))]
    new_p, new_m, new_v = (tree_unflatten(params, leaves)
                           for leaves in zip(*out))
    return new_p, AdamWState(step=step, m=new_m, v=new_v)

