"""Mixture-of-Experts layer: top-k router and sort-based capacity dispatch
(the port's counterpart of ``repro.models.moe``).

Tokens are sorted by expert id and gathered into a capacity-padded
(E, C, D) buffer; the expert SwiGLUs run as one grouped product
``ecd,edf->ecf`` over every expert, and the outputs come back through the
inverse permutation, weighted by the normalized gates.  Entries past an
expert's capacity C drop (their residual still carries the token).
Dispatch and combine are gathers only, as the reference's, so the result
does not depend on the order of any scatter on the card.

The reference's global path only: its ``shard_map`` path (expert
parallelism over a mesh) is ROADMAP A19d, and the port's ``Rules`` carries
no mesh.  At decode the grouped product reads every expert's weights,
C being at least 8 (``_capacity``), as the reference's does; a dispatch
that reads only the routed experts is a performance item (ROADMAP).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig, MoEConfig
from .sharding import ParamSpec
from . import layers


def moe_abstract(cfg: ModelConfig):
    mo = cfg.moe
    D, Fd, E = cfg.d_model, mo.d_expert, mo.num_experts
    p = {
        "router": ParamSpec((D, E), ("fsdp", None)),
        "w_gate": ParamSpec((E, D, Fd), ("tensor", "fsdp", None)),
        "w_up": ParamSpec((E, D, Fd), ("tensor", "fsdp", None)),
        "w_down": ParamSpec((E, Fd, D), ("tensor", None, "fsdp")),
    }
    if mo.n_shared:
        p["shared"] = layers.swiglu_abstract(D, Fd * mo.n_shared)
    return p


def _capacity(tokens: int, mo: MoEConfig) -> int:
    c = int(tokens * mo.top_k * mo.capacity_factor / mo.num_experts)
    return max(8, (c + 7) // 8 * 8)   # a multiple of 8, at least 8


def route(cfg: ModelConfig, router: torch.Tensor, xf: torch.Tensor):
    """The router over tokens ``xf`` (T, D): (probs (T, E) float32, gates
    (T, K) normalized to sum 1, eids (T, K)).

    The logits are rounded to the activations' dtype before the float32
    softmax, as the reference's.  The top k come from a stable descending
    sort, so that tied probabilities keep the lower expert id first, as
    ``jax.lax.top_k`` does (``torch.topk`` does not promise an order
    among ties, and bfloat16 logits tie often).
    """
    K = cfg.moe.top_k
    probs = torch.softmax((xf @ router).float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eids = vals[:, :K], idx[:, :K]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, eids


def moe_apply(cfg: ModelConfig, p, x: torch.Tensor, rules=None):
    """x (B, S, D) -> (B, S, D): the capacity-dropping top-k MoE, plus the
    always-on shared experts where the config has them."""
    if rules is not None and rules.mesh is not None:
        raise NotImplementedError("the expert-parallel MoE over a mesh is "
                                  "ROADMAP A19d, not ported yet")
    out = _moe_global(cfg, p, x)
    if cfg.moe.n_shared:
        B, S, D = x.shape
        out = out + layers.swiglu_apply(p["shared"], x.reshape(B * S, D)) \
            .reshape(B, S, D)
    return out


def _moe_global(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    mo = cfg.moe
    B, S, D = x.shape
    T = B * S
    E, K = mo.num_experts, mo.top_k
    C = _capacity(T, mo)
    dev = x.device

    xf = x.reshape(T, D)
    _, gates, eids = route(cfg, p["router"], xf)

    # ---- sort-based dispatch (gathers only) ------------------------------
    flat_e = eids.reshape(-1)                                   # (T*K,)
    flat_tok = torch.arange(T, device=dev).repeat_interleave(K)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    tok_sorted = flat_tok[order]
    inv_order = torch.argsort(order, stable=True)               # entry -> rank
    # position of each sorted entry within its expert's group
    group_start = torch.searchsorted(e_sorted,
                                     torch.arange(E, device=dev))  # (E,)
    pos = torch.arange(T * K, device=dev) - group_start[e_sorted]
    keep = pos < C                                              # drop overflow

    # dispatch: xe[e, c] = the token of expert e's c-th kept entry
    take = group_start[:, None] + torch.arange(C, device=dev)[None, :]
    group_end = torch.cat([group_start[1:],
                           torch.full((1,), T * K, device=dev,
                                      dtype=group_start.dtype)])
    valid = take < group_end[:, None]
    take = torch.clamp(take, max=T * K - 1)
    xe = torch.where(valid[..., None], xf[tok_sorted[take]],
                     0.0).to(x.dtype)                            # (E, C, D)

    # ---- expert SwiGLUs, one grouped product over every expert ----------
    h = F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    ye = torch.bmm(h, p["w_down"])                               # (E, C, D)

    # ---- combine: inverse-permutation gather, weighted sum over slots ---
    ye_flat = ye.reshape(E * C, D)
    slot = torch.where(keep, e_sorted * C + pos, 0)
    contrib_sorted = torch.where(keep[:, None], ye_flat[slot], 0.0)
    entry_out = contrib_sorted[inv_order].reshape(T, K, D)       # token order
    out = torch.einsum("tkd,tk->td", entry_out,
                       gates.to(entry_out.dtype)).to(x.dtype)
    return out.reshape(B, S, D)
