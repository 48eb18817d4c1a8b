"""Mixture-of-Experts layer: top-k router and sort-based capacity dispatch
(the port's counterpart of ``repro.models.moe``).

Tokens are sorted by expert id and gathered into a capacity-padded
(E, C, D) buffer; the expert SwiGLUs run as one grouped product
``ecd,edf->ecf``, and the outputs come back through the inverse
permutation, weighted by the normalized gates.  Entries past an expert's
capacity C drop (their residual still carries the token).  Dispatch and
combine are gathers only, as the reference's, so the result does not
depend on the order of any scatter on the card.

Two paths, as in the reference:

  * global (one device, decode, or shapes the mesh does not divide):
    routing over every token.  On a mesh the tokens are gathered whole
    (a global sort needs them all) and the grouped product runs on the
    expert-sharded weights, so each rank computes its own experts.
  * expert-parallel (``rules`` with a mesh, S > 1, the batch axes
    dividing B and the model axis dividing E): the reference's
    ``shard_map`` region, written on each rank's local shards.  Each
    rank routes its own batch shard, runs only its E / n experts, and
    one sum over the model axis combines the partial outputs.  Capacity
    is per shard, as in every production expert-parallel system, so
    which overflow entries drop can differ from the global path's.

At decode the grouped product reads every expert's weights, C being at
least 8 (``_capacity``), as the reference's does; a dispatch that reads
only the routed experts is a performance item (ROADMAP).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig, MoEConfig
from .sharding import (ParamSpec, from_local, is_dtensor, mesh_sizes,
                       placements)
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


def dropped_entries(cfg: ModelConfig, router, xf) -> int:
    """How many of the top-k entries of tokens ``xf`` (T, D) fall past
    their expert's capacity (``_capacity(T)``) and drop."""
    _, _, eids = route(cfg, router, xf)
    C = _capacity(xf.shape[0], cfg.moe)
    counts = torch.bincount(eids.reshape(-1), minlength=cfg.moe.num_experts)
    return int(torch.clamp(counts - C, min=0).sum())


def moe_apply(cfg: ModelConfig, p, x: torch.Tensor, rules=None):
    """x (B, S, D) -> (B, S, D): the capacity-dropping top-k MoE, plus the
    always-on shared experts where the config has them."""
    out = None
    # the sharded path pays a weight regather at its boundary, amortized
    # over train and prefill tokens but not over one decode token: decode
    # keeps the global path, as the reference's does
    if (rules is not None and rules.mesh is not None and rules.tensor
            and x.shape[1] > 1):
        out = _moe_sharded(cfg, p, x, rules)
    if out is None:
        out = (_moe_global_on_mesh(cfg, p, x) if is_dtensor(x)
               else _moe_global(cfg, p, x))
    if cfg.moe.n_shared:
        B, S, D = x.shape
        out = out + layers.swiglu_apply(p["shared"], x.reshape(B * S, D)) \
            .reshape(B, S, D)
    return out


def _moe_global(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    mo = cfg.moe
    B, S, D = x.shape
    T = B * S
    xf = x.reshape(T, D)
    _, gates, eids = route(cfg, p["router"], xf)
    xe, slot, inv_order = _dispatch(cfg, xf, eids, _capacity(T, mo),
                                    range(mo.num_experts))
    # expert SwiGLUs, one grouped product over every expert
    h = F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    ye = torch.bmm(h, p["w_down"])                               # (E, C, D)
    return _combine(ye, slot, inv_order, gates, T, mo.top_k,
                    x.dtype).reshape(B, S, D)


def _dispatch(cfg: ModelConfig, xf, eids, C: int, experts: range):
    """The sort-based dispatch of tokens ``xf`` (T, D) routed to ``eids``
    (T, K), for ``experts`` (a contiguous range of ids): (xe (E_loc, C,
    D), the combine's slot of each sorted entry in ``ye.reshape(E_loc *
    C, D)`` or -1 where the entry is dropped or not one of ``experts``,
    and the inverse order).  The reference's arithmetic: group starts by
    ``searchsorted`` over every expert id, positions within a group,
    capacity C."""
    T, _ = xf.shape
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    dev = xf.device
    flat_e = eids.reshape(-1)                                   # (T*K,)
    flat_tok = torch.arange(T, device=dev).repeat_interleave(K)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    tok_sorted = flat_tok[order]
    inv_order = torch.argsort(order, stable=True)               # entry -> rank
    group_all = torch.searchsorted(e_sorted,
                                   torch.arange(E + 1, device=dev))
    pos = torch.arange(T * K, device=dev) - group_all[:-1][e_sorted]
    first = experts.start
    g_start = group_all[first:experts.stop]                     # (E_loc,)
    g_end = group_all[first + 1:experts.stop + 1]
    take = g_start[:, None] + torch.arange(C, device=dev)[None, :]
    valid = take < g_end[:, None]
    take = torch.clamp(take, max=T * K - 1)
    xe = torch.where(valid[..., None], xf[tok_sorted[take]],
                     0.0).to(xf.dtype)                          # (E_loc, C, D)
    local_e = e_sorted - first
    mine = (local_e >= 0) & (local_e < len(experts)) & (pos < C)
    slot = torch.where(mine, local_e * C + pos, -1)
    return xe, slot, inv_order


def _combine(ye, slot, inv_order, gates, T: int, K: int, dtype):
    """The entries' expert outputs back in token order, weighted by the
    gates and summed over the k slots; a slot of -1 contributes 0."""
    D = ye.shape[-1]
    mine = slot >= 0
    contrib = torch.where(mine[:, None],
                          ye.reshape(-1, D)[torch.clamp(slot, min=0)], 0.0)
    entry_out = contrib[inv_order].reshape(T, K, D)
    return torch.einsum("tkd,tk->td", entry_out,
                        gates.to(entry_out.dtype)).to(dtype)


def _moe_local_partial(cfg: ModelConfig, xf, router, wg, wu, wd, rank: int):
    """One shard's MoE: xf (T_loc, D) its tokens; wg, wu, wd (E_loc, D, F)
    its experts, ids [rank·E_loc, (rank + 1)·E_loc).  Returns this
    shard's partial output (T_loc, D); the caller sums it over the model
    axis."""
    T = xf.shape[0]
    E_loc = wg.shape[0]
    C = _capacity(T, cfg.moe)
    _, gates, eids = route(cfg, router, xf)
    xe, slot, inv_order = _dispatch(
        cfg, xf, eids, C, range(rank * E_loc, (rank + 1) * E_loc))
    h = F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu)
    ye = torch.bmm(h, wd)                                       # (E_loc, C, D)
    return _combine(ye, slot, inv_order, gates, T, cfg.moe.top_k, xf.dtype)


def _moe_sharded(cfg: ModelConfig, p, x, rules):
    """The reference's ``shard_map`` region on DTensors: x split over the
    batch axes (whole over the model axis), the router whole, each expert
    bank split over the model axis; every rank runs
    ``_moe_local_partial`` on its shards, and the partial outputs are
    summed over the model axis (a ``Partial`` placement redistributed).
    Returns None where the shapes do not divide the mesh (the caller then
    takes the global path).  Gradients leave each rank as partial sums
    over the axes its operand is whole on, which DTensor reduces."""
    from torch.distributed.tensor import Partial
    mesh, tax = rules.mesh, rules.tensor
    sizes = mesh_sizes(mesh)
    baxes = tuple(a for a in rules.batch if a in sizes)
    n_b = 1
    for a in baxes:
        n_b *= sizes[a]
    B, S, D = x.shape
    if not baxes or B % n_b or cfg.moe.num_experts % sizes[tax]:
        return None
    if not is_dtensor(x):
        raise ValueError("the expert-parallel MoE takes DTensors on the "
                         "rules' mesh")
    names = tuple(mesh.mesh_dim_names)
    bspec = baxes if len(baxes) > 1 else baxes[0]
    x_pl = placements((bspec, None, None), mesh)
    w_pl = placements((tax, None, None), mesh)
    r_pl = placements((None, None), mesh)
    part = lambda pl, axes: tuple(  # noqa: E731
        Partial() if n in axes else q for n, q in zip(names, pl))
    xl = x.redistribute(mesh, x_pl).to_local(
        grad_placements=part(x_pl, (tax,)))
    router = p["router"].redistribute(mesh, r_pl).to_local(
        grad_placements=part(r_pl, names))
    ws = [p[k].redistribute(mesh, w_pl).to_local(
        grad_placements=part(w_pl, baxes))
        for k in ("w_gate", "w_up", "w_down")]
    Bl = xl.shape[0]
    out = _moe_local_partial(cfg, xl.reshape(Bl * S, D), router, *ws,
                             mesh.get_local_rank(tax)).reshape(Bl, S, D)
    out = from_local(out, mesh, part(x_pl, (tax,)), x.shape)
    return out.redistribute(mesh, x_pl)


def _moe_global_on_mesh(cfg: ModelConfig, p, x):
    """The global path on DTensors: the tokens and the router whole on
    every rank (the sort is over all of them), the routing and dispatch
    on local tensors, the grouped product on the expert-sharded weights
    (each rank its own experts, DTensor's rule), and the expert outputs
    gathered whole for the combine.  The output is whole on every rank."""
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    rep = (Replicate(),) * mesh.ndim
    B, S, D = x.shape
    T = B * S
    mo = cfg.moe
    C = _capacity(T, mo)
    xf = x.redistribute(mesh, rep).to_local().reshape(T, D)
    router = p["router"].redistribute(mesh, rep).to_local()
    _, gates, eids = route(cfg, router, xf)
    xe, slot, inv_order = _dispatch(cfg, xf, eids, C,
                                    range(mo.num_experts))
    xe = from_local(xe, mesh, rep, xe.shape)
    h = F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    ye = torch.bmm(h, p["w_down"]).redistribute(mesh, rep).to_local()
    out = _combine(ye, slot, inv_order, gates, T, mo.top_k, x.dtype)
    return from_local(out.reshape(B, S, D), mesh, rep, x.shape)
