"""Decoder stack: periods of per-slot heterogeneous layers (the port's
counterpart of ``repro.models.transformer``).

The layer list is a repeating *pattern* of slots (config
``layer_pattern``).  Weights are stacked per slot with a leading
(n_periods,) axis, as the reference's; where it runs the periods under one
``jax.lax.scan``, the port loops over them in Python, each period reading
its slice of the stacked weights and caches (views, so an attention
block's cache write lands in the stacked tensor, and the new caches stay
stacked per slot; an SSM block's new conv tail and state are copied into
their period's place, see ``_store``).  A slot is GQA or MLA attention
or a Mamba2 (SSD) block, then Whisper's cross-attention where the model
has an encoder, then a SwiGLU, a GELU MLP or a MoE.

Layers that cannot join the uniform stack (DeepSeek-V2's first dense
layer) are an unrolled prefix, as in the reference.

Remat: in training (no caches, no cross stack) each period runs under
``torch.utils.checkpoint`` (non-reentrant), the twin of the reference's
``jax.checkpoint(nothing_saveable)`` over its scan body: a period's
activations are recomputed in the backward, and only the residual
stream between periods is kept.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .config import ModelConfig
from .sharding import ParamSpec, Rules, constrain, tree_map
from . import layers, moe, ssm

# ---------------------------------------------------------------------------
# Abstract parameter construction
# ---------------------------------------------------------------------------


def _stack(abstract, n: int):
    """Prepend a stacked (n,) layer axis to every ParamSpec in a pytree."""
    return tree_map(
        lambda s: ParamSpec((n, *s.shape), (None, *s.logical), s.init,
                            s.scale), abstract)


def _slot_abstract(cfg: ModelConfig, kind: str, is_moe: bool,
                   cross_attn: bool):
    d = {"ln1": layers.rmsnorm_abstract(cfg.d_model)}
    if kind == "attn":
        d["attn"] = (layers.mla_abstract(cfg) if cfg.attn_type == "mla"
                     else layers.gqa_abstract(cfg))
    else:
        d["attn"] = ssm.ssm_abstract(cfg)
    if cross_attn:
        d["ln_x"] = layers.rmsnorm_abstract(cfg.d_model)
        d["xattn"] = layers.gqa_abstract(cfg)
    if is_moe:
        d["ln2"] = layers.rmsnorm_abstract(cfg.d_model)
        d["mlp"] = moe.moe_abstract(cfg)
    elif cfg.d_ff > 0:
        d["ln2"] = layers.rmsnorm_abstract(cfg.d_model)
        d["mlp"] = (layers.gelu_mlp_abstract(cfg.d_model, cfg.d_ff)
                    if cfg.family == "audio"
                    else layers.swiglu_abstract(cfg.d_model, cfg.d_ff))
    return d


def _slot_is_moe(cfg: ModelConfig, slot: int) -> bool:
    if cfg.moe is None:
        return False
    return slot % cfg.moe.every_k == cfg.moe.every_k - 1 or cfg.moe.every_k == 1


def decoder_abstract(cfg: ModelConfig):
    nd = cfg.moe.first_dense if cfg.moe else 0
    n_scanned = cfg.n_layers - nd
    period = cfg.pattern
    assert n_scanned % len(period) == 0
    n_periods = n_scanned // len(period)
    xattn = cfg.is_encoder_decoder
    return {
        "prefix": [
            _slot_abstract(cfg, "attn", False, xattn) for _ in range(nd)],
        "slots": [
            _stack(_slot_abstract(cfg, kind, _slot_is_moe(cfg, s), xattn),
                   n_periods)
            for s, kind in enumerate(period)],
    }


def encoder_abstract(cfg: ModelConfig):
    slot = {
        "ln1": layers.rmsnorm_abstract(cfg.d_model),
        "attn": layers.gqa_abstract(cfg),
        "ln2": layers.rmsnorm_abstract(cfg.d_model),
        "mlp": (layers.gelu_mlp_abstract(cfg.d_model, cfg.d_ff)
                if cfg.family == "audio"
                else layers.swiglu_abstract(cfg.d_model, cfg.d_ff)),
    }
    return {"slots": [_stack(slot, cfg.encoder_layers)],
            "final_norm": layers.rmsnorm_abstract(cfg.d_model)}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _gathered(x, rules):
    """A block's normed input with its sequence whole on each rank: the
    residual stream is split over ``seq_sp`` between blocks (the
    reference's constraint), and is gathered before the projections, as
    Megatron's sequence parallelism does (DTensor cannot merge a split
    sequence dim into the rows of a product)."""
    return constrain(x, rules, "batch", None, None)


def _residual(a, h, rules):
    """A block's output ``a`` placed as the residual stream ``h`` it is
    added to (split over ``seq_sp`` where S > 1), by a redistribute that
    autograd records: its gradient then goes back to ``a``'s own
    placements, not the stream's split sequence."""
    if h.shape[1] > 1:
        a = constrain(a, rules, "batch", "seq_sp", None)
    return a.to(h.dtype)


def _apply_slot(cfg: ModelConfig, kind: str, sp, h, *, positions, rules,
                cache=None, cache_len=None, cross=None):
    """One residual block: (GQA | MLA | SSM) [+ cross-attention] +
    (SwiGLU | GELU MLP | MoE).  Returns (h, the block's new cache or
    None)."""
    new_cache = {}
    hn = _gathered(layers.rmsnorm(sp["ln1"], h, cfg.norm_eps), rules)
    c_in = None if cache is None else cache["attn"]
    if kind == "ssm":
        a, c = ssm.ssm_apply(cfg, sp["attn"], hn, cache=c_in,
                             rules=rules)
    elif cfg.attn_type == "mla":
        a, c = layers.mla_apply(cfg, sp["attn"], hn, positions=positions,
                                cache=c_in, cache_len=cache_len, rules=rules)
    else:
        a, c = layers.gqa_apply(cfg, sp["attn"], hn, positions=positions,
                                cache=c_in, cache_len=cache_len, rules=rules)
    if c is not None:
        new_cache["attn"] = c
    h = h + _residual(a, h, rules)
    if cross is not None:
        hx = _gathered(layers.rmsnorm(sp["ln_x"], h, cfg.norm_eps), rules)
        a, _ = layers.gqa_apply(cfg, sp["xattn"], hx, positions=positions,
                                cross=cross, rules=rules)
        h = h + _residual(a, h, rules)
    if "mlp" in sp:
        hn = _gathered(layers.rmsnorm(sp["ln2"], h, cfg.norm_eps), rules)
        if "router" in sp["mlp"]:
            f = moe.moe_apply(cfg, sp["mlp"], hn, rules=rules)
        elif "w_gate" in sp["mlp"]:
            f = layers.swiglu_apply(sp["mlp"], hn)
        else:
            f = layers.gelu_mlp_apply(sp["mlp"], hn)
        h = h + _residual(f, h, rules)
    if h.shape[1] > 1:
        h = constrain(h, rules, "batch", "seq_sp", None)
    return h, (new_cache or None)


def _period(tree, i: int):
    """Period ``i``'s slice of a stacked slot tree (views)."""
    return tree_map(lambda t: t[i], tree, is_leaf=lambda x: False)


def _store(tree, i, old, new) -> None:
    """Put a block's new cache ``new`` in its place, period ``i`` of the
    stacked ``tree``, ``old`` being the period's views the block was
    given.  A leaf the block wrote in place (attention's caches) is left
    as it is; a new one (the SSM block's) is copied in.  Where the new
    leaf's dtype differs (the SSM state, float32 after a bfloat16 decode
    step, as the reference's), the stacked leaf is first replaced by its
    copy in that dtype, so the change reaches the caller's tree."""
    for k, v in new.items():
        if isinstance(v, dict):
            _store(tree[k], i, old[k], v)
        elif v is not old[k]:
            if v.dtype != tree[k].dtype:
                tree[k] = tree[k].to(v.dtype)
            tree[k][i].copy_(v)


def decoder_apply(cfg: ModelConfig, dec_params, h, *, positions,
                  rules: Rules = None, caches=None, cache_len=None,
                  cross_kv_stack=None, train: bool = False):
    """Run the prefix layers, then the stacked periods, in order.

    caches: {"prefix": [cache, ...], "slots": [stacked cache, ...]} or
    None; updated in place (``_store``).  cross_kv_stack: {"prefix":
    [(k, v), ...], "slots": [(k, v) stacked per period, ...]} or None.
    ``train`` (with neither) recomputes each period in the backward.
    Returns (h, new_caches), new_caches being ``caches`` (the same tree)
    or None.
    """
    period = cfg.pattern
    for i, sp in enumerate(dec_params["prefix"]):   # attention: in place
        c = caches["prefix"][i] if caches is not None else None
        cr = cross_kv_stack["prefix"][i] if cross_kv_stack else None
        h, _ = _apply_slot(cfg, "attn", sp, h, positions=positions,
                           rules=rules, cache=c, cache_len=cache_len,
                           cross=cr)
    n_periods = (cfg.n_layers - len(dec_params["prefix"])) // len(period)
    if train and caches is None and cross_kv_stack is None:
        def period_fwd(h, i):
            for s, kind in enumerate(period):
                h, _ = _apply_slot(cfg, kind,
                                   _period(dec_params["slots"][s], i), h,
                                   positions=positions, rules=rules)
            return h
        for i in range(n_periods):
            h = checkpoint(period_fwd, h, i, use_reentrant=False)
        return h, None
    for i in range(n_periods):
        for s, kind in enumerate(period):
            c = (None if caches is None
                 else _period(caches["slots"][s], i))
            cr = (None if cross_kv_stack is None else
                  tuple(t[i] for t in cross_kv_stack["slots"][s]))
            h, nc = _apply_slot(cfg, kind, _period(dec_params["slots"][s], i),
                                h, positions=positions, rules=rules, cache=c,
                                cache_len=cache_len, cross=cr)
            if nc is not None:
                _store(caches["slots"][s], i, c, nc)
    return h, caches


def encoder_apply(cfg: ModelConfig, enc_params, frames, *, rules: Rules = None):
    """Whisper's encoder over frames (B, Se, D), the precomputed frame
    embeddings (the frontend is a stub, as in the reference): per layer
    non-causal GQA self-attention (rope included, as the reference's)
    and the MLP, then the final rmsnorm."""
    positions = torch.arange(frames.shape[1], device=frames.device)
    h = frames
    slots = enc_params["slots"][0]
    for i in range(cfg.encoder_layers):
        sp = _period(slots, i)
        hn = _gathered(layers.rmsnorm(sp["ln1"], h, cfg.norm_eps), rules)
        a, _ = layers.gqa_apply(cfg, sp["attn"], hn, positions=positions,
                                causal=False, rules=rules)
        h = h + a
        hn = _gathered(layers.rmsnorm(sp["ln2"], h, cfg.norm_eps), rules)
        if "w_gate" in sp["mlp"]:
            h = h + layers.swiglu_apply(sp["mlp"], hn)
        else:
            h = h + layers.gelu_mlp_apply(sp["mlp"], hn)
    return layers.rmsnorm(enc_params["final_norm"], h, cfg.norm_eps)
