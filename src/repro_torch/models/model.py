"""Model assembly: abstract parameters, caches, forward and the serving
steps (the port's counterpart of ``repro.models.model``).

Batch conventions:
  forward: {"tokens": (B,S) int [, "patches" (B,P,D) | "frames" (B,Se,D)]}
           -> logits (B,S,V)
  loss_fn: forward's batch + {"labels": (B,S) int, < 0 masked} -> scalar
  prefill: {"tokens": (B,S) [, "frames"]} + empty cache -> last-position
           logits + cache
  decode:  token (B,1) + cache + cache_len (a Python int) -> logits + cache

Every family serves and trains: ``dense`` and ``vlm`` (GQA), ``moe``
(routed and shared experts; DeepSeek-V2's MLA attention and dense first
layer), ``ssm`` (Mamba2), ``hybrid`` (Jamba: SSM and attention slots,
MoE on every second) and ``audio`` (Whisper: the encoder runs over
``frames``, and every decoder layer cross-attends its output, projected
once per layer into (k, v)).

Caches are updated in place (``transformer.decoder_apply``): attention
writes its K/V or latent rows; an SSM block's state leaf turns float32 at
the first bfloat16 decode step, as the reference's, the stacked leaf being
replaced in the caller's tree.  Prefill puts Whisper's cross (k, v) into
``cache["cross"]`` (the leaves replaced, in the projections' dtype, as the
reference's prefill returns them); decode reads them and never rewrites
them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import device as dev

from .config import ModelConfig
from .sharding import (ParamSpec, Rules, constrain, from_local, is_dtensor,
                       meshed, placements, to_pspec, tree_leaves, tree_map)
from . import layers, ssm as ssm_mod, transformer

# ---------------------------------------------------------------------------
# Abstract parameters
# ---------------------------------------------------------------------------


def model_abstract(cfg: ModelConfig):
    D, V = cfg.d_model, cfg.padded_vocab
    p = {
        "embed": ParamSpec((V, D), ("tensor", "fsdp")),
        "decoder": transformer.decoder_abstract(cfg),
        "final_norm": layers.rmsnorm_abstract(D),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = ParamSpec((D, V), ("fsdp", "tensor"))
    if cfg.is_encoder_decoder:
        p["encoder"] = transformer.encoder_abstract(cfg)
    return p


def _slot_cache_abstract(cfg: ModelConfig, kind: str, batch: int,
                         max_seq: int):
    if kind == "ssm":
        return {"attn": ssm_mod.ssm_cache_abstract(cfg, batch)}
    if cfg.attn_type == "mla":
        return {"attn": layers.mla_cache_abstract(cfg, batch, max_seq)}
    return {"attn": layers.gqa_cache_abstract(cfg, batch, max_seq)}


def cache_abstract(cfg: ModelConfig, batch: int, max_seq: int):
    """Decode-cache pytree mirroring the decoder structure."""
    nd = cfg.moe.first_dense if cfg.moe else 0
    n_periods = (cfg.n_layers - nd) // len(cfg.pattern)
    c = {
        "prefix": [
            _slot_cache_abstract(cfg, "attn", batch, max_seq)
            for _ in range(nd)],
        "slots": [
            transformer._stack(
                _slot_cache_abstract(cfg, kind, batch, max_seq), n_periods)
            for kind in cfg.pattern],
    }
    if cfg.is_encoder_decoder:
        K, hd = cfg.n_kv_heads, cfg.head_dim
        Se = cfg.encoder_seq
        ax = ("batch", None, None, None)
        c["cross"] = {
            "prefix": [
                {"k": ParamSpec((batch, Se, K, hd), ax),
                 "v": ParamSpec((batch, Se, K, hd), ax)} for _ in range(nd)],
            "slots": [
                transformer._stack(
                    {"k": ParamSpec((batch, Se, K, hd), ax),
                     "v": ParamSpec((batch, Se, K, hd), ax)}, n_periods)
                for _ in cfg.pattern],
        }
    return c


def cache_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device=None):
    """Materialize a zeroed decode cache on ``device`` (resolved: ``cuda``
    unless asked otherwise)."""
    dtype = dtype or cache_dtype(cfg)
    device = dev.resolve(device)
    return tree_map(lambda s: torch.zeros(s.shape, dtype=dtype,
                                          device=device),
                    cache_abstract(cfg, batch, max_seq))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _embed(cfg: ModelConfig, params, tokens, rules=None):
    if is_dtensor(params["embed"]):
        return _embed_sharded(params["embed"], tokens, rules)
    return params["embed"][tokens]


def _embed_sharded(table, tokens, rules):
    """The rows of ``tokens`` from a DTensor table, vocab-parallel, as
    Megatron's embedding: the table split over the model axis by rows
    (its ``fsdp`` columns gathered), each rank looking up the tokens that
    fall in its rows (zeros for the others), one sum over the model axis.
    The tokens keep their batch split.  DTensor's own lookup refuses a
    batch split on two mesh dims (pod, data) in torch 2.11 and misplaces
    its masked partial rows in 2.13."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh, tax = table.device_mesh, rules.tensor
    names = tuple(mesh.mesh_dim_names)
    tok_pl = tuple(Replicate() if n == tax else p
                   for n, p in zip(names, tokens.placements))
    t_pl = placements(to_pspec(("tensor", None), rules), mesh)
    # the table's gradient sums the tokens of every batch shard
    t_grad = tuple(Partial() if q.is_shard() else p
                   for p, q in zip(t_pl, tok_pl))
    tl = tokens.redistribute(mesh, tok_pl).to_local()
    wl = table.redistribute(mesh, t_pl).to_local(grad_placements=t_grad)
    shape, off = compute_local_shape_and_global_offset(table.shape, mesh,
                                                       t_pl)
    rel = tl - off[0]
    inside = (rel >= 0) & (rel < shape[0])
    rows = torch.where(inside[..., None],
                       F.embedding(torch.where(inside, rel, 0), wl), 0.0)
    out = from_local(rows, mesh, tuple(Partial() if n == tax else p
                                       for n, p in zip(names, tok_pl)),
                     (*tokens.shape, table.shape[1]))
    return out.redistribute(mesh, tok_pl)


def _lm_logits(cfg: ModelConfig, params, h):
    if cfg.tie_embeddings:
        return h @ params["embed"].T
    return h @ params["lm_head"]


def _cross_stack(cfg: ModelConfig, params, enc_out):
    """Each decoder layer's cross (k, v) from the encoder output: a pair
    per prefix layer, and per slot the pair stacked over the periods."""
    dec = params["decoder"]
    prefix = [layers.cross_kv(cfg, sp["xattn"], enc_out)
              for sp in dec["prefix"]]
    slots = []
    for slot in dec["slots"]:
        kvs = [layers.cross_kv(cfg, transformer._period(slot["xattn"], i),
                               enc_out)
               for i in range(slot["xattn"]["wk"].shape[0])]
        slots.append(tuple(torch.stack(t) for t in zip(*kvs)))
    return {"prefix": prefix, "slots": slots}


def _encode(cfg: ModelConfig, params, batch, dtype, rules):
    """The cross stack of an encoder-decoder config, else None."""
    if not cfg.is_encoder_decoder:
        return None
    enc_out = transformer.encoder_apply(
        cfg, params["encoder"], batch["frames"].to(dtype), rules=rules)
    return _cross_stack(cfg, params, enc_out)


def cross_stack_to_cache(cross_stack):
    to_dict = lambda kv: {"k": kv[0], "v": kv[1]}  # noqa: E731
    return {"prefix": [to_dict(kv) for kv in cross_stack["prefix"]],
            "slots": [to_dict(kv) for kv in cross_stack["slots"]]}


def cache_to_cross_stack(cross_cache):
    to_kv = lambda d: (d["k"], d["v"])  # noqa: E731
    return {"prefix": [to_kv(d) for d in cross_cache["prefix"]],
            "slots": [to_kv(d) for d in cross_cache["slots"]]}


@meshed
def forward(cfg: ModelConfig, params, batch, *, rules: Rules = None,
            train: bool = False):
    """Full-sequence forward -> logits (B, S_tokens, V).  A vision config
    prepends ``batch["patches"]`` (B, P, D) to the token embeddings and
    drops their positions from the logits; an encoder-decoder one encodes
    ``batch["frames"]`` (B, Se, D).  ``train`` recomputes each decoder
    period in the backward (``transformer.decoder_apply``)."""
    tokens = batch["tokens"]
    h = _embed(cfg, params, tokens, rules).to(cache_dtype(cfg))
    n_prepend = 0
    if cfg.frontend == "vision" and "patches" in batch:
        patches = batch["patches"].to(h.dtype)
        n_prepend = patches.shape[1]
        h = torch.cat([patches, h], dim=1)
    h = constrain(h, rules, "batch", "seq_sp", None)
    cross_stack = _encode(cfg, params, batch, h.dtype, rules)
    positions = torch.arange(h.shape[1], device=h.device)
    h, _ = transformer.decoder_apply(cfg, params["decoder"], h,
                                     positions=positions, rules=rules,
                                     cross_kv_stack=cross_stack, train=train)
    h = layers.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    h = constrain(h, rules, "batch", None, None)
    if n_prepend:
        h = h[:, n_prepend:, :]
    return _lm_logits(cfg, params, h)


@meshed
def loss_fn(cfg: ModelConfig, params, batch, *, rules: Rules = None):
    """Next-token cross entropy (labels shifted by the caller), over the
    float32 logits, the vocab-pad columns set to -1e30, labels < 0
    masked, the sum over the max(count, 1) unmasked ones."""
    logits = forward(cfg, params, batch, rules=rules, train=True).float()
    labels = batch["labels"]
    if cfg.padded_vocab != cfg.vocab_size:      # mask vocab-pad columns
        col = torch.arange(cfg.padded_vocab, device=logits.device)
        logits = torch.where(col < cfg.vocab_size, logits, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    # a masked label gathers column 0 (the reference's take wraps -1 to
    # the last): either way its term is multiplied by 0
    if is_dtensor(logits):
        # the same value, summed over one hit and exact zeros: DTensor's
        # gather from vocab-sharded logits fails to reduce its masked
        # partial result (torch 2.11-2.13)
        col = torch.arange(logits.shape[-1], device=logits.device)
        gold = torch.where(col == labels.clamp(min=0)[..., None], logits,
                           0.0).sum(-1)
    else:
        gold = torch.gather(logits, -1,
                            labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


@meshed
def prefill(cfg: ModelConfig, params, batch, cache, *, rules: Rules = None):
    """Process the prompt, fill the cache (in place).  Returns
    (last_logits (B,1,V), cache).

    A vision config's ``patches`` are ignored here, as in the reference's
    prefill; an encoder-decoder config encodes ``batch["frames"]`` and
    writes each layer's cross (k, v) into ``cache["cross"]``'s leaves.
    """
    tokens = batch["tokens"]
    h = _embed(cfg, params, tokens, rules).to(cache_dtype(cfg))
    h = constrain(h, rules, "batch", "seq_sp", None)
    sub_cache = {k: v for k, v in cache.items() if k != "cross"}
    cross_stack = _encode(cfg, params, batch, h.dtype, rules)
    positions = torch.arange(h.shape[1], device=h.device)
    h, new_cache = transformer.decoder_apply(
        cfg, params["decoder"], h, positions=positions, rules=rules,
        caches=sub_cache, cache_len=0, cross_kv_stack=cross_stack)
    if cross_stack is not None:
        for dst, src in zip(tree_leaves(cache["cross"]),
                            tree_leaves(cross_stack_to_cache(cross_stack))):
            dst.copy_(src)
        new_cache["cross"] = cache["cross"]
    h = constrain(h, rules, "batch", None, None)
    h = layers.rmsnorm(params["final_norm"], h[:, -1:, :], cfg.norm_eps)
    return _lm_logits(cfg, params, h), new_cache


@meshed
def decode_step(cfg: ModelConfig, params, token, cache, cache_len: int, *,
                rules: Rules = None):
    """One new token against a cache holding ``cache_len`` positions (a
    Python int: no device value to read back in the decode loop).  Returns
    (logits (B,1,V), cache), the cache written in place."""
    cache_len = int(cache_len)
    h = _embed(cfg, params, token, rules).to(cache_dtype(cfg))
    sub_cache = {k: v for k, v in cache.items() if k != "cross"}
    cross_stack = (cache_to_cross_stack(cache["cross"])
                   if cfg.is_encoder_decoder else None)
    positions = cache_len + torch.arange(1, device=h.device)
    h, new_cache = transformer.decoder_apply(
        cfg, params["decoder"], h, positions=positions, rules=rules,
        caches=sub_cache, cache_len=cache_len, cross_kv_stack=cross_stack)
    if cfg.is_encoder_decoder:
        new_cache["cross"] = cache["cross"]
    h = layers.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return _lm_logits(cfg, params, h), new_cache


# ---------------------------------------------------------------------------
# Parameter counting
# ---------------------------------------------------------------------------


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact parameter count from the abstract tree.  active_only: replace
    each MoE layer's expert bank with (top_k + n_shared) experts — the 6·N·D
    'active parameters' convention for MoE FLOPs."""
    total = sum(math.prod(s.shape)
                for s in tree_leaves(model_abstract(cfg)))
    if active_only and cfg.moe is not None:
        mo = cfg.moe
        D, F, E = cfg.d_model, mo.d_expert, mo.num_experts
        per_expert = 3 * D * F
        nd = mo.first_dense
        n_moe = sum(
            1 for s in range(len(cfg.pattern))
            if transformer._slot_is_moe(cfg, s)) * (
                (cfg.n_layers - nd) // len(cfg.pattern))
        total -= n_moe * (E - mo.top_k) * per_expert
    return total


def non_embedding_params(cfg: ModelConfig, active_only: bool = False) -> int:
    n = count_params(cfg, active_only)
    n -= cfg.padded_vocab * cfg.d_model        # input embedding table
    return n
