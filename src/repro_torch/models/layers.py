"""Transformer building blocks: norms, RoPE, attention, MLPs (the port's
counterpart of ``repro.models.layers``).

Everything is functional: ``*_abstract(cfg)`` returns a pytree of
``ParamSpec``, and ``*_apply(cfg, params, ...)`` is the forward over
plain dicts of tensors.  The numerics follow the reference step for step,
since bfloat16 shows every change of rounding order: the norms and RoPE
compute in float32 and cast back; a learned qk-norm scale multiplies after
that cast; attention scores and the PV product accumulate in float32 (the
reference's ``preferred_element_type``), with the probabilities rounded
to v's dtype first.

Attention is the reference's own algorithm in plain torch ops: train and
prefill run the chunked online-softmax ("flash") forward — a loop over key
blocks carrying (max, sum, acc) — and decode attends over the whole cache
masked by ``kv_len``.  ``flash_attention`` is a ``torch.autograd.Function``
with the reference's block-recompute backward (its custom VJP): it saves
(q, k, v, out, lse) and recomputes each probability tile from them.  No
Pallas kernel backs any of it in the reference, so it is no kernel slot
here; a hand-written attention kernel is later work.

GQA and MLA (DeepSeek-V2's latent attention, with its absorbed decode),
Whisper's cross-attention (``cross_kv`` and the ``cross=`` path of
``gqa_apply``), SwiGLU and Whisper's GELU MLP.

On a mesh (``rules`` with one, DTensor operands) attention runs on each
rank's local shards (``_local_attention``: the batch over the batch
axes, the query heads or rows over the model axis), a decode over a
cache whose keys are split over the model axis takes its softmax across
ranks (``_split_key_attention``, ``_mla_decode_local``), and the cache
is written shard by shard (``write_rows``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

import math

from .config import ModelConfig
from .sharding import (ParamSpec, constrain, from_local, is_dtensor,
                       merge, mesh_sizes, placements, unflatten)

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_abstract(dim: int):
    return {"scale": ParamSpec((dim,), (None,), init="ones")}


def rmsnorm(params, x: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dt)


def l2norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-head qk-norm (Qwen3 style), no learned scale on the head axis."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding, half-split.  x (..., S, H, d) with d even;
    positions (..., S)."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    ang = positions[..., None].float() * freqs              # (..., S, d/2)
    cos = torch.cos(ang)[..., None, :]                      # (..., S, 1, d/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Flash-style chunked attention (GQA-aware), forward
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def pick_blk(sk: int) -> int:
    """The largest listed key tile that divides Sk, else Sk itself."""
    for b in (4096, 2048, 1024, 512, 256, 128, 64):
        if sk % b == 0:
            return b
    return sk


def _f32_product(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` with float32 accumulation and a float32 result, the
    reference's ``preferred_element_type=float32`` (a bfloat16 product is
    exact in float32)."""
    return torch.einsum(eq, a.float(), b.float())


# a float32 (query rows x blk) score tile above this many bytes splits the
# query rows into chunks (each row's arithmetic is unchanged)
TILE_BYTES = 1 << 28


def _row_chunk(B: int, H: int, Sq: int, blk: int) -> int:
    """Query rows a chunk: all Sq, or as many as keep one float32 score
    tile of a key block within ``TILE_BYTES`` (at least one)."""
    return max(1, min(Sq, TILE_BYTES // (B * H * blk * 4)))


def _flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               q_offset: int, causal: bool, blk: int):
    """Online-softmax forward.  Returns (out (B,Sq,H,dv) in q's dtype,
    lse (B,K,G,Sq) float32): the log-sum-exp is the only statistic the
    backward needs; no (Sq x Sk) tensor outlives a block.  Query rows are
    independent, so a long query runs in chunks of ``_row_chunk`` rows,
    each over every key block."""
    B, Sq, H, dq = q.shape
    Sk, K, dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // K
    qg = q.reshape(B, Sq, K, G, dq)
    scale = dq ** -0.5
    out = torch.empty((B, Sq, H, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, K, G, Sq), dtype=torch.float32, device=q.device)
    rows = _row_chunk(B, H, Sq, blk)
    for i in range(0, Sq, rows):
        r = slice(i, min(i + rows, Sq))
        n = r.stop - i
        q_pos = q_offset + torch.arange(i, r.stop, device=q.device)
        m = torch.full((B, K, G, n), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, K, G, n), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, K, G, n, dv), dtype=torch.float32,
                          device=q.device)
        for j in range(Sk // blk):
            k_j = k[:, j * blk:(j + 1) * blk]
            v_j = v[:, j * blk:(j + 1) * blk]
            s = _f32_product("bqkgd,btkd->bkgqt", qg[:, r], k_j) * scale
            if causal:
                k_pos = j * blk + torch.arange(blk, device=q.device)
                mask = q_pos[:, None] >= k_pos[None, :]
                s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            del s
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            pv = _f32_product("bkgqt,btkd->bkgqd", p.to(v_j.dtype), v_j)
            del p
            acc = acc * alpha[..., None] + pv
            m = m_new
        l = torch.clamp(l, min=1e-30)
        out[:, r] = (acc / l[..., None]).permute(0, 3, 1, 2, 4).reshape(
            B, n, H, dv).to(q.dtype)
        lse[..., r] = m + torch.log(l)
    return out, lse


def _flash_bwd(q, k, v, out, lse, dout, q_offset: int, causal: bool,
               blk: int):
    """The reference's block-recompute backward: each block's probability
    tile is rebuilt from (q, k_j, lse); the products take their operands
    in the storage dtype with float32 accumulation, ``ds`` is rounded to
    k's dtype, and dq, dk and dv accumulate in float32, each cast to the
    storage dtype once.  The query rows run in the forward's chunks (dk
    and dv summed over them; one chunk is the reference's arithmetic).
    The elementwise steps run in place on the block's tiles (the same
    values as the reference's expressions: IEEE products commute), so
    that at most about two float32 (rows x blk) tiles are live at once."""
    B, Sq, H, dq = q.shape
    Sk, K, dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // K
    scale = dq ** -0.5
    qg = q.reshape(B, Sq, K, G, dq)
    do = dout.reshape(B, Sq, K, G, dv)
    og = out.reshape(B, Sq, K, G, dv)
    delta = _f32_product("bqkgd,bqkgd->bkgq", do, og)
    f32 = dict(dtype=torch.float32, device=q.device)
    dq_acc = torch.zeros((B, Sq, K, G, dq), **f32)
    dk = torch.zeros((B, Sk, K, dq), **f32)
    dvv = torch.zeros((B, Sk, K, dv), **f32)
    rows = _row_chunk(B, H, Sq, blk)
    for i in range(0, Sq, rows):
        r = slice(i, min(i + rows, Sq))
        q_pos = q_offset + torch.arange(i, r.stop, device=q.device)
        for j in range(Sk // blk):
            t = slice(j * blk, (j + 1) * blk)
            k_j, v_j = k[:, t], v[:, t]
            p = _f32_product("bqkgd,btkd->bkgqt", qg[:, r], k_j).mul_(scale)
            if causal:
                k_pos = j * blk + torch.arange(blk, device=q.device)
                p.masked_fill_(q_pos[:, None] < k_pos[None, :], NEG_INF)
            p.sub_(lse[..., r, None]).exp_()                    # normalized
            dvv[:, t] += _f32_product("bkgqt,bqkgd->btkd", p.to(do.dtype),
                                      do[:, r])
            ds = _f32_product("bqkgd,btkd->bkgqt", do[:, r], v_j)  # dp
            ds = ds.sub_(delta[..., r, None]).mul_(p).mul_(scale).to(
                k_j.dtype)
            del p
            dq_acc[:, r] += _f32_product("bkgqt,btkd->bqkgd", ds, k_j)
            dk[:, t] += _f32_product("bkgqt,bqkgd->btkd", ds, qg[:, r])
    return (dq_acc.reshape(B, Sq, H, dq).to(q.dtype), dk.to(k.dtype),
            dvv.to(v.dtype))


class _Flash(torch.autograd.Function):
    """The reference's ``custom_vjp``: saves (q, k, v, out, lse) only."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, causal, blk):
        out, lse = _flash_fwd(q, k, v, q_offset, causal, blk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.static = (q_offset, causal, blk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, dout, *ctx.static)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_offset: int = 0, causal: bool = True,
                    blk: int = 1024, rules=None) -> torch.Tensor:
    """Online-softmax attention over key blocks of ``blk``, with a
    block-recompute backward.

    q (B,Sq,H,dq), k (B,Sk,K,dq), v (B,Sk,K,dv), H % K == 0, Sk % blk == 0;
    query i sits at position ``q_offset + i``.  Returns (B,Sq,H,dv) in
    q's dtype.  Masked scores are ``NEG_INF`` (not -inf), and the running
    sum is clamped at 1e-30, as the reference's.  Plain autograd through
    the loop would keep every probability tile, B·H·Sq·Sk float32 values
    in all; the backward recomputes each tile from the saved log-sum-exp
    instead (``q_offset``, ``causal`` and ``blk`` take no gradient).  A
    tile holds at most ``TILE_BYTES``: beyond that the query rows run in
    chunks, which bounds the transient memory at any length.  DTensor
    operands run on local shards (``_local_attention``, ``rules``'
    layout).
    """
    H, Sk, K = q.shape[2], k.shape[1], k.shape[2]
    if H % K or Sk % blk:
        raise ValueError(f"flash_attention needs H % K == 0 and Sk % blk "
                         f"== 0; got H={H} K={K} Sk={Sk} blk={blk}")
    if is_dtensor(q):       # DTensor does not enter a custom Function
        return _local_attention(
            lambda ql, kl, vl, row: _Flash.apply(ql, kl, vl, q_offset + row,
                                                 causal, blk), q, k, v, rules)
    return _Flash.apply(q, k, v, q_offset, causal, blk)


def _flash_layout(rules, B: int, Sq: int, H: int, K: int):
    """Where a sharded attention runs: (batch placement axes, the model
    axis's dim in q, or None).  The batch splits over the batch axes where
    they divide B.  Over the model axis the query heads split where they
    divide and each rank's heads group onto whole kv heads (a rank then
    reads only its kv heads); else the query rows split (each rank over
    every key)."""
    sizes = mesh_sizes(rules.mesh)
    baxes = tuple(a for a in rules.batch if a in sizes)
    if not baxes or B % math.prod(sizes[a] for a in baxes):
        baxes = ()
    tax = rules.tensor
    if tax is None:
        return baxes, None
    n_t, G = sizes[tax], H // K
    h = H // n_t
    if H % n_t == 0 and (h % G == 0 or G % h == 0):
        return baxes, 2
    return baxes, 1


def _local_attention(fn, q, k, v, rules):
    """Attention ``fn(q, k, v, first_row)`` run on each rank's local
    shards, laid out by ``_flash_layout``: the batch split over the batch
    axes, and over the model axis the query heads (each rank slicing its
    kv heads from k and v, which arrive whole over it) or the query rows
    (``first_row`` the rank's first; the output gathered back to whole
    rows, so that the output projection takes the (B·S) rows of a
    batch-split tensor).  k's and v's gradients leave each rank as
    partial sums over the model axis, which DTensor reduces."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh = q.device_mesh
    B, Sq, H, _ = q.shape
    K = k.shape[2]
    baxes, qdim = _flash_layout(rules, B, Sq, H, K)
    names = tuple(mesh.mesh_dim_names)
    bspec = (baxes if len(baxes) > 1 else baxes[0]) if baxes else None
    qspec = [bspec, None, None, None]
    if qdim is not None:
        qspec[qdim] = rules.tensor
    q_pl = placements(tuple(qspec), mesh)
    kv_pl = placements((bspec, None, None, None), mesh)
    kv_grad = tuple(Partial() if n == rules.tensor and qdim is not None
                    else pl for n, pl in zip(names, kv_pl))
    ql = q.redistribute(mesh, q_pl).to_local(grad_placements=q_pl)
    kl = k.redistribute(mesh, kv_pl).to_local(grad_placements=kv_grad)
    vl = v.redistribute(mesh, kv_pl).to_local(grad_placements=kv_grad)
    _, off = compute_local_shape_and_global_offset(q.shape, mesh, q_pl)
    if qdim == 2:
        G = H // K
        lo = off[2] // G
        hi = (off[2] + ql.shape[2] - 1) // G + 1
        kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
    shape = (*q.shape[:3], v.shape[3])
    out = from_local(fn(ql, kl, vl, off[1] if qdim == 1 else 0), mesh,
                     q_pl, shape)
    if qdim == 1:   # gathered rows, their local tensor made contiguous
        out = from_local(out.redistribute(mesh, kv_pl).to_local(), mesh,
                         kv_pl, shape)
    return out


def _model_dim(x, rules):
    """The index of the rules' model axis in ``x``'s mesh, or None."""
    names = tuple(x.device_mesh.mesh_dim_names)
    return names.index(rules.tensor) if rules.tensor in names else None


def _split_keys(rules, cache) -> bool:
    """Whether a DTensor cache has its sequence (keys) split over the
    model axis (``kv_seq``)."""
    i = _model_dim(cache, rules)
    return i is not None and cache.placements[i].is_shard(1)


def _split_key_softmax(s, k_pos, kv_len, mesh, i):
    """``softmax(where(k_pos < kv_len, s, NEG_INF))`` over the last dim
    of local scores ``s`` whose keys (global positions ``k_pos``) are
    split over mesh dim ``i``: the maximum and the sum taken over every
    rank's keys (two all-reduces), each probability the one-device one
    up to the sum's order (flash-decoding)."""
    import torch.distributed._functional_collectives as funcol
    s = torch.where(k_pos < kv_len, s, NEG_INF)
    m = funcol.all_reduce(s.amax(dim=-1, keepdim=True), "max", (mesh, i))
    e = torch.exp(s - m)
    return e / funcol.all_reduce(e.sum(dim=-1, keepdim=True), "sum",
                                 (mesh, i))


def _split_key_attention(q, k, v, kv_len, rules):
    """``decode_attention`` over a cache whose keys are split over the
    model axis (no gradient: the decode step): every rank scores all the
    query heads against its own keys, the softmax runs across ranks
    (``_split_key_softmax``), and the partial outputs are summed over
    the model axis.  The batch keeps the cache's split."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh, i = k.device_mesh, _model_dim(k, rules)
    kv_pl = tuple(k.placements)
    q_pl = tuple(Replicate() if j == i else p for j, p in enumerate(kv_pl))
    ql = q.redistribute(mesh, q_pl).to_local()
    kl, vl = k.to_local(), v.redistribute(mesh, kv_pl).to_local()
    _, off = compute_local_shape_and_global_offset(k.shape, mesh, kv_pl)
    B, Sq, H, dq = ql.shape
    K = kl.shape[2]
    qg = ql.reshape(B, Sq, K, H // K, dq)
    s = _f32_product("bqkgd,btkd->bkgqt", qg, kl) * dq ** -0.5
    k_pos = off[1] + torch.arange(kl.shape[1], device=ql.device)
    p = _split_key_softmax(s, k_pos, kv_len, mesh, i)
    out = funcol.all_reduce(_f32_product("bkgqt,btkd->bkgqd",
                                         p.to(vl.dtype), vl), "sum",
                            (mesh, i))
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, vl.shape[-1])
    return from_local(out.to(ql.dtype), mesh, q_pl,
                      (*q.shape[:3], v.shape[3]))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     kv_len, rules=None) -> torch.Tensor:
    """Direct attention for a few queries (decode) over the whole cache,
    key positions >= ``kv_len`` masked.  On DTensors it runs on local
    shards: across ranks over a cache whose keys are split
    (``_split_key_attention``), else as ``flash_attention`` does
    (``_local_attention``)."""
    if is_dtensor(q):
        if _split_keys(rules, k):
            return _split_key_attention(q, k, v, kv_len, rules)
        return _local_attention(
            lambda ql, kl, vl, row: decode_attention(ql, kl, vl,
                                                     kv_len=kv_len),
            q, k, v, rules)
    B, Sq, H, dq = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, Sq, K, G, dq)
    scale = dq ** -0.5
    s = _f32_product("bqkgd,btkd->bkgqt", qg, k) * scale
    k_pos = torch.arange(k.shape[1], device=q.device)
    s = torch.where(k_pos < kv_len, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = _f32_product("bkgqt,btkd->bkgqd", p.to(v.dtype), v)
    dv = v.shape[-1]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, dv).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------


def gqa_abstract(cfg: ModelConfig):
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": ParamSpec((D, H * hd), ("fsdp", "tensor")),
        "wk": ParamSpec((D, K * hd), ("fsdp", "tensor")),
        "wv": ParamSpec((D, K * hd), ("fsdp", "tensor")),
        "wo": ParamSpec((H * hd, D), ("tensor", "fsdp")),
    }
    if cfg.qk_norm:
        p["q_norm"] = ParamSpec((hd,), (None,), init="ones")
        p["k_norm"] = ParamSpec((hd,), (None,), init="ones")
    return p


def gqa_cache_abstract(cfg: ModelConfig, batch: int, max_seq: int):
    K, hd = cfg.n_kv_heads, cfg.head_dim
    ax = ("batch", "kv_seq", None, None)
    return {"k": ParamSpec((batch, max_seq, K, hd), ax),
            "v": ParamSpec((batch, max_seq, K, hd), ax)}


def cross_kv(cfg: ModelConfig, p, enc_out: torch.Tensor):
    """Project the encoder output (B, Se, D) once into Whisper's cross
    (k, v), each (B, Se, K, hd): cached across decode steps."""
    B, Se, _ = enc_out.shape
    K, hd = cfg.n_kv_heads, cfg.head_dim
    k = unflatten(enc_out @ p["wk"], -1, (K, hd))
    v = unflatten(enc_out @ p["wv"], -1, (K, hd))
    if cfg.qk_norm:
        k = l2norm(k, cfg.norm_eps) * p["k_norm"].to(k.dtype)
    return k, v


def gqa_apply(cfg: ModelConfig, p, x: torch.Tensor, *, positions,
              cache=None, cache_len: int = None, cross=None,
              causal: bool = True, rules=None):
    """x (B, S, D).  Three modes:

      train   (cache None):     flash attention over x itself.
      prefill (cache, S > 1):   flash over x + write the cache at cache_len.
      decode  (cache, S == 1):  insert the token, attend over the cache.

    The cache ({"k", "v"}, (B, max_seq, K, hd)) is written in place at
    ``cache_len`` (a Python int) and returned.  A write past the cache's
    end raises: the reference's ``dynamic_update_slice`` would clamp the
    start instead, and no caller may rely on either.  Prefill attends over
    the fresh tokens only, as the reference's does.

    ``cross``: Whisper's precomputed (k, v) from ``cross_kv``, which
    replace the self-attention K/V whole: no rope, no mask, every query
    over all Se keys (``decode_attention``, in training and prefill too,
    as in the reference), and no cache.
    """
    B, S, D = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = unflatten(x @ p["wq"], -1, (H, hd))
    if cfg.qk_norm:
        q = l2norm(q, cfg.norm_eps) * p["q_norm"].to(q.dtype)
    if cross is not None:
        k, v = cross
        out = decode_attention(q, k, v, kv_len=k.shape[1], rules=rules)
        return merge(out, 2) @ p["wo"], None
    k = unflatten(x @ p["wk"], -1, (K, hd))
    v = unflatten(x @ p["wv"], -1, (K, hd))
    if cfg.qk_norm:
        k = l2norm(k, cfg.norm_eps) * p["k_norm"].to(k.dtype)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        start = int(cache_len)
        ck, cv = cache["k"], cache["v"]
        write_rows(ck, start, k)
        write_rows(cv, start, v)
        new_cache = {"k": ck, "v": cv}
        if S == 1:
            out = decode_attention(q, ck, cv, kv_len=start + S, rules=rules)
        else:
            # prefill: the fresh tokens are the whole valid cache content
            out = flash_attention(q, k, v, 0, True, pick_blk(S), rules)
    else:
        out = flash_attention(q, k, v, 0, causal, pick_blk(k.shape[1]),
                              rules)
    return merge(out, 2) @ p["wo"], new_cache


def write_rows(cache: torch.Tensor, start: int, new: torch.Tensor) -> None:
    """``cache[:, start:start + S] = new`` in place, in the cache's dtype;
    a write past the cache's end raises (the reference's
    ``dynamic_update_slice`` would clamp the start, and no caller may rely
    on either).

    A DTensor cache (its ``kv_seq`` dim split over the model axis) is
    written shard by shard: ``new`` goes to the cache's batch placement,
    whole in every other dim, and each rank copies the rows that fall in
    its own slice of the sequence."""
    S = new.shape[1]
    if start < 0 or start + S > cache.shape[1]:
        raise ValueError(f"cache write at {start}..{start + S} outside "
                         f"a cache of {cache.shape[1]} positions")
    if not is_dtensor(cache):
        cache[:, start:start + S] = new.to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh = cache.device_mesh
    pl = tuple(p if p == Shard(0) else Replicate() for p in cache.placements)
    src = (new if is_dtensor(new) else
           from_local(new, mesh, (Replicate(),) * mesh.ndim, new.shape))
    src = src.redistribute(mesh, pl).to_local()
    shape, off = compute_local_shape_and_global_offset(
        cache.shape, mesh, cache.placements)
    lo, hi = max(start, off[1]), min(start + S, off[1] + shape[1])
    if lo < hi:
        with torch.no_grad():
            cache.to_local()[:, lo - off[1]:hi - off[1]] = \
                src[:, lo - start:hi - start].to(cache.dtype)


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (DeepSeek-V2)
# ---------------------------------------------------------------------------


def mla_abstract(cfg: ModelConfig):
    D, H = cfg.d_model, cfg.n_heads
    r, qr = cfg.kv_lora_rank, cfg.q_lora_rank
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    return {
        "wq_a": ParamSpec((D, qr), ("fsdp", None)),
        "q_norm": ParamSpec((qr,), (None,), init="ones"),
        "wq_b": ParamSpec((qr, H * (dn + dr)), (None, "tensor")),
        "wkv_a": ParamSpec((D, r + dr), ("fsdp", None)),
        "kv_norm": ParamSpec((r,), (None,), init="ones"),
        "wk_b": ParamSpec((r, H * dn), (None, "tensor")),
        "wv_b": ParamSpec((r, H * dv), (None, "tensor")),
        "wo": ParamSpec((H * dv, D), ("tensor", "fsdp")),
    }


def mla_cache_abstract(cfg: ModelConfig, batch: int, max_seq: int):
    r, dr = cfg.kv_lora_rank, cfg.rope_head_dim
    return {"ckv": ParamSpec((batch, max_seq, r), ("batch", "kv_seq", None)),
            "krope": ParamSpec((batch, max_seq, dr),
                               ("batch", "kv_seq", None))}


def _mla_qkv(cfg: ModelConfig, p, x: torch.Tensor, positions):
    B, S, D = x.shape
    H = cfg.n_heads
    dn, dr, r = cfg.nope_head_dim, cfg.rope_head_dim, cfg.kv_lora_rank
    q = rmsnorm({"scale": p["q_norm"]}, x @ p["wq_a"], cfg.norm_eps) \
        @ p["wq_b"]
    q = unflatten(q, -1, (H, dn + dr))
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    kv = x @ p["wkv_a"]                                  # (B, S, r + dr)
    ckv = rmsnorm({"scale": p["kv_norm"]}, kv[..., :r], cfg.norm_eps)
    krope = rope(kv[..., r:][..., None, :], positions,
                 cfg.rope_theta)[..., 0, :]              # (B, S, dr), shared
    return q_nope, q_rope, ckv, krope


def _mla_decode_local(q_c, q_rope, cc, cr, kv_len, scale, rules):
    """The absorbed MLA decode's attention in the latent space on local
    shards: every rank holds all the heads and scores them against its
    own latent rows; where the rows are split over the model axis
    (``kv_seq``) the softmax and the output sum run across ranks
    (``_split_key_softmax``).  Returns o_c (B, S, H, r) float32, whole
    over the model axis, split as the cache's batch."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh = cc.device_mesh
    i = _model_dim(cc, rules) if _split_keys(rules, cc) else None
    kv_pl = tuple(cc.placements)
    q_pl = tuple(Replicate() if p.is_shard(1) else p for p in kv_pl)
    qcl = q_c.redistribute(mesh, q_pl).to_local()
    qrl = q_rope.redistribute(mesh, q_pl).to_local()
    ccl, crl = cc.to_local(), cr.redistribute(mesh, kv_pl).to_local()
    _, off = compute_local_shape_and_global_offset(cc.shape, mesh, kv_pl)
    s = (_f32_product("bshr,btr->bhst", qcl, ccl)
         + _f32_product("bshd,btd->bhst", qrl, crl)) * scale
    k_pos = off[1] + torch.arange(ccl.shape[1], device=ccl.device)
    if i is None:
        prob = torch.softmax(torch.where(k_pos < kv_len, s, NEG_INF), dim=-1)
    else:
        prob = _split_key_softmax(s, k_pos, kv_len, mesh, i)
    o_c = _f32_product("bhst,btr->bshr", prob.to(ccl.dtype), ccl)
    if i is not None:
        o_c = funcol.all_reduce(o_c, "sum", (mesh, i))
    return from_local(o_c, mesh, q_pl, (*q_c.shape[:3], cc.shape[2]))


def mla_apply(cfg: ModelConfig, p, x: torch.Tensor, *, positions,
              cache=None, cache_len: int = None, rules=None):
    """Multi-head latent attention.  Train and prefill expand K and V
    from the latent and run ``flash_attention`` over the fresh tokens.
    Decode (S == 1) takes the absorbed path: W_UK folds into q, and the
    scores and values live in the r-space of the latent cache, which
    holds (ckv, krope), r + dr values a token whatever the head count.

    The cache is written in place at ``cache_len`` (a Python int); a
    write past its end raises, as ``gqa_apply``'s does.
    """
    B, S, D = x.shape
    H = cfg.n_heads
    r, dn, dr, dv = (cfg.kv_lora_rank, cfg.nope_head_dim, cfg.rope_head_dim,
                     cfg.v_head_dim)
    q_nope, q_rope, ckv, krope = _mla_qkv(cfg, p, x, positions)

    new_cache = None
    if cache is not None:
        start = int(cache_len)
        cc, cr = cache["ckv"], cache["krope"]
        write_rows(cc, start, ckv)
        write_rows(cr, start, krope)
        new_cache = {"ckv": cc, "krope": cr}
        if S == 1:
            wk_b = unflatten(p["wk_b"], 1, (H, dn))
            wv_b = unflatten(p["wv_b"], 1, (H, dv))
            q_c = torch.einsum("bshd,rhd->bshr", q_nope, wk_b)   # absorb W_UK
            scale = (dn + dr) ** -0.5
            if is_dtensor(cc):
                o_c = _mla_decode_local(q_c, q_rope, cc, cr, start + S,
                                        scale, rules)
            else:
                s = (_f32_product("bshr,btr->bhst", q_c, cc)
                     + _f32_product("bshd,btd->bhst", q_rope, cr)) * scale
                k_pos = torch.arange(cc.shape[1], device=x.device)
                s = torch.where(k_pos < start + S, s, NEG_INF)
                prob = torch.softmax(s, dim=-1)
                o_c = _f32_product("bhst,btr->bshr", prob.to(cc.dtype), cc)
            out = torch.einsum("bshr,rhd->bshd", o_c.to(x.dtype), wv_b)
            return merge(out, 2) @ p["wo"], new_cache

    # train / prefill: per-head K and V expanded from the latent
    k_nope = torch.einsum("btr,rhd->bthd", ckv, unflatten(p["wk_b"], 1, (H, dn)))
    v = torch.einsum("btr,rhd->bthd", ckv, unflatten(p["wv_b"], 1, (H, dv)))
    k = torch.cat([k_nope, krope[:, :, None, :].expand(
        *k_nope.shape[:3], dr)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    # the expanded K and V are H·(dn + dr) wide, some 5x the residual
    # stream: attention runs head-sharded, as the reference constrains it
    q = constrain(q, rules, "batch", None, "tensor", None)
    k = constrain(k, rules, "batch", None, "tensor", None)
    v = constrain(v, rules, "batch", None, "tensor", None)
    out = flash_attention(q, k, v, 0, True, pick_blk(k.shape[1]), rules)
    out = constrain(merge(out, 2), rules, "batch", None,
                    "tensor")
    return out @ p["wo"], new_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def swiglu_abstract(d_model: int, d_ff: int):
    return {"w_gate": ParamSpec((d_model, d_ff), ("fsdp", "tensor")),
            "w_up": ParamSpec((d_model, d_ff), ("fsdp", "tensor")),
            "w_down": ParamSpec((d_ff, d_model), ("tensor", "fsdp"))}


def swiglu_apply(p, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def gelu_mlp_abstract(d_model: int, d_ff: int):
    """Whisper's GELU MLP."""
    return {"w_in": ParamSpec((d_model, d_ff), ("fsdp", "tensor")),
            "b_in": ParamSpec((d_ff,), (None,), init="zeros"),
            "w_out": ParamSpec((d_ff, d_model), ("tensor", "fsdp")),
            "b_out": ParamSpec((d_model,), (None,), init="zeros")}


def gelu_mlp_apply(p, x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default is the tanh approximation, not the exact
    erf form (they differ by up to ~5e-4 near |x| = 2.7)."""
    h = F.gelu(x @ p["w_in"] + p["b_in"], approximate="tanh")
    return h @ p["w_out"] + p["b_out"]
