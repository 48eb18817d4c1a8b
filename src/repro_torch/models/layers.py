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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .sharding import ParamSpec

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
                    blk: int = 1024) -> torch.Tensor:
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
    chunks, which bounds the transient memory at any length.
    """
    H, Sk, K = q.shape[2], k.shape[1], k.shape[2]
    if H % K or Sk % blk:
        raise ValueError(f"flash_attention needs H % K == 0 and Sk % blk "
                         f"== 0; got H={H} K={K} Sk={Sk} blk={blk}")
    return _Flash.apply(q, k, v, q_offset, causal, blk)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     kv_len) -> torch.Tensor:
    """Direct attention for a few queries (decode) over the whole cache,
    key positions >= ``kv_len`` masked."""
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
    k = (enc_out @ p["wk"]).reshape(B, Se, K, hd)
    v = (enc_out @ p["wv"]).reshape(B, Se, K, hd)
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
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    if cfg.qk_norm:
        q = l2norm(q, cfg.norm_eps) * p["q_norm"].to(q.dtype)
    if cross is not None:
        k, v = cross
        out = decode_attention(q, k, v, kv_len=k.shape[1])
        return out.reshape(B, S, H * hd) @ p["wo"], None
    k = (x @ p["wk"]).reshape(B, S, K, hd)
    v = (x @ p["wv"]).reshape(B, S, K, hd)
    if cfg.qk_norm:
        k = l2norm(k, cfg.norm_eps) * p["k_norm"].to(k.dtype)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        start = int(cache_len)
        ck, cv = cache["k"], cache["v"]
        if start < 0 or start + S > ck.shape[1]:
            raise ValueError(f"cache write at {start}..{start + S} outside "
                             f"a cache of {ck.shape[1]} positions")
        ck[:, start:start + S] = k.to(ck.dtype)
        cv[:, start:start + S] = v.to(cv.dtype)
        new_cache = {"k": ck, "v": cv}
        if S == 1:
            out = decode_attention(q, ck, cv, kv_len=start + S)
        else:
            # prefill: the fresh tokens are the whole valid cache content
            out = flash_attention(q, k, v, 0, True, pick_blk(S))
    else:
        out = flash_attention(q, k, v, 0, causal, pick_blk(k.shape[1]))
    return out.reshape(B, S, H * hd) @ p["wo"], new_cache


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
    q = q.reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    kv = x @ p["wkv_a"]                                  # (B, S, r + dr)
    ckv = rmsnorm({"scale": p["kv_norm"]}, kv[..., :r], cfg.norm_eps)
    krope = rope(kv[..., r:][..., None, :], positions,
                 cfg.rope_theta)[..., 0, :]              # (B, S, dr), shared
    return q_nope, q_rope, ckv, krope


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
        if start < 0 or start + S > cc.shape[1]:
            raise ValueError(f"cache write at {start}..{start + S} outside "
                             f"a cache of {cc.shape[1]} positions")
        cc[:, start:start + S] = ckv.to(cc.dtype)
        cr[:, start:start + S] = krope.to(cr.dtype)
        new_cache = {"ckv": cc, "krope": cr}
        if S == 1:
            wk_b = p["wk_b"].reshape(r, H, dn)
            wv_b = p["wv_b"].reshape(r, H, dv)
            q_c = torch.einsum("bshd,rhd->bshr", q_nope, wk_b)   # absorb W_UK
            scale = (dn + dr) ** -0.5
            s = (_f32_product("bshr,btr->bhst", q_c, cc)
                 + _f32_product("bshd,btd->bhst", q_rope, cr)) * scale
            k_pos = torch.arange(cc.shape[1], device=x.device)
            s = torch.where(k_pos < start + S, s, NEG_INF)
            prob = torch.softmax(s, dim=-1)
            o_c = _f32_product("bhst,btr->bshr", prob.to(cc.dtype), cc)
            out = torch.einsum("bshr,rhd->bshd", o_c.to(x.dtype), wv_b)
            return out.reshape(B, S, H * dv) @ p["wo"], new_cache

    # train / prefill: per-head K and V expanded from the latent
    k_nope = torch.einsum("btr,rhd->bthd", ckv, p["wk_b"].reshape(r, H, dn))
    v = torch.einsum("btr,rhd->bthd", ckv, p["wv_b"].reshape(r, H, dv))
    k = torch.cat([k_nope, krope[:, :, None, :].expand(
        *k_nope.shape[:3], dr)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = flash_attention(q, k, v, 0, True, pick_blk(k.shape[1]))
    return out.reshape(B, S, H * dv) @ p["wo"], new_cache


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
