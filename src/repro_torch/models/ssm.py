"""Mamba2 block via SSD, state-space duality (arXiv:2405.21060; the port's
counterpart of ``repro.models.ssm``).

Train and prefill run the chunked SSD algorithm: the sequence is cut into
Q-length chunks; within a chunk the recurrence is a masked quadratic form,
and across chunks a Python loop carries the (B, H, N, P) state (the
reference's ``lax.scan``).  Decode is the O(1) recurrence

    h <- exp(dt·A) h + dt · B ⊗ x,   y = C·h + D·x.

Dtypes follow the reference's promotion step for step: a bfloat16
operand meeting a float32 one is widened (``torch.einsum`` refuses the
mix JAX promotes), so in bfloat16 ``ssd_chunked`` returns y and the final
state in float32, ``ssd_step`` returns its state in float32 and y in
bfloat16, and the decode cache's state leaf turns float32 at the first
decode step (``ssm_apply`` stores it uncast, as the reference's does).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .sharding import (ParamSpec, from_local, is_dtensor, merge, mesh_sizes,
                       placements, unflatten)
from . import layers


def ssm_abstract(cfg: ModelConfig):
    sc = cfg.ssm
    D = cfg.d_model
    Din = sc.d_inner(D)
    H = sc.n_heads(D)
    N = sc.d_state
    conv_ch = Din + 2 * N
    return {
        "w_zx": ParamSpec((D, 2 * Din), ("fsdp", "tensor")),
        "w_bc": ParamSpec((D, 2 * N), ("fsdp", None)),
        "w_dt": ParamSpec((D, H), ("fsdp", None)),
        "dt_bias": ParamSpec((H,), (None,), init="zeros"),
        "A_log": ParamSpec((H,), (None,), init="zeros"),
        "D_skip": ParamSpec((H,), (None,), init="ones"),
        "conv_w": ParamSpec((sc.d_conv, conv_ch), (None, None)),
        "conv_b": ParamSpec((conv_ch,), (None,), init="zeros"),
        "norm": ParamSpec((Din,), (None,), init="ones"),
        "w_out": ParamSpec((Din, D), ("tensor", "fsdp")),
    }


def ssm_cache_abstract(cfg: ModelConfig, batch: int):
    sc = cfg.ssm
    D = cfg.d_model
    Din, H, N = sc.d_inner(D), sc.n_heads(D), sc.d_state
    return {
        "state": ParamSpec((batch, H, N, sc.head_dim),
                           ("batch", None, None, None)),
        "conv": ParamSpec((batch, sc.d_conv - 1, Din + 2 * N),
                          ("batch", None, None)),
    }


def _promoted(*ts):
    """``ts`` widened to their common dtype (JAX's promotion of a
    bfloat16 operand meeting a float32 one)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def _einsum(eq: str, *ts) -> torch.Tensor:
    return torch.einsum(eq, *_promoted(*ts))


def _causal_conv_train(w, b, u):
    """Depthwise causal conv over (B, L, C); width = w.shape[0].  The
    shifted products are summed in order, in the input's dtype."""
    dw, L = w.shape[0], u.shape[1]
    # the zero rows by a concatenation, not F.pad (which DTensor
    # misplaces in torch 2.11)
    u_pad = torch.cat([torch.zeros_like(u[:, :1]).expand(-1, dw - 1, -1),
                       u], dim=1)
    out = u_pad[:, 0:L, :] * w[0]
    for i in range(1, dw):
        out = out + u_pad[:, i:i + L, :] * w[i]
    return out + b


def _causal_conv_step(w, b, conv_cache, u_new):
    """conv_cache (B, dw-1, C); u_new (B, 1, C) -> (out (B,1,C), new cache)."""
    window = torch.cat([conv_cache, u_new], dim=1)               # (B, dw, C)
    out = _einsum("btc,tc->bc", window, w)[:, None, :] + b
    return out, window[:, 1:, :]


def ssd_chunked(x, dt, A, B, C, *, chunk: int, rules=None):
    """Chunked SSD scan.

    x (B,L,H,P) pre-scaled inputs; dt (B,L,H) post-softplus; A (H,) negative;
    B, C (B,L,N).  Returns (y (B,L,H,P), final_state (B,H,N,P)).  On
    DTensors it runs on local shards (``_heads_local``).
    """
    Bsz, L, H, P = x.shape
    if is_dtensor(x):
        return _heads_local(
            lambda *a: ssd_chunked(*a, chunk=chunk), rules, Bsz, H, (
                (x, ("batch", None, "heads", None), False),
                (dt, ("batch", None, "heads"), False),
                (A, ("heads",), False), (B, ("batch", None, None), True),
                (C, ("batch", None, None), True)), (
                (("batch", None, "heads", None), x.shape),
                (("batch", "heads", None, None),
                 (Bsz, H, B.shape[-1], P))))
    N = B.shape[-1]
    Q = min(chunk, L)
    assert L % Q == 0, (L, Q)
    nc = L // Q

    def r(t):
        return unflatten(t, 1, (nc, Q))
    xc, dtc, Bc, Cc = r(x), r(dt), r(B), r(C)

    dA = dtc * A                                       # (B,c,Q,H) negative
    # The within-chunk cumsum and its differences are taken in float64,
    # each result rounded once to dA's dtype.  In float32 (the
    # reference's) cs_i - cs_j cancels: a chunk of 256 at dt ~ 0.8 reaches
    # |cs| ~ 200, where an ulp is 1.5e-5, and the decays' rounding then
    # depends on the cumsum's summation order (ROADMAP C).
    cs64 = torch.cumsum(dA.double(), dim=2)
    cs = cs64.to(dA.dtype)

    # ---- intra-chunk (masked quadratic form) -----------------------------
    # att[b,c,i,j,h] = exp(cs_i - cs_j) * (C_i . B_j) * dt_j,  j <= i
    seg = (cs64[:, :, :, None, :] - cs64[:, :, None, :, :]).to(dA.dtype)
    idx = torch.arange(Q, device=x.device)
    mask = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    decay = torch.exp(torch.where(mask, seg, -torch.inf))
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)              # (B,c,Q,Q)
    att = cb[..., None] * decay * dtc[:, :, None, :, :]       # (B,c,Q,Q,H)
    y_diag = _einsum("bcijh,bcjhp->bcihp", att, xc)

    # ---- chunk states and the inter-chunk recurrence ---------------------
    last = cs64[:, :, -1:, :]                                 # (B,c,1,H)
    w_state = torch.exp((last - cs64).to(dA.dtype)) * dtc     # (B,c,Q,H)
    states = _einsum("bcjn,bcjh,bcjhp->bchnp", Bc, w_state, xc).float()
    chunk_decay = torch.exp(cs[:, :, -1, :]).float()          # (B,c,H)

    h = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    h_in = []
    for c in range(nc):
        h_in.append(h)                                        # state entering
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_in = torch.stack(h_in, dim=1)                           # (B,c,H,N,P)

    # ---- off-diagonal contribution ---------------------------------------
    h_dec = (torch.exp(cs)[..., None, None] * h_in[:, :, None]).to(x.dtype)
    y_off = torch.einsum("bcin,bcihnp->bcihp", Cc, h_dec)     # (B,c,Q,H,P)
    y = merge(y_diag + y_off, 1)
    return y, h


def _heads_local(fn, rules, B: int, H: int, args, outs):
    """``fn`` (``ssd_chunked`` or ``ssd_step``) on each rank's local
    shards: the batch split over the batch axes where they divide B, and
    the heads over the model axis where they divide H (else whole on
    every rank of it).  ``args``: (tensor, logical spec, heads-free) —
    a heads-free operand (SSD's B and C) is whole over the model axis and
    its gradient leaves each rank as a partial sum, which DTensor
    reduces.  ``outs``: each output's (spec, global shape).  Specs name
    ``"batch"`` and ``"heads"``; a gradient is summed over the ranks that
    used its operand whole."""
    from torch.distributed.tensor import Partial
    mesh = next(a for a, _, _ in args if is_dtensor(a)).device_mesh
    sizes = mesh_sizes(mesh)
    baxes = tuple(a for a in rules.batch if a in sizes)
    if not baxes or B % math.prod(sizes[a] for a in baxes):
        baxes = ()
    bspec = (baxes if len(baxes) > 1 else baxes[0]) if baxes else None
    tax = rules.tensor if rules.tensor in sizes else None
    hspec = tax if tax and H % sizes[tax] == 0 else None
    names = tuple(mesh.mesh_dim_names)

    def pl(spec):
        return placements(tuple({"batch": bspec, "heads": hspec}.get(a)
                                for a in spec), mesh)

    local = []
    for t, spec, shared in args:
        want = pl(spec)
        # a gradient sums over the ranks whose shards used the operand
        # whole: the model axis for a heads-free one, the batch axes for
        # one without a batch dim (A)
        sums = (tax,) if shared and hspec else ()
        sums += baxes if "batch" not in spec else ()
        grad = tuple(Partial() if n in sums else q
                     for n, q in zip(names, want))
        local.append(t.redistribute(mesh, want).to_local(grad_placements=grad))
    got = fn(*local)
    return tuple(from_local(g, mesh, pl(spec), shape)
                 for g, (spec, shape) in zip(got, outs))


def ssd_step(state, x, dt, A, B, C, rules=None):
    """One-token recurrence.  state (B,H,N,P); x (B,H,P); dt (B,H);
    B, C (B,N).  On DTensors it runs on local shards (``_heads_local``)."""
    if is_dtensor(x):
        Bsz, H = x.shape[:2]
        return _heads_local(ssd_step, rules, Bsz, H, (
            (state, ("batch", "heads", None, None), False),
            (x, ("batch", "heads", None), False),
            (dt, ("batch", "heads"), False), (A, ("heads",), False),
            (B, ("batch", None), True), (C, ("batch", None), True)), (
            (("batch", "heads", None, None), state.shape),
            (("batch", "heads", None), x.shape)))
    dA = torch.exp(dt * A)                                    # (B,H)
    upd = torch.einsum("bn,bh,bhp->bhnp", B, dt, x)
    state = state * dA[:, :, None, None] + upd.to(state.dtype)
    y = torch.einsum("bn,bhnp->bhp", C, state.to(x.dtype))
    return state, y


def ssm_apply(cfg: ModelConfig, p, xres: torch.Tensor, *, cache=None,
              rules=None):
    """Full Mamba2 block.  xres (B, S, D) -> (out, new_cache).

    ``new_cache`` ({"conv", "state"}) holds new tensors, not writes into
    ``cache``: the caller stores them (``transformer.decoder_apply``),
    widening a stacked leaf whose dtype the step changed.
    """
    sc = cfg.ssm
    Bsz, S, D = xres.shape
    Din = sc.d_inner(D)
    H, N, P = sc.n_heads(D), sc.d_state, sc.head_dim

    zx = xres @ p["w_zx"]
    z, xin = zx[..., :Din], zx[..., Din:]
    bc = xres @ p["w_bc"]
    dt_raw = xres @ p["w_dt"]
    conv_in = torch.cat([xin, bc], dim=-1)                    # (B,S,Din+2N)

    new_cache = None
    if cache is None or S > 1:
        conv_out = _causal_conv_train(p["conv_w"], p["conv_b"], conv_in)
        if cache is not None:       # prefill: keep the conv tail for decode
            new_cache = {"conv": conv_in[:, S - (sc.d_conv - 1):, :].to(
                cache["conv"].dtype)}
    else:
        conv_out, conv_state = _causal_conv_step(
            p["conv_w"], p["conv_b"], cache["conv"], conv_in)
        new_cache = {"conv": conv_state.to(cache["conv"].dtype)}
    conv_out = F.silu(conv_out)
    xc = unflatten(conv_out[..., :Din], -1, (H, P))
    Bmat = conv_out[..., Din:Din + N]
    Cmat = conv_out[..., Din + N:]

    A = -torch.exp(p["A_log"].float())
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())

    if cache is None or S > 1:
        y, hT = ssd_chunked(xc, dt.to(xc.dtype), A, Bmat, Cmat,
                            chunk=sc.chunk, rules=rules)
        if cache is not None:
            new_cache["state"] = hT.to(cache["state"].dtype)
    else:
        state, y1 = ssd_step(cache["state"], xc[:, 0],
                             dt[:, 0].to(xc.dtype), A, Bmat[:, 0],
                             Cmat[:, 0], rules=rules)
        new_cache["state"] = state
        y = y1[:, None]
    y = y + p["D_skip"].to(y.dtype)[None, None, :, None] * xc
    y = merge(y, 2)
    y = layers.rmsnorm({"scale": p["norm"]}, y * F.silu(z), cfg.norm_eps)
    y, w_out = _promoted(y, p["w_out"])
    return y @ w_out, new_cache
