"""The projection ops of the kernel path, with a worker axis.

Counterpart of ``repro.kernels.ops`` (``proj_gather``, ``proj_scatter``,
``block_projection``; ``cimmino_gather``, ``cimmino_scatter``,
``cimmino_update``; ``sparse_proj_update``, ``sparse_cimmino_update``)
and of ``repro.kernels.ref`` (their plain versions).  Each op takes every
worker at once — A (m, p, n), B (m, n, p), X (m, k, n) or (m, n),
right-hand sides b/V (m, k, p) or (m, p), and X̄ (k, n) or (n,) shared by
all workers (the reference's worker-vmapped ops with ``xbar``
unbatched); the sparse ops take the compressed vals (m, p, w), cols
(m, w) int64 and Bvals (m, w, p) in place of A and B — and each call is
ONE launch of each kernel for all m workers.

Dispatch is on the tensors' device, and only there: CUDA tensors launch
the hand-written kernels (``block_projection``), CPU tensors take the
plain PyTorch versions below, anything else raises.  Nothing falls back
from one to the other.  Both take the matrices (A, B, vals, Bvals) in a
storage dtype beside the compute dtype of the other operands, a pair of
``block_projection.PAIRS``: float64 or float32 throughout, or, under
``precision="mixed"``, bfloat16 matrices with float64 or float32
operands; results come in the compute dtype.  The plain versions widen a
bfloat16 matrix to the compute dtype first (exact), as JAX promotes
where ``torch.einsum`` refuses mixed dtypes.  ``proj_gather``,
``proj_scatter`` and ``block_projection`` also take the all-bf16 form
(bfloat16 matrices and operands, the reference's ``block_projection``
on bfloat16 x): float32 accumulation, U rounded to bfloat16 between the
two passes, γ applied as its bfloat16 value, Y in bfloat16.

The engine and tile choice of the reference's ops (ROADMAP A11), with
its names and environment variables:

* :func:`use_fused` — fused kernels or the unfused step, per (family, p,
  n, k, dtype): ``REPRO_KERNEL_ENGINE`` pin > cache > measured verdict
  (:func:`_measure_engine`, on the card by default, on the CPU only under
  ``REPRO_KERNEL_AUTOTUNE=1``) > the heuristic "fused everywhere except
  Cimmino below a full batch of 8".  The projection solvers' dispatch
  asks it (``solvers/projection.py``).
* :func:`pick_bn`/:func:`pick_tiles` — the reference's (BN, BP, BK)
  tiles, their caches and the ``REPRO_KERNEL_BN``/``BP``/``BK`` pins with
  its divisor checks.  On the card BK is the k-chunk KC of every launch
  (``block_projection.KC_VALUES``; a pinned BK outside them raises), and
  where the card measures (``REPRO_KERNEL_AUTOTUNE``, as above) the
  KC values dividing the padded k are timed on the gather+scatter pair.
  The card's kernels fix their n segment and their rows a block at
  compile time: BN and BP are validated, cached and returned as the
  reference's heuristic, and select nothing.

Every measurement runs eagerly, records itself with
``analysis.tracecheck``, counts no launch, and raises inside a CUDA graph
capture: the solvers resolve their verdicts before a capture
(``Solver.resolve_engine``), and a captured step reads only the caches.
Times on the card come from CUDA events on the caller's stream, waited
for with ``Event.synchronize()`` (never a device synchronize, which is
invalid while another thread captures).
"""
from __future__ import annotations

import logging
import math
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.analysis.tracecheck import record

from . import block_projection as bp
from .block_projection import launch_counts, reset_launch_counts  # noqa: F401

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernels' reference)
# ---------------------------------------------------------------------------


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The accumulation dtype of operands in ``dtype`` (the reference's
    ``_acc_dtype``): float32 for bfloat16, else ``dtype`` itself."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def _gamma(gamma: float, dtype: torch.dtype) -> float:
    """γ as the kernels apply it to operands in ``dtype``: its bfloat16
    value for the all-bf16 form (the reference's ``jnp.asarray(gamma,
    x.dtype)``), else γ."""
    if dtype == torch.bfloat16:
        return float(torch.tensor(gamma, dtype=dtype))
    return gamma


def apc_gather_ref(A, X, Xbar):
    """U = A_w (X̄ − X_w) per worker: A (m, p, n); X (m, n) or (m, k, n);
    X̄ (n,) or (k, n) -> U (m, p) or (m, k, p), accumulated in
    ``_acc(X.dtype)`` and returned in X's dtype."""
    acc = _acc(X.dtype)
    return torch.einsum("mpn,m...n->m...p", A.to(acc),
                        Xbar.to(acc) - X.to(acc)).to(X.dtype)


def apc_scatter_ref(B, X, Xbar, U, gamma):
    """Y = X_w + γ((X̄ − X_w) − B_w U_w) per worker: B (m, n, p); computed
    in ``_acc(X.dtype)``, returned in X's dtype."""
    acc = _acc(X.dtype)
    x = X.to(acc)
    d = Xbar.to(acc) - x
    return (x + _gamma(gamma, X.dtype) * (d - torch.einsum(
        "mnp,m...p->m...n", B.to(acc), U.to(acc)))).to(X.dtype)


def block_projection_ref(A, B, X, Xbar, gamma):
    """The full worker update Y = X + γ P (X̄ − X) with P = I − B A (U
    in X's dtype between the two passes)."""
    return apc_scatter_ref(B, X, Xbar, apc_gather_ref(A, X, Xbar), gamma)


def cimmino_gather_ref(A, Xbar):
    """U = A_w X̄ per worker: A (m, p, n); X̄ (n,) or (k, n) -> U (m, p) or
    (m, k, p)."""
    return torch.einsum("mpn,...n->m...p", A.to(Xbar.dtype), Xbar)


def cimmino_scatter_ref(B, V):
    """R = B_w V_w per worker: B (m, n, p); V (m, p) or (m, k, p)."""
    return torch.einsum("mnp,m...p->m...n", B.to(V.dtype), V)


def cimmino_update_ref(A, B, b, Xbar):
    """The full row projection R = B_w (b_w − A_w X̄) per worker."""
    return cimmino_scatter_ref(B, b - cimmino_gather_ref(A, Xbar))


def _support(cols, D):
    """D (m, [k,] n) at each worker's support columns -> (m, [k,] w), and
    the index it took."""
    idx = cols if D.dim() == 2 else cols[:, None, :].expand(
        D.shape[:-1] + (-1,))
    return torch.take_along_dim(D, idx, dim=-1), idx


def sparse_gather_ref(vals, cols, X, Xbar):
    """U = vals_w (X̄ − X_w)[cols_w] per worker: vals (m, p, w); cols
    (m, w); X (m, n) or (m, k, n); X̄ (n,) or (k, n) -> (m, [k,] p)."""
    return torch.einsum("mpw,m...w->m...p", vals.to(X.dtype),
                        _support(cols, Xbar - X)[0])


def sparse_cimmino_gather_ref(vals, cols, Xbar):
    """U = vals_w X̄[cols_w] per worker -> (m, p) or (m, k, p)."""
    Xb = Xbar.expand((vals.shape[0],) + Xbar.shape)   # (m, [k,] n)
    return torch.einsum("mpw,m...w->m...p", vals.to(Xbar.dtype),
                        _support(cols, Xb)[0])


def sparse_scatter_ref(Bvals, cols, U, out, X=None, Xbar=None, gamma=0.0):
    """``out`` (m, [k,] n) with C = Bvals_w U_w scatter-added at cols_w,
    as the reference adds: C itself (Cimmino form), or −γC when X and X̄
    are given (APC form; ``out`` then already holds X + γ(X̄ − X)).
    Returns a new tensor."""
    C = torch.einsum("mwp,m...p->m...w", Bvals.to(U.dtype), U)
    idx = _support(cols, out)[1]
    return out.scatter_add(-1, idx, C if X is None else -gamma * C)


def sparse_proj_update_ref(vals, cols, Bvals, X, Xbar, gamma):
    """The sparse APC/consensus worker update on the compressed support
    (the reference's ``sparse_proj_update_ref`` per worker): returns
    (Y, U), Y = X + γ(X̄ − X) − γ Bvals U at cols."""
    U = sparse_gather_ref(vals, cols, X, Xbar)
    Y = X + gamma * (Xbar - X)
    return sparse_scatter_ref(Bvals, cols, U, Y, X, Xbar, gamma), U


def sparse_cimmino_update_ref(vals, cols, Bvals, b, Xbar):
    """The sparse block-Cimmino row projection (the reference's
    ``sparse_cimmino_update_ref`` per worker): returns (R, U), R =
    Bvals (b − U) at cols and zero elsewhere, U = vals X̄[cols]."""
    U = sparse_cimmino_gather_ref(vals, cols, Xbar)
    R = U.new_zeros(U.shape[:-1] + Xbar.shape[-1:])
    return sparse_scatter_ref(Bvals, cols, b - U, R), U


# ---------------------------------------------------------------------------
# The ops
# ---------------------------------------------------------------------------


def on_cuda(op: str, *tensors: torch.Tensor) -> bool:
    """True for all-CUDA tensors, False for all-CPU ones; raises on mixed
    or other devices.  The one device predicate of the port's kernel
    paths: the ops below and the captured histories
    (``solvers.executor``)."""
    kinds = {t.device.type for t in tensors}
    if kinds not in ({"cuda"}, {"cpu"}):
        raise ValueError(f"{op}: operands on {sorted(kinds)}; expected all "
                         f"on CUDA (kernel) or all on the CPU (plain "
                         f"version)")
    return kinds == {"cuda"}


#: the kernel whose dtype pairs (``block_projection.pairs``) an op takes,
#: where its name is not the kernel's
_OP_KERNEL = {"proj_gather": "apc_gather", "proj_scatter": "apc_scatter",
              "sparse_proj_update": "sparse_gather",
              "sparse_cimmino_update": "sparse_cimmino_gather"}


def _on_cuda(op: str, matrices: tuple, *operands: torch.Tensor) -> bool:
    """:func:`on_cuda` of every tensor; raises, besides, on dtypes the
    kernels do not take: the ``matrices`` in one dtype and the
    ``operands`` in one, a pair of ``block_projection.pairs`` of the op's
    kernel (the all-bf16 pair: the APC ops alone)."""
    cuda = on_cuda(op, *matrices, *operands)
    mats = {t.dtype for t in matrices}
    dtypes = {t.dtype for t in operands}
    pairs = bp.pairs(_OP_KERNEL.get(op, op))
    if (len(mats) != 1 or len(dtypes) != 1
            or (*mats, *dtypes) not in pairs):
        raise TypeError(
            f"{op}: dtypes {sorted(map(str, mats))} (matrices) with "
            f"{sorted(map(str, dtypes))} (operands); expected one of "
            + ", ".join(f"{a}/{b}" for a, b in pairs))
    return cuda


def _index_on(cols, like):
    """The plain sparse versions index with int64 cols on the values'
    device."""
    if cols.dtype != torch.int64 or cols.device != like.device:
        raise TypeError(f"cols must be int64 on {like.device}, got "
                        f"{cols.dtype} on {cols.device}")


def _rows(X, Xbar):
    """The kernels' (m, k, n) / (k, n) views of a single-RHS (m, n) / (n,)
    pair (no copies); ``squeeze`` says whether to drop k again."""
    if X.dim() == 2:
        return X.unsqueeze(1), Xbar.unsqueeze(0), True
    return X, Xbar, False


def _k(X: torch.Tensor, batched: int) -> int:
    """The batch rows of an operand whose unbatched form has ``batched``
    − 1 dimensions."""
    return X.shape[-2] if X.dim() == batched else 1


def proj_gather(A, X, Xbar):
    """u_w = A_w (x̄ − x_w) for every worker -> (m, p) or (m, k, p)."""
    cuda = _on_cuda("proj_gather", (A,), X, Xbar)
    kc = launch_kc(A, A.shape[2], A.shape[1], _k(X, 3), X.dtype)
    if not cuda:
        return apc_gather_ref(A, X, Xbar)
    X3, Xb2, squeeze = _rows(X, Xbar)
    U = bp.apc_gather(A, X3, Xb2, kc=kc)
    return U.squeeze(1) if squeeze else U


def proj_scatter(B, X, Xbar, U, gamma: float):
    """y_w = x_w + γ((x̄ − x_w) − B_w u_w) for every worker, in X's shape."""
    cuda = _on_cuda("proj_scatter", (B,), X, Xbar, U)
    kc = launch_kc(B, B.shape[1], B.shape[2], _k(X, 3), X.dtype)
    if not cuda:
        return apc_scatter_ref(B, X, Xbar, U, gamma)
    X3, Xb2, squeeze = _rows(X, Xbar)
    Y = bp.apc_scatter(B, X3, Xb2, U.unsqueeze(1) if squeeze else U, gamma,
                       kc=kc)
    return Y.squeeze(1) if squeeze else Y


def block_projection(A, B, X, Xbar, gamma: float):
    """y = x + γ(d − B(A d)), d = x̄ − x, for every worker: one gather and
    one scatter launch for all m workers (and all k batch rows)."""
    return proj_scatter(B, X, Xbar, proj_gather(A, X, Xbar), gamma)


def cimmino_gather(A, Xbar):
    """u_w = A_w x̄ for every worker -> (m, p) or (m, k, p)."""
    cuda = _on_cuda("cimmino_gather", (A,), Xbar)
    kc = launch_kc(A, A.shape[2], A.shape[1], _k(Xbar, 2), Xbar.dtype)
    if not cuda:
        return cimmino_gather_ref(A, Xbar)
    U = bp.cimmino_gather(A, Xbar.unsqueeze(0) if Xbar.dim() == 1 else Xbar,
                          kc=kc)
    return U.squeeze(1) if Xbar.dim() == 1 else U


def cimmino_scatter(B, V):
    """r_w = B_w v_w for every worker -> (m, n) or (m, k, n).  V may be the
    (m, k, p) transposed view of a (k, m, p) batch (no copy)."""
    cuda = _on_cuda("cimmino_scatter", (B,), V)
    kc = launch_kc(B, B.shape[1], B.shape[2], _k(V, 3), V.dtype)
    if not cuda:
        return cimmino_scatter_ref(B, V)
    R = bp.cimmino_scatter(B, V.unsqueeze(1) if V.dim() == 2 else V, kc=kc)
    return R.squeeze(1) if V.dim() == 2 else R


def cimmino_residual(b, U):
    """v = b − u, contiguous whatever the strides of b and u: b may be
    the (m, k, p) view of a (k, m, p) batch whose p axis is not the
    unit-stride one, and the scatter kernel takes v with a unit stride
    along p."""
    return torch.sub(b, U, out=U.new_empty(U.shape))


def cimmino_update(A, B, b, Xbar):
    """r_w = B_w (b_w − A_w x̄) for every worker: one gather and one
    scatter launch for all m workers (and all k batch rows).  The master
    update x̄ += ν Σ_w r_w stays outside, as in the reference."""
    return cimmino_scatter(B, cimmino_residual(b, cimmino_gather(A, Xbar)))


def sparse_proj_update(vals, cols, Bvals, X, Xbar, gamma: float):
    """The sparse APC/consensus worker update for every worker -> (Y, U),
    Y in X's shape, U (m, [k,] p) = vals_w (X̄ − X_w)[cols_w], the fused
    residual source.  On CUDA: one ``sparse_gather`` launch (the support
    gather happens in its staged loads), the AXPY pre-pass
    Y = X + γ(X̄ − X) for the off-support columns, and one
    ``sparse_scatter`` launch that stores the support columns of Y."""
    cuda = _on_cuda("sparse_proj_update", (vals, Bvals), X, Xbar)
    kc = launch_kc(vals, vals.shape[2], vals.shape[1], _k(X, 3), X.dtype)
    if not cuda:
        _index_on(cols, vals)
        return sparse_proj_update_ref(vals, cols, Bvals, X, Xbar, gamma)
    X3, Xb2, squeeze = _rows(X, Xbar)
    U = bp.sparse_gather(vals, cols, X3, Xb2, kc=kc)
    Y = X3 + gamma * (Xb2 - X3)
    bp.sparse_scatter(Bvals, cols, U, Y, X=X3, Xbar=Xb2, gamma=gamma, kc=kc)
    return (Y.squeeze(1), U.squeeze(1)) if squeeze else (Y, U)


def sparse_cimmino_update(vals, cols, Bvals, b, Xbar):
    """The sparse block-Cimmino row projection for every worker -> (R, U):
    R (m, [k,] n) = Bvals_w (b_w − U_w) at cols_w and zero elsewhere,
    U = vals_w X̄[cols_w] (the residual block is U − b).  On CUDA: one
    ``sparse_cimmino_gather`` and one ``sparse_scatter`` launch; the
    worker sum of R stays outside, as in the reference."""
    cuda = _on_cuda("sparse_cimmino_update", (vals, Bvals), b, Xbar)
    kc = launch_kc(vals, vals.shape[2], vals.shape[1], _k(Xbar, 2),
                   Xbar.dtype)
    if not cuda:
        _index_on(cols, vals)
        return sparse_cimmino_update_ref(vals, cols, Bvals, b, Xbar)
    squeeze = Xbar.dim() == 1
    U = bp.sparse_cimmino_gather(vals, cols,
                                 Xbar.unsqueeze(0) if squeeze else Xbar,
                                 kc=kc)
    V = cimmino_residual(b.unsqueeze(1) if squeeze else b, U)
    m, k, _ = U.shape
    R = U.new_zeros((m, k, Xbar.shape[-1]))
    bp.sparse_scatter(Bvals, cols, V, R, kc=kc)
    return (R.squeeze(1), U.squeeze(1)) if squeeze else (R, U)


# ---------------------------------------------------------------------------
# Tile choice: the reference's (BN, BP, BK), and the card's k-chunk
# ---------------------------------------------------------------------------

BN_ENV = "REPRO_KERNEL_BN"
BP_ENV = "REPRO_KERNEL_BP"
BK_ENV = "REPRO_KERNEL_BK"
AUTOTUNE_ENV = "REPRO_KERNEL_AUTOTUNE"

#: the reference's default lane tile, and its candidates: the heuristic
#: choice is the first that divides the padded n
DEFAULT_BN = 512
BN_CANDIDATES = (DEFAULT_BN, 1024, 256, 128)

# (p_pad, n_pad, dtype name) -> BN
_BN_CACHE: dict = {}
# (k_pad, p_pad, n_pad, dtype name) -> (bp, bk)
_TILE_CACHE: dict = {}
# the _TILE_CACHE keys whose bk the card measured (a KC to launch with)
_KC_MEASURED: set = set()
# one measurement at a time (an engine measurement's fused ops resolve
# their tiles inside it: reentrant); the caches are read without it
_tune_lock = threading.RLock()


def _pad_to(size: int, mult: int) -> int:
    return int(size) + (-int(size)) % mult


def _k_pad(k: int) -> int:
    """The reference's padded batch: 1 stays 1, else a multiple of 8."""
    return 1 if int(k) == 1 else _pad_to(k, 8)


def _dtype_name(dtype) -> str:
    """'float64', 'bfloat16', ...: the reference's cache-key spelling
    (``np.dtype(dtype).name``), of a torch or a numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def _device(device) -> torch.device:
    """Where the kernels would run: ``device``, or without one the card
    when there is one (the reference's "compiled where the hardware
    is")."""
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


def _autotune_enabled(cuda: bool) -> bool:
    """Measure?  ``REPRO_KERNEL_AUTOTUNE`` when set, else on the card and
    not on the CPU, whose plain versions say nothing of the kernels'
    times (the reference's "not interpret")."""
    env = os.environ.get(AUTOTUNE_ENV)
    if env is not None:
        return env.strip().lower() not in ("0", "false", "no", "off")
    return cuda


def bn_cache_clear() -> None:
    """Drop every cached BN choice (tests / re-tuning)."""
    _BN_CACHE.clear()


def bn_cache() -> dict:
    """The live {(p_pad, n_pad, dtype): bn} cache (read-only use)."""
    return dict(_BN_CACHE)


def tile_cache_clear() -> None:
    """Drop every cached (bp, bk) choice (tests / re-tuning)."""
    with _tune_lock:
        _TILE_CACHE.clear()
        _KC_MEASURED.clear()


def tile_cache() -> dict:
    """The live {(k_pad, p_pad, n_pad, dtype): (bp, bk)} cache
    (read-only use)."""
    return dict(_TILE_CACHE)


def pick_bn(n_pad: int, p_pad: int = 8, dtype=torch.float32) -> int:
    """The lane tile of a (p, n) block: env pin > cache > the first of
    ``BN_CANDIDATES`` dividing the padded n (the reference's heuristic).

    The card's kernels stream a fixed 512-byte segment of each row a
    stage and take no BN, so nothing is measured: the choice is
    validated, cached and returned as the reference's, and selects
    nothing on the card.
    """
    env = os.environ.get(BN_ENV)
    if env:
        bn = int(env)
        if n_pad % bn:
            raise ValueError(
                f"{BN_ENV}={bn} does not divide the padded n={n_pad} "
                f"(n pads to a multiple of 128; pick a 128-multiple tile "
                f"that divides it)")
        return bn
    key = (int(p_pad), int(n_pad), _dtype_name(dtype))
    hit = _BN_CACHE.get(key)
    if hit is None:
        hit = _BN_CACHE[key] = next(
            (c for c in BN_CANDIDATES if n_pad % c == 0), 128)
    return hit


def _tile_key(k_pad: int, p_pad: int, n_pad: int, dtype) -> tuple:
    """The reference's tile-cache key."""
    return (int(k_pad), int(p_pad), int(n_pad), _dtype_name(dtype))


def _env_tile(env_name: str, axis_pad: int, axis: str):
    """An env-pinned sublane tile, validated against the padded axis."""
    env = os.environ.get(env_name)
    if not env:
        return None
    t = int(env)
    if axis_pad % t:
        raise ValueError(
            f"{env_name}={t} does not divide the padded {axis}={axis_pad} "
            f"({axis} pads to a multiple of 8; pick an 8-multiple tile "
            f"that divides it)")
    return t


def _no_capture(what: str, device: torch.device) -> None:
    """Timing inside a CUDA graph capture is invalid: raise there."""
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"{what} would be measured inside a CUDA graph capture; "
            f"resolve it before the capture (Solver.resolve_engine)")


def _best_s(run, reps: int, device: torch.device) -> float:
    """The least time of ``reps`` separately timed calls of ``run`` after
    one warm-up call, in seconds: CUDA events on the caller's stream
    (waited for with ``Event.synchronize()``) on the card, the host clock
    on the CPU."""
    run()
    best = math.inf
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            t = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            run()
            t = time.perf_counter() - t0
        best = min(best, t)
    return best


def _randn(gen, device, dtype, *shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float64).to(dtype)


def _compute(dtype, compute_dtype) -> torch.dtype:
    """The operands' dtype a measurement runs in: ``compute_dtype``, or
    the matrix's own; a bfloat16 matrix without one: float32."""
    if compute_dtype is not None:
        return compute_dtype
    return torch.float32 if dtype == torch.bfloat16 else dtype


def _measure_kc(k_pad: int, p_pad: int, n_pad: int, dtype, device,
                compute_dtype, cands) -> int:
    """The card's k-chunk for a (k, p, n) gather+scatter pair: each KC of
    ``cands`` timed on the pair, best of 3 after a warm-up (the
    reference's ``_measure_tiles``), on dummy operands over a worker axis
    that gives the ring at least one 64-row tile an SM at KC = 8 (and
    each matrix at most 1 GiB)."""
    record("measure tiles", f"k={k_pad} p={p_pad} n={n_pad} "
           f"{_dtype_name(dtype)}")
    _no_capture("the tile choice", device)
    cdt = _compute(dtype, compute_dtype)
    size = torch.empty((), dtype=dtype).element_size()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    mw = max(1, min(-(-64 * sms // p_pad),
                    2 ** 30 // (p_pad * n_pad * size)))
    gen = torch.Generator(device=device).manual_seed(0)
    A = _randn(gen, device, dtype, mw, p_pad, n_pad)
    B = _randn(gen, device, dtype, mw, n_pad, p_pad)
    X = _randn(gen, device, cdt, mw, k_pad, n_pad)
    Xb = _randn(gen, device, cdt, k_pad, n_pad)
    times = {}
    with bp.captured_launches():           # no launch of the path
        for kc in cands:
            def run(kc=kc):
                U = bp.apc_gather(A, X, Xb, kc=kc)
                return bp.apc_scatter(B, X, Xb, U, 1.0, kc=kc)
            times[kc] = _best_s(run, 3, device)
    best = min(times, key=times.get)
    log.debug("measured KC=%d for (k=%d, p=%d, n=%d, %s): %s", best, k_pad,
              p_pad, n_pad, _dtype_name(dtype), times)
    return best


def pick_tiles(n_pad: int, p_pad: int = 8, k_pad: int = 1,
               dtype=torch.float32, *, device=None, compute_dtype=None):
    """The (bn, bp, bk) tiling of a (k, p, n) kernel call: BN from
    :func:`pick_bn`; BP and BK: env pin (``REPRO_KERNEL_BP``/
    ``REPRO_KERNEL_BK``, each a divisor of its padded axis) > cache >
    measurement > the whole axis, as the reference resolves them.

    BK is the card's k-chunk KC.  Where the card measures
    (:func:`_autotune_enabled` on ``device``, the card by default) and
    more than one of ``block_projection.KC_VALUES`` divides the padded k,
    those KC values are timed (:func:`_measure_kc`, with operands in
    ``compute_dtype``) and the fastest is cached as bk, with BP the whole
    p.  Elsewhere (the CPU, whose plain versions have no KC) the cache
    holds the whole axes, as the reference's heuristic.
    """
    bn = pick_bn(n_pad, p_pad, dtype)
    bpp = _env_tile(BP_ENV, p_pad, "p")
    bk = _env_tile(BK_ENV, k_pad, "k")
    if bpp is not None and bk is not None:
        return bn, bpp, bk
    key = _tile_key(k_pad, p_pad, n_pad, dtype)
    hit = _TILE_CACHE.get(key)
    if hit is None:
        with _tune_lock:
            hit = _TILE_CACHE.get(key)
            if hit is None:
                device = _device(device)
                cands = [kc for kc in bp.KC_VALUES if k_pad % kc == 0]
                if (device.type == "cuda" and _autotune_enabled(True)
                        and len(cands) > 1):
                    hit = (int(p_pad), _measure_kc(
                        key[0], key[1], key[2], dtype, device,
                        compute_dtype, cands))
                    _KC_MEASURED.add(key)
                else:
                    hit = (int(p_pad), int(k_pad))
                _TILE_CACHE[key] = hit
    return bn, (bpp if bpp is not None else hit[0]), \
        (bk if bk is not None else hit[1])


def launch_kc(M: torch.Tensor, n: int, p: int, k: int,
              dtype: torch.dtype) -> Optional[int]:
    """The k-chunk a launch of the kernel on the matrix stack ``M`` (m, p,
    n) or (m, n, p) with k batch rows in ``dtype`` takes: a pinned BK
    (``REPRO_KERNEL_BK``; a value the library does not instantiate
    raises), a measured one (:func:`pick_tiles`), or None, the library's
    own.  Every op calls it, on either device, so a bad pin raises on the
    CPU as in the reference."""
    k_pad = _k_pad(k)
    _, _, bk = pick_tiles(_pad_to(n, 128), _pad_to(p, 8), k_pad, M.dtype,
                          device=M.device, compute_dtype=dtype)
    if os.environ.get(BK_ENV):
        if bk not in bp.KC_VALUES:
            raise ValueError(f"{BK_ENV}={bk}: the card's kernels take a "
                             f"k-chunk in {bp.KC_VALUES}")
        return bk
    return bk if _tile_key(k_pad, _pad_to(p, 8), _pad_to(n, 128),
                           M.dtype) in _KC_MEASURED else None


# ---------------------------------------------------------------------------
# Engine choice: "unfused" is a candidate too
# ---------------------------------------------------------------------------
#
# The reference measured its Cimmino kernel pair LOSING to the plain XLA
# step at batch 1 on the TPU (0.88x, BENCH_PR5.json: the single-RHS row
# projection has no A/B-tile reuse to amortize).  ``use_fused`` makes the
# unfused step a candidate per (family, p, n, k, dtype); the projection
# family's dispatch asks it and falls back, bit-exactly, to the unfused
# step where it says so.  ``REPRO_KERNEL_ENGINE=fused|unfused`` pins it
# (benchmarks and chip_smoke.py pin "fused" to time the kernels); where
# nothing is measured the verdict is the reference's heuristic.

ENGINE_ENV = "REPRO_KERNEL_ENGINE"
# the *_sparse families measure the compressed-support kernels against
# the unfused SparseBlocks step; their keys carry the support width w
ENGINE_FAMILIES = ("apc", "cimmino", "apc_sparse", "cimmino_sparse")
# (family, p_pad, n_pad, k_pad, dtype name) -> bool (True: fused);
# sparse: (family, p_pad, n_pad, k_pad, w, dtype name)
_ENGINE_CACHE: dict = {}
# the dummy worker axis of the engine measurement
_MEAS_WORKERS = 2
# a fused "win" inside this margin is noise: the dispatched step wraps
# the pair in glue (the fused residual's harvest, the state's
# bookkeeping) that burdens it more than the unfused step
_ENGINE_MARGIN = 0.85
#: the last verdict measured for each key: (fused s, unfused s)
engine_times: dict = {}


def engine_cache_clear() -> None:
    """Drop every cached engine choice (tests / re-tuning)."""
    with _tune_lock:
        _ENGINE_CACHE.clear()


def engine_cache() -> dict:
    """The live engine-choice cache (read-only use)."""
    return dict(_ENGINE_CACHE)


def _measure_engine(family: str, p_pad: int, n_pad: int, k_pad: int,
                    dtype, device: torch.device, w: Optional[int] = None,
                    compute_dtype=None) -> tuple[float, float]:
    """(fused s, unfused s): the fused kernel pair against the port's
    unfused step, its per-step Cholesky solve included, at the SAME
    padded (p, n, k) shape over a dummy worker axis of
    ``_MEAS_WORKERS``, each the best of 5 after a warm-up, on dummy
    operands: A (vals) in ``dtype``, the rest in ``compute_dtype``.  The
    sparse families run on a random support of w sorted distinct columns
    per worker."""
    from repro_torch.core import apc as apc_core
    from repro_torch.core import blockops
    record(f"measure engine {family}", f"p={p_pad} n={n_pad} k={k_pad}"
           + (f" w={w}" if w is not None else "") + f" {_dtype_name(dtype)}")
    _no_capture("the engine verdict", device)
    cdt = _compute(dtype, compute_dtype)
    mw = _MEAS_WORKERS
    gen = torch.Generator(device=device).manual_seed(0)
    rows = () if k_pad == 1 else (k_pad,)
    if family.endswith("_sparse"):
        cols = torch.stack([torch.sort(torch.randperm(
            n_pad, generator=gen, device=device)[:w]).values
            for _ in range(mw)])                              # (mw, w)
        A = blockops.SparseBlocks(
            vals=_randn(gen, device, cdt, mw, p_pad, w), cols=cols,
            span=torch.zeros(n_pad, dtype=cdt, device=device))
        V = A.vals
    else:
        A = V = _randn(gen, device, cdt, mw, p_pad, n_pad)
    G = V @ V.transpose(-1, -2) + 1e-3 * torch.eye(p_pad, dtype=cdt,
                                                   device=device)
    L = torch.linalg.cholesky(G)
    Bm = torch.cholesky_solve(V, L).transpose(-1, -2).contiguous().to(dtype)
    Vs = V.to(dtype)
    Astore = A._replace(vals=Vs) if family.endswith("_sparse") else Vs
    X = _randn(gen, device, cdt, *rows, mw, n_pad)            # ([k,] m, n)
    Xb = _randn(gen, device, cdt, *rows, n_pad)
    b = _randn(gen, device, cdt, *rows, mw, p_pad)
    # the kernels take the worker axis first: (m, [k,] .) views
    Xw, bw = (X, b) if k_pad == 1 else (X.transpose(0, 1),
                                        b.transpose(0, 1))
    state = apc_core.APCState(x=X, xbar=Xb, t=0)
    if family == "apc":
        fused = lambda: block_projection(Vs, Bm, Xw, Xb, 1.0)  # noqa: E731
    elif family == "cimmino":
        fused = lambda: cimmino_update(Vs, Bm, bw, Xb)  # noqa: E731
    elif family == "apc_sparse":
        fused = lambda: sparse_proj_update(  # noqa: E731
            Vs, A.cols, Bm, Xw, Xb, 1.0)
    else:
        fused = lambda: sparse_cimmino_update(  # noqa: E731
            Vs, A.cols, Bm, bw, Xb)
    if family.startswith("apc"):
        unfused = lambda: apc_core.worker_update(  # noqa: E731
            Astore, L, state, 1.0)
    else:
        def unfused():
            v = b - blockops.bmatvec(Astore, Xb)
            return blockops.brmatvec(Astore, apc_core._gram_solve(L, v))
    with bp.captured_launches():           # no launch of the path
        times = (_best_s(fused, 5, device), _best_s(unfused, 5, device))
    log.debug("engine %s (p=%d, n=%d, k=%d, %s): fused %.1fus unfused "
              "%.1fus", family, p_pad, n_pad, k_pad, _dtype_name(dtype),
              times[0] * 1e6, times[1] * 1e6)
    return times


def engine_key(family: str, p: int, n: int, k: int = 1,
               dtype=torch.float32, *, w: Optional[int] = None) -> tuple:
    """The cache key of a verdict, the reference's: (family, p padded to
    8, n to 128, k to 1 or a multiple of 8, [w,] dtype name)."""
    key = (family, _pad_to(p, 8), _pad_to(n, 128), _k_pad(k))
    return key + ((int(w),) if w is not None else ()) + (_dtype_name(dtype),)


def use_fused(family: str, p: int, n: int, k: int = 1,
              dtype=torch.float32, *, w: Optional[int] = None,
              device=None, compute_dtype=None) -> bool:
    """Should this (family, p, n, k, dtype) shape run the fused kernels?

    The reference's order: ``REPRO_KERNEL_ENGINE`` pin (never cached) >
    cache > measured verdict (:func:`_measure_engine`, where
    :func:`_autotune_enabled` on ``device``: the card by default; fused
    wins only within ``_ENGINE_MARGIN`` of the unfused step's time) > the
    heuristic, fused everywhere except Cimmino below a full batch of 8.
    ``dtype`` is the stored matrix's (bfloat16 under mixed precision, as
    the reference asks), keyed as the reference keys it; a measurement
    runs its operands in ``compute_dtype``.  The ``*_sparse`` families
    require ``w``, the support width, and key on it beside the global n.
    """
    if family not in ENGINE_FAMILIES:
        raise ValueError(f"unknown kernel family {family!r}; "
                         f"expected one of {ENGINE_FAMILIES}")
    sparse = family.endswith("_sparse")
    if sparse and w is None:
        raise ValueError(f"family {family!r} requires the support width w")
    env = os.environ.get(ENGINE_ENV)
    if env:
        choice = env.strip().lower()
        if choice not in ("fused", "unfused"):
            raise ValueError(f"{ENGINE_ENV}={env!r}: expected 'fused' or "
                             "'unfused'")
        return choice == "fused"
    key = engine_key(family, p, n, k, dtype, w=w if sparse else None)
    _, p_pad, n_pad, k_pad = key[:4]
    hit = _ENGINE_CACHE.get(key)
    if hit is not None:
        return hit
    with _tune_lock:
        hit = _ENGINE_CACHE.get(key)
        if hit is None:
            device = _device(device)
            if _autotune_enabled(device.type == "cuda"):
                times = engine_times[key] = _measure_engine(
                    family, p_pad, n_pad, k_pad, dtype, device,
                    w=int(w) if sparse else None,
                    compute_dtype=compute_dtype)
                hit = times[0] <= _ENGINE_MARGIN * times[1]
            else:
                # the reference's measured trend: fused wins wherever the
                # batch fills the 8-row tile or APC's pinv step saves the
                # per-step Gram solves; the lone loser is the sub-batch
                # Cimmino row projection (dense or sparse)
                hit = not (family.startswith("cimmino") and k_pad < 8)
            _ENGINE_CACHE[key] = hit
    return hit
