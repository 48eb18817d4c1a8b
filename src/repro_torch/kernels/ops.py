"""The projection ops of the kernel path, with a worker axis.

Counterpart of ``repro.kernels.ops`` (``proj_gather``, ``proj_scatter``,
``block_projection``; ``cimmino_gather``, ``cimmino_scatter``,
``cimmino_update``) and of ``repro.kernels.ref`` (their plain versions).
Each op takes every worker at once — A (m, p, n), B (m, n, p), X (m, k, n)
or (m, n), right-hand sides b/V (m, k, p) or (m, p), and X̄ (k, n) or (n,)
shared by all workers (the reference's worker-vmapped ops with ``xbar``
unbatched) — and each call is ONE launch of each kernel for all m
workers.

Dispatch is on the tensors' device, and only there: CUDA tensors launch
the hand-written kernels (``block_projection``), CPU tensors take the
plain PyTorch versions below, anything else raises.  Nothing falls back
from one to the other.  Tile choice and the measured fused-vs-unfused
engine of the reference (``pick_tiles``/``use_fused``) are ROADMAP A11.
"""
from __future__ import annotations

import torch

from . import block_projection as bp
from .block_projection import launch_counts, reset_launch_counts  # noqa: F401

_DTYPES = (torch.float32, torch.float64)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernels' reference)
# ---------------------------------------------------------------------------


def apc_gather_ref(A, X, Xbar):
    """U = A_w (X̄ − X_w) per worker: A (m, p, n); X (m, n) or (m, k, n);
    X̄ (n,) or (k, n) -> U (m, p) or (m, k, p)."""
    return torch.einsum("mpn,m...n->m...p", A, Xbar - X)


def apc_scatter_ref(B, X, Xbar, U, gamma):
    """Y = X_w + γ((X̄ − X_w) − B_w U_w) per worker: B (m, n, p)."""
    d = Xbar - X
    return X + gamma * (d - torch.einsum("mnp,m...p->m...n", B, U))


def block_projection_ref(A, B, X, Xbar, gamma):
    """The full worker update Y = X + γ P (X̄ − X) with P = I − B A."""
    return apc_scatter_ref(B, X, Xbar, apc_gather_ref(A, X, Xbar), gamma)


def cimmino_gather_ref(A, Xbar):
    """U = A_w X̄ per worker: A (m, p, n); X̄ (n,) or (k, n) -> U (m, p) or
    (m, k, p)."""
    return torch.einsum("mpn,...n->m...p", A, Xbar)


def cimmino_scatter_ref(B, V):
    """R = B_w V_w per worker: B (m, n, p); V (m, p) or (m, k, p)."""
    return torch.einsum("mnp,m...p->m...n", B, V)


def cimmino_update_ref(A, B, b, Xbar):
    """The full row projection R = B_w (b_w − A_w X̄) per worker."""
    return cimmino_scatter_ref(B, b - cimmino_gather_ref(A, Xbar))


# ---------------------------------------------------------------------------
# The ops
# ---------------------------------------------------------------------------


def _on_cuda(op: str, *tensors: torch.Tensor) -> bool:
    """True for all-CUDA operands, False for all-CPU ones; raises on
    mixed or other devices and on dtypes the kernels do not take."""
    kinds = {t.device.type for t in tensors}
    if kinds not in ({"cuda"}, {"cpu"}):
        raise ValueError(f"{op}: operands on {sorted(kinds)}; expected all "
                         f"on CUDA (kernel) or all on the CPU (plain "
                         f"version)")
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or not dtypes <= set(_DTYPES):
        raise TypeError(f"{op}: dtypes {sorted(map(str, dtypes))}; expected "
                        f"one of float32/float64 for every operand")
    return kinds == {"cuda"}


def _rows(X, Xbar):
    """The kernels' (m, k, n) / (k, n) views of a single-RHS (m, n) / (n,)
    pair (no copies); ``squeeze`` says whether to drop k again."""
    if X.dim() == 2:
        return X.unsqueeze(1), Xbar.unsqueeze(0), True
    return X, Xbar, False


def proj_gather(A, X, Xbar):
    """u_w = A_w (x̄ − x_w) for every worker -> (m, p) or (m, k, p)."""
    if not _on_cuda("proj_gather", A, X, Xbar):
        return apc_gather_ref(A, X, Xbar)
    X3, Xb2, squeeze = _rows(X, Xbar)
    U = bp.apc_gather(A, X3, Xb2)
    return U.squeeze(1) if squeeze else U


def proj_scatter(B, X, Xbar, U, gamma: float):
    """y_w = x_w + γ((x̄ − x_w) − B_w u_w) for every worker, in X's shape."""
    if not _on_cuda("proj_scatter", B, X, Xbar, U):
        return apc_scatter_ref(B, X, Xbar, U, gamma)
    X3, Xb2, squeeze = _rows(X, Xbar)
    Y = bp.apc_scatter(B, X3, Xb2, U.unsqueeze(1) if squeeze else U, gamma)
    return Y.squeeze(1) if squeeze else Y


def block_projection(A, B, X, Xbar, gamma: float):
    """y = x + γ(d − B(A d)), d = x̄ − x, for every worker: one gather and
    one scatter launch for all m workers (and all k batch rows)."""
    return proj_scatter(B, X, Xbar, proj_gather(A, X, Xbar), gamma)


def cimmino_gather(A, Xbar):
    """u_w = A_w x̄ for every worker -> (m, p) or (m, k, p)."""
    if not _on_cuda("cimmino_gather", A, Xbar):
        return cimmino_gather_ref(A, Xbar)
    U = bp.cimmino_gather(A, Xbar.unsqueeze(0) if Xbar.dim() == 1 else Xbar)
    return U.squeeze(1) if Xbar.dim() == 1 else U


def cimmino_scatter(B, V):
    """r_w = B_w v_w for every worker -> (m, n) or (m, k, n).  V may be the
    (m, k, p) transposed view of a (k, m, p) batch (no copy)."""
    if not _on_cuda("cimmino_scatter", B, V):
        return cimmino_scatter_ref(B, V)
    R = bp.cimmino_scatter(B, V.unsqueeze(1) if V.dim() == 2 else V)
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
