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
where ``torch.einsum`` refuses mixed dtypes.  Tile choice and the
measured fused-vs-unfused engine of the reference (``pick_tiles``/
``use_fused``) are ROADMAP A11.
"""
from __future__ import annotations

import torch

from . import block_projection as bp
from .block_projection import launch_counts, reset_launch_counts  # noqa: F401


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernels' reference)
# ---------------------------------------------------------------------------


def apc_gather_ref(A, X, Xbar):
    """U = A_w (X̄ − X_w) per worker: A (m, p, n); X (m, n) or (m, k, n);
    X̄ (n,) or (k, n) -> U (m, p) or (m, k, p)."""
    return torch.einsum("mpn,m...n->m...p", A.to(X.dtype), Xbar - X)


def apc_scatter_ref(B, X, Xbar, U, gamma):
    """Y = X_w + γ((X̄ − X_w) − B_w U_w) per worker: B (m, n, p)."""
    d = Xbar - X
    return X + gamma * (d - torch.einsum("mnp,m...p->m...n", B.to(U.dtype),
                                         U))


def block_projection_ref(A, B, X, Xbar, gamma):
    """The full worker update Y = X + γ P (X̄ − X) with P = I − B A."""
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


def _on_cuda(op: str, matrices: tuple, *operands: torch.Tensor) -> bool:
    """:func:`on_cuda` of every tensor; raises, besides, on dtypes the
    kernels do not take: the ``matrices`` in one dtype and the
    ``operands`` in one, a pair of ``block_projection.PAIRS``."""
    cuda = on_cuda(op, *matrices, *operands)
    mats = {t.dtype for t in matrices}
    dtypes = {t.dtype for t in operands}
    if (len(mats) != 1 or len(dtypes) != 1
            or (*mats, *dtypes) not in bp.PAIRS):
        raise TypeError(
            f"{op}: dtypes {sorted(map(str, mats))} (matrices) with "
            f"{sorted(map(str, dtypes))} (operands); expected one of "
            + ", ".join(f"{a}/{b}" for a, b in bp.PAIRS))
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


def proj_gather(A, X, Xbar):
    """u_w = A_w (x̄ − x_w) for every worker -> (m, p) or (m, k, p)."""
    if not _on_cuda("proj_gather", (A,), X, Xbar):
        return apc_gather_ref(A, X, Xbar)
    X3, Xb2, squeeze = _rows(X, Xbar)
    U = bp.apc_gather(A, X3, Xb2)
    return U.squeeze(1) if squeeze else U


def proj_scatter(B, X, Xbar, U, gamma: float):
    """y_w = x_w + γ((x̄ − x_w) − B_w u_w) for every worker, in X's shape."""
    if not _on_cuda("proj_scatter", (B,), X, Xbar, U):
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
    if not _on_cuda("cimmino_gather", (A,), Xbar):
        return cimmino_gather_ref(A, Xbar)
    U = bp.cimmino_gather(A, Xbar.unsqueeze(0) if Xbar.dim() == 1 else Xbar)
    return U.squeeze(1) if Xbar.dim() == 1 else U


def cimmino_scatter(B, V):
    """r_w = B_w v_w for every worker -> (m, n) or (m, k, n).  V may be the
    (m, k, p) transposed view of a (k, m, p) batch (no copy)."""
    if not _on_cuda("cimmino_scatter", (B,), V):
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


def sparse_proj_update(vals, cols, Bvals, X, Xbar, gamma: float):
    """The sparse APC/consensus worker update for every worker -> (Y, U),
    Y in X's shape, U (m, [k,] p) = vals_w (X̄ − X_w)[cols_w], the fused
    residual source.  On CUDA: one ``sparse_gather`` launch (the support
    gather happens in its staged loads), the AXPY pre-pass
    Y = X + γ(X̄ − X) for the off-support columns, and one
    ``sparse_scatter`` launch that stores the support columns of Y."""
    if not _on_cuda("sparse_proj_update", (vals, Bvals), X, Xbar):
        _index_on(cols, vals)
        return sparse_proj_update_ref(vals, cols, Bvals, X, Xbar, gamma)
    X3, Xb2, squeeze = _rows(X, Xbar)
    U = bp.sparse_gather(vals, cols, X3, Xb2)
    Y = X3 + gamma * (Xb2 - X3)
    bp.sparse_scatter(Bvals, cols, U, Y, X=X3, Xbar=Xb2, gamma=gamma)
    return (Y.squeeze(1), U.squeeze(1)) if squeeze else (Y, U)


def sparse_cimmino_update(vals, cols, Bvals, b, Xbar):
    """The sparse block-Cimmino row projection for every worker -> (R, U):
    R (m, [k,] n) = Bvals_w (b_w − U_w) at cols_w and zero elsewhere,
    U = vals_w X̄[cols_w] (the residual block is U − b).  On CUDA: one
    ``sparse_cimmino_gather`` and one ``sparse_scatter`` launch; the
    worker sum of R stays outside, as in the reference."""
    if not _on_cuda("sparse_cimmino_update", (vals, Bvals), b, Xbar):
        _index_on(cols, vals)
        return sparse_cimmino_update_ref(vals, cols, Bvals, b, Xbar)
    squeeze = Xbar.dim() == 1
    U = bp.sparse_cimmino_gather(vals, cols,
                                 Xbar.unsqueeze(0) if squeeze else Xbar)
    V = cimmino_residual(b.unsqueeze(1) if squeeze else b, U)
    m, k, _ = U.shape
    R = U.new_zeros((m, k, Xbar.shape[-1]))
    bp.sparse_scatter(Bvals, cols, V, R)
    return (R.squeeze(1), U.squeeze(1)) if squeeze else (R, U)
