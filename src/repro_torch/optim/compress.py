"""Gradient compression for the data-parallel all-reduce: block-wise
int8 with per-block scales and error feedback (the port's counterpart of
``repro.optim.compress``).

The quantization residual is carried to the next step (EF-SGD), which
keeps SGD and Adam unbiased to first order.  Here the roundtrip is
simulated locally, so the optimizer sees exactly what a compressed
all-reduce would deliver:

    err = compress.init_error(params)
    grads, err = compress.compress_decompress(grads, err)   # per step

``torch.round`` rounds half to even, as ``jnp.round`` does.

On a mesh (DTensor gradients, ``launch/train.py`` sharded) the error
buffers are laid out as the parameters: DTensors of their placements,
each rank holding its shard.  Each leaf is quantized on its global value,
in the same 256-element blocks as on one device (the reference quantizes
its global leaves under the mesh): the gradient and the buffer are
gathered whole on every rank, and the dequantized gradient and the new
buffer are cut back to the buffer's placements.  The buffers are not
checkpointed, as the reference's are not.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.sharding import (is_dtensor, local_part, tree_leaves,
                                        tree_map, tree_unflatten)

BLOCK = 256


class QGrad(NamedTuple):
    q: torch.Tensor        # int8 payload, (n_blocks, BLOCK)
    scale: torch.Tensor    # float32 per-block scale, (n_blocks, 1)
    n: int                 # original element count


def quantize(g: torch.Tensor) -> QGrad:
    """Symmetric per-block int8 quantization of a flat gradient."""
    flat = g.float().reshape(-1)
    n = flat.shape[0]
    flat = F.pad(flat, (0, (-n) % BLOCK)).reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(flat), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-30)
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return QGrad(q=q, scale=scale, n=n)


def dequantize(qg: QGrad, shape, dtype) -> torch.Tensor:
    flat = (qg.q.float() * qg.scale).reshape(-1)[:qg.n]
    return flat.reshape(shape).to(dtype)


def init_error(params):
    """Error-feedback buffers (float32, mirroring the parameter tree; a
    DTensor parameter's in its placements)."""
    def zeros(p):
        if is_dtensor(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return tree_map(zeros, params)


@torch.no_grad()
def compress_decompress(grads, error) -> Tuple[dict, dict]:
    """Per-leaf quantize -> dequantize with error feedback.  Returns
    (the decompressed grads in their dtypes, the new error buffers)."""
    def one(g, e):
        if is_dtensor(e):
            whole = one(g.full_tensor(), e.full_tensor())
            return tuple(local_part(t, e.device_mesh, e.placements)
                         for t in whole)
        corrected = g.float() + e
        deq = dequantize(quantize(corrected), g.shape, torch.float32)
        return deq.to(g.dtype), corrected - deq

    out = [one(g, e) for g, e in zip(tree_leaves(grads),
                                     tree_leaves(error))]
    deq, err = (tree_unflatten(grads, leaves) for leaves in zip(*out))
    return deq, err


def wire_bytes(params) -> Tuple[int, int]:
    """(uncompressed float32, compressed) all-reduce payload bytes."""
    n = sum(t.numel() for t in tree_leaves(params))
    return 4 * n, n + (n + BLOCK - 1) // BLOCK * 4
