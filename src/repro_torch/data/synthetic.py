"""Deterministic synthetic LM data (the port's counterpart of
``repro.data.synthetic``).

Batches are a pure function of (seed, step), so a run resumes from its
step counter alone; each data-parallel host draws the global batch and
keeps its slice; labels are the next tokens.  Sequences are
Zipf-distributed token streams with injected n-gram copies, so that the
loss falls in the example runs.  The draws are the reference's own
(``np.random.default_rng((seed, step))``, the same calls in the same
order): the port's int64 tokens equal the reference's int32 ones.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch import device as dev


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    zipf_a: float = 1.2
    ngram: int = 3          # repeat period injecting learnable structure
    seed: int = 1234


def make_batch(cfg: DataConfig, step: int, *, host_id: int = 0,
               num_hosts: int = 1, device=None) -> dict:
    """The batch of ``step``: host ``host_id``'s slice of the global
    batch, {"tokens", "labels"} (B, seq_len) int64 on ``device``
    (resolved: ``cuda`` unless asked otherwise), labels shifted by one."""
    if cfg.global_batch % num_hosts:
        raise ValueError(f"global batch {cfg.global_batch} does not split "
                         f"over {num_hosts} hosts")
    device = dev.resolve(device)
    per_host = cfg.global_batch // num_hosts
    rng = np.random.default_rng((cfg.seed, step))
    z = rng.zipf(cfg.zipf_a, size=(cfg.global_batch, cfg.seq_len + 1))
    toks = np.minimum(z - 1, cfg.vocab_size - 1).astype(np.int64)
    # every position j >= ngram copies j - ngram with probability 1/2
    mask = rng.random((cfg.global_batch, cfg.seq_len + 1)) < 0.5
    toks[:, cfg.ngram:] = np.where(mask[:, cfg.ngram:],
                                   toks[:, :-cfg.ngram], toks[:, cfg.ngram:])
    rows = toks[host_id * per_host:(host_id + 1) * per_host]
    return {"tokens": torch.as_tensor(np.ascontiguousarray(rows[:, :-1]),
                                      device=device),
            "labels": torch.as_tensor(np.ascontiguousarray(rows[:, 1:]),
                                      device=device)}


def batches(cfg: DataConfig, start_step: int = 0, **kw) -> Iterator[dict]:
    step = start_step
    while True:
        yield make_batch(cfg, step, **kw)
        step += 1
