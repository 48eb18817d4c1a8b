"""LM serving entry point: batched prefill + greedy decode loop over a slot
batch (the port's counterpart of ``repro.launch.serve``).

Requests (seeded random prompts) are packed into a fixed slot batch by
``take_group`` (the linear-system server's queue rule: FIFO, the last
request repeated to fill the batch, padding never counted as traffic).
Each batch is prefilled into a fresh cache of ``prompt_len + max_new``
positions, then decoded greedily, the argmax taken over the real
vocabulary (``[:vocab_size]`` of the padded logits).  Parameters are drawn
from a seed (``sharding.init_tree``); a full config runs in its own dtype
(bfloat16).  Runs on the card unless ``--device cpu``.  Every family
serves (dense, vlm, moe, ssm, hybrid, and Whisper's encoder-decoder on
zero frames, as the reference's CLI feeds it); ``serve`` is the same loop
for a config object and its parameters, such as a depth cut of a
published config.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --smoke --requests 6 --batch 2 --prompt-len 16 --max-new 8
"""
from __future__ import annotations

import argparse
import time
from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import configs
from repro_torch import device as dev
from repro_torch.models import model, sharding
# the queue semantics are shared with the linear-system request server
from repro_torch.solvers.serve import take_group  # noqa: F401


def make_decode(cfg, rules=None):
    """The greedy decode step, built once per serving run (the reference
    jits it here, outside the per-batch loop, so that one compiled step
    serves every batch).  ``cache_len`` is a Python int."""
    def decode(params, token, cache, cache_len: int):
        return model.decode_step(cfg, params, token, cache, cache_len,
                                 rules=rules)
    return decode


@torch.inference_mode()
def generate_batch(cfg, params, prompts: torch.Tensor, max_new: int,
                   rules=None, extra=None, decode=None) -> torch.Tensor:
    """Greedy-decode a batch of same-length prompts (B, S) on their
    device.  Returns the (B, max_new) new tokens.

    Pass ``decode`` (from ``make_decode``) to reuse one decode step across
    batches.
    """
    B, S = prompts.shape
    cache = model.init_cache(cfg, B, S + max_new, model.cache_dtype(cfg),
                             device=prompts.device)
    batch = {"tokens": prompts}
    if extra:
        batch.update(extra)
    logits, cache = model.prefill(cfg, params, batch, cache, rules=rules)
    out = []
    tok = torch.argmax(logits[:, -1:, :cfg.vocab_size], dim=-1)
    if decode is None:
        decode = make_decode(cfg, rules)
    for i in range(max_new):
        out.append(tok)
        logits, cache = decode(params, tok, cache, S + i)
        tok = torch.argmax(logits[:, :, :cfg.vocab_size], dim=-1)
    return torch.cat(out, dim=1)


class ServeReport(NamedTuple):
    """What a serving run did: each batch's tokens (host arrays), the
    requests served (padding excluded), the seconds of the loop, and the
    new tokens a second."""
    tokens: list
    served: int
    seconds: float
    tok_per_s: float


def serve(cfg, params, *, requests: int, batch: int, prompt_len: int,
          max_new: int, device) -> ServeReport:
    """Serve ``requests`` random prompts (seed 0) in slot batches of
    ``batch`` on ``params`` (the CLI's loop, for a config object: a depth
    cut of a published config, say), printing the reference's lines."""
    rules = sharding.Rules()
    rng = np.random.default_rng(0)
    queue = deque(rng.integers(0, cfg.vocab_size, size=prompt_len)
                  for _ in range(requests))
    extra = {}
    if cfg.frontend == "vision":
        extra["patches"] = torch.zeros(
            (batch, cfg.num_patches, cfg.d_model),
            dtype=model.cache_dtype(cfg), device=device)
    if cfg.frontend == "audio":
        extra["frames"] = torch.zeros(
            (batch, cfg.encoder_seq, cfg.d_model),
            dtype=model.cache_dtype(cfg), device=device)

    done, tokens, t0 = 0, [], time.time()
    decode = make_decode(cfg, rules)        # ONE decode step for all batches
    while queue:
        group, n_real = take_group(queue, batch)
        prompts = torch.as_tensor(np.stack(group), dtype=torch.int64,
                                  device=device)
        toks = generate_batch(cfg, params, prompts, max_new, rules,
                              extra, decode=decode).cpu().numpy()
        tokens.append(toks)
        done += n_real                      # padding is not traffic
        print(f"batch of {n_real} (+{len(group) - n_real} pad): "
              f"generated {toks.shape[1]} tokens each; "
              f"sample: {toks[0][:8]}", flush=True)
    dt = time.time() - t0
    rate = done * max_new / dt
    print(f"served {done} requests in {dt:.1f}s ({rate:.1f} tok/s)")
    return ServeReport(tokens, done, dt, rate)


def run(argv=None) -> ServeReport:
    """Parse the CLI's arguments, draw the parameters from seed 0, serve,
    print the reference's lines and return the report."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    device = dev.resolve(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    gen = torch.Generator(device=device).manual_seed(0)
    params = sharding.init_tree(model.model_abstract(cfg), gen,
                                model.cache_dtype(cfg), device)
    return serve(cfg, params, requests=args.requests, batch=args.batch,
                 prompt_len=args.prompt_len, max_new=args.max_new,
                 device=device)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
