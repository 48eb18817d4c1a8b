"""Training driver: config -> data -> train loop with checkpointing (the
port's counterpart of ``repro.launch.train``).

Parameters are drawn from seed 0 (``sharding.init_tree`` with a
``torch.Generator``) in the config's dtype; each step takes the seeded
synthetic batch of its step number (zero ``patches`` or ``frames`` for
the vision and audio families, as the reference's driver feeds them),
the loss and its gradients by autograd (each decoder period recomputed in
the backward), optionally the int8 error-feedback roundtrip of the
gradients, and one AdamW update scaled by the warm-up-cosine schedule.
Checkpoints hold (params, opt_state), atomically, every ``--ckpt-every``
steps; a run on a directory that holds one resumes from its step (the
data are a pure function of the step).  The loop is eager.  Runs on the
card unless ``--device cpu``.

A mesh (``--data`` or ``--model-axis`` above 1) trains sharded: the
``("data", "model")`` mesh of ``mesh.make_host_mesh`` over the ranks of
the default group, the logical-axis rules of ``sharding.rules_for_mesh``,
the parameters and the optimizer state placed as DTensors by
``sharding.shard_tree``, and each batch split over ``batch``.  The loop
is otherwise the same.  Checkpoints hold the full (global) leaves, as the
reference's do, written by rank 0: a sharded run resumes on one device
and a one-device run resumes sharded.  ``--compress-grads`` quantizes
each gradient leaf's global value in blocks, on a mesh too, its error
buffers laid out as the parameters (``optim/compress.py``).  Under
``torchrun`` the group is NCCL, one rank a card (``mesh.init_group``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --smoke --steps 20 --batch 8 --seq 128 --ckpt-dir build/ckpt
    torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch tinyllama-1.1b --smoke --steps 20 --model-axis 2
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import torch

from repro_torch import configs
from repro_torch import device as dev
from repro_torch.checkpoint import ckpt
from repro_torch.data import synthetic
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model, sharding
from repro_torch.optim import adamw, compress, schedule



class TrainReport(NamedTuple):
    """What a training run did: the loss of each step it ran (from
    ``start_step`` on), the loop's seconds (ending in a synchronize), the
    first step's seconds (synchronized) and the checkpoints' seconds
    within them."""
    losses: list
    start_step: int
    seconds: float
    first_step_seconds: float
    ckpt_seconds: float


def init_params(cfg, device, seed: int = 0):
    """The config's parameters drawn from ``seed`` in its dtype on
    ``device``, every leaf requiring grad (set after ``init_tree``'s
    in-place scaling)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = sharding.init_tree(model.model_abstract(cfg), gen,
                                model.cache_dtype(cfg), device)
    for t in sharding.tree_leaves(params):
        t.requires_grad_()
    return params


def full_batch(cfg, batch: dict) -> dict:
    """``batch`` with the zero patches (vision) or frames (audio) the
    reference's driver adds, in the config's dtype."""
    tokens = batch["tokens"]
    out = dict(batch)
    dt = model.cache_dtype(cfg)
    if cfg.frontend == "vision":
        out["patches"] = torch.zeros(
            (tokens.shape[0], cfg.num_patches, cfg.d_model), dtype=dt,
            device=tokens.device)
    if cfg.frontend == "audio":
        out["frames"] = torch.zeros(
            (tokens.shape[0], cfg.encoder_seq, cfg.d_model), dtype=dt,
            device=tokens.device)
    return out


def loss_and_grads(cfg, params, batch: dict, rules=None):
    """(the loss, detached; its gradient tree) on ``batch`` as given; on
    a mesh (``rules``) the loss is whole on every rank and each gradient
    is in its parameter's placements."""
    with sharding.on_mesh(rules):
        loss = model.loss_fn(cfg, params, batch, rules=rules)
        leaves = sharding.tree_leaves(params)
        grads = torch.autograd.grad(loss, leaves)
        if sharding.is_dtensor(loss):
            loss = loss.full_tensor()
            grads = [adamw.placed(g, p) for g, p in zip(grads, leaves)]
    return loss.detach(), sharding.tree_unflatten(params, list(grads))


def train_step(cfg, acfg: adamw.AdamWConfig, params, opt_state, batch,
               lr_scale, err=None, rules=None):
    """One step on ``batch`` (as given).  Returns (params, opt_state,
    loss, err), ``err`` the error-feedback buffers (None: no
    compression)."""
    loss, grads = loss_and_grads(cfg, params, batch, rules)
    if err is not None:
        grads, err = compress.compress_decompress(grads, err)
    params, opt_state = adamw.update(acfg, grads, opt_state, params,
                                     lr_scale=lr_scale)
    return params, opt_state, loss, err


def place_batch(batch: dict, rules) -> dict:
    """Every leaf of a batch (made whole, alike, on every rank) split
    over ``batch`` on the rules' mesh, each rank keeping its own rows."""
    def place(t):
        spec = sharding.to_pspec(("batch",) + (None,) * (t.dim() - 1), rules)
        return sharding.local_part(t, rules.mesh,
                                   sharding.placements(spec, rules.mesh))
    return {k: place(t) for k, t in batch.items()}


def place_state(cfg, params, opt_state, rules):
    """The parameters and the optimizer state (full leaves) as DTensors
    on the rules' mesh, placed by the parameters' logical axes."""
    ab = model.model_abstract(cfg)
    params = sharding.shard_tree(params, ab, rules, rules.mesh)
    opt_state = opt_state._replace(
        m=sharding.shard_tree(opt_state.m, ab, rules, rules.mesh),
        v=sharding.shard_tree(opt_state.v, ab, rules, rules.mesh))
    return params, opt_state


def save_full(ckpt_dir: str, step: int, params, opt_state) -> str:
    """Checkpoint ``step`` with the full leaves, written by rank 0 (every
    rank of a mesh gathers them; the others wait for the write)."""
    import torch.distributed as dist
    full = (sharding.full_tree(params),
            opt_state._replace(m=sharding.full_tree(opt_state.m),
                               v=sharding.full_tree(opt_state.v)))
    path = None
    if not dist.is_initialized() or dist.get_rank() == 0:
        path = ckpt.save(ckpt_dir, step, full)
    if dist.is_initialized():
        box = [path]
        dist.broadcast_object_list(box, src=0)
        path = box[0]
    return path


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def loop(cfg, *, steps: int, batch: int, seq: int, device, lr: float = 1e-3,
         ckpt_dir=None, ckpt_every: int = 20, log_every: int = 5,
         compress_grads: bool = False, rules=None) -> TrainReport:
    """The CLI's loop for a config object (a depth cut of a published
    config, say): parameters from seed 0, resumed from ``ckpt_dir``'s
    latest checkpoint where it has one, then steps up to ``steps``,
    printing the reference's lines.  ``rules`` with a mesh: sharded
    (module docstring)."""
    acfg = adamw.AdamWConfig(lr=lr)
    params = init_params(cfg, device)
    opt_state = adamw.init(params)
    dcfg = synthetic.DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                global_batch=batch)

    start_step = 0
    if ckpt_dir:
        last = ckpt.latest_step(ckpt_dir)
        if last is not None:
            params, opt_state = ckpt.restore(ckpt_dir, (params, opt_state),
                                             step=last)
            for t in sharding.tree_leaves(params):
                t.requires_grad_()
            start_step = last
            print(f"resumed from step {last}")
    if rules is not None and rules.mesh is not None:
        params, opt_state = place_state(cfg, params, opt_state, rules)
    err = compress.init_error(params) if compress_grads else None

    losses, first, saving = [], 0.0, 0.0
    t0 = time.time()
    for step in range(start_step, steps):
        b = full_batch(cfg, synthetic.make_batch(dcfg, step, device=device))
        if rules is not None and rules.mesh is not None:
            b = place_batch(b, rules)
        lr_s = schedule.linear_warmup_cosine(
            step, warmup=max(steps // 10, 1), total=steps)
        params, opt_state, loss, err = train_step(
            cfg, acfg, params, opt_state, b, lr_s, err, rules)
        losses.append(loss)
        if step == start_step:
            _sync(device)
            first = time.time() - t0
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:5d}  loss {float(loss):.4f}  "
                  f"({time.time() - t0:.1f}s)", flush=True)
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            t = time.time()
            path = save_full(ckpt_dir, step + 1, params, opt_state)
            saving += time.time() - t
            print(f"checkpoint -> {path}", flush=True)
    _sync(device)
    seconds = time.time() - t0
    losses = torch.stack(losses).tolist() if losses else []
    return TrainReport(losses, start_step, seconds, first, saving)


def run(argv=None) -> TrainReport:
    """Parse the CLI's arguments, train, print the reference's lines and
    return the report."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--data", type=int, default=1, help="data mesh axis")
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 + error-feedback gradient compression "
                         "(simulated roundtrip of the DP all-reduce payload)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    device = dev.resolve(args.device)
    rules = None
    if args.data * args.model_axis > 1:
        mesh = mesh_lib.make_host_mesh(args.data, args.model_axis, device)
        device = mesh_lib.mesh_device(mesh)
        rules = sharding.rules_for_mesh(mesh)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    return loop(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                device=device, lr=args.lr, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, log_every=args.log_every,
                compress_grads=args.compress_grads, rules=rules)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
