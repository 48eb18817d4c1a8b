"""Dry-run cells: (architecture x input shape) -> a step traced on a
production mesh (the port's counterpart of ``repro.launch.cells``).

The reference lowers each cell's step with ``jax.jit`` on placeholder
devices; the port runs it, once, on ``meta`` DTensors over the fake
process group of ``mesh.make_production_mesh``: every parameter, moment,
cache leaf and input is a DTensor placed by its logical axes, whose
local shard is a ``meta`` tensor, so the step allocates nothing and
moves no data, while DTensor still inserts each collective it would
issue.  ``trace_cell`` runs it under ``analysis.Counter``, which counts
what one device does.  This module only builds; ``launch/dryrun.py``
starts the fake group.

Shapes (the reference's):
    train_4k      seq 4096,   global_batch 256   -> train_step
    prefill_32k   seq 32768,  global_batch 32    -> serve_step (prefill)
    decode_32k    seq 32768,  global_batch 128   -> serve_step (1 new token)
    long_500k     seq 524288, global_batch 1     -> serve_step (1 new token,
                  SSM/hybrid only: the quadratic-KV archs are skipped)
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch import configs
from repro_torch.launch import analysis
from repro_torch.models import model, sharding
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def applicable(cfg: ModelConfig, shape_name: str) -> Tuple[bool, str]:
    """Whether this (arch, shape) cell runs; the reason where not."""
    sp = SHAPES[shape_name]
    if sp.name == "long_500k" and not cfg.supports_long_decode:
        return False, ("full-attention arch: 512k dense-KV decode is the "
                       "quadratic regime the shape list excludes")
    return True, ""


# ---------------------------------------------------------------------------
# Inputs (meta tensors and their specs; never allocated)
# ---------------------------------------------------------------------------


def _batch_divisible(mesh, rules: sharding.Rules, B: int) -> bool:
    if mesh is None:
        return True
    sizes = sharding.mesh_sizes(mesh)
    n = 1
    for a in rules.batch:
        n *= sizes.get(a, 1)
    return B % n == 0


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape_name: str, rules: sharding.Rules,
                mesh=None):
    """(a tree of meta tensors, the same tree of specs) of the step's
    inputs beyond the parameters and the optimizer state: the batch, the
    cache, the token.  Where the global batch does not divide the batch
    axes (long_500k: B = 1), the batch dims are replicated, as the
    reference's are."""
    sp = SHAPES[shape_name]
    B, S = sp.global_batch, sp.seq_len
    if not _batch_divisible(mesh, rules, B):
        rules = dataclasses.replace(rules, batch=())
    bspec = sharding.to_pspec(("batch", None), rules)
    b3 = sharding.to_pspec(("batch", None, None), rules)
    i64 = torch.int64
    dt = model.cache_dtype(cfg)

    def frontend(sds, specs):
        if cfg.frontend == "vision":
            sds["patches"] = _meta((B, cfg.num_patches, cfg.d_model), dt)
            specs["patches"] = b3
        if cfg.frontend == "audio":
            sds["frames"] = _meta((B, cfg.encoder_seq, cfg.d_model), dt)
            specs["frames"] = b3

    if sp.kind == "train":
        sds = {"tokens": _meta((B, S), i64), "labels": _meta((B, S), i64)}
        specs = {"tokens": bspec, "labels": bspec}
        frontend(sds, specs)
        return sds, specs

    cache_ab = model.cache_abstract(cfg, B, S)
    cache_sds = sharding.sds_tree(cache_ab, dt)
    cache_specs = sharding.pspec_tree(cache_ab, rules)
    if sp.kind == "prefill":
        sds = {"tokens": _meta((B, S), i64)}
        specs = {"tokens": bspec}
        frontend(sds, specs)
        return ({"batch": sds, "cache": cache_sds},
                {"batch": specs, "cache": cache_specs})
    # decode: one token against a cache of seq_len positions, the last
    return ({"token": _meta((B, 1), i64), "cache": cache_sds},
            {"token": bspec, "cache": cache_specs})


def place(sds, specs, mesh):
    """A tree of (meta) tensors as DTensors on ``mesh`` by a tree of
    specs, each rank's piece cut locally (no data moves)."""
    leaves = sharding.tree_leaves(sds, lambda x: False)
    pspecs = sharding.tree_leaves(specs, sharding.is_pspec)
    return sharding.tree_unflatten(sds, [
        sharding.local_part(t, mesh, sharding.placements(p, mesh))
        for t, p in zip(leaves, pspecs)])


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------


def build_train_step(cfg: ModelConfig, rules: sharding.Rules,
                     acfg: Optional[adamw.AdamWConfig] = None):
    """(params, opt_state, batch) -> (params, opt_state, {"loss"}): the
    loss, its gradients in their parameters' placements, one AdamW
    update."""
    acfg = acfg or adamw.AdamWConfig()

    def train_step(params, opt_state, batch):
        with sharding.on_mesh(rules):
            loss = model.loss_fn(cfg, params, batch, rules=rules)
            leaves = sharding.tree_leaves(params)
            grads = torch.autograd.grad(loss, leaves)
            grads = sharding.tree_unflatten(params, [
                adamw.placed(g, p) for g, p in zip(grads, leaves)])
            loss = sharding.constrain(loss, rules)
        new_params, new_state = adamw.update(acfg, grads, opt_state, params)
        return new_params, new_state, {"loss": loss}

    return train_step


def _logits(logits, rules, out_rules):
    """The logits in the reference's out-sharding (batch, None, tensor)."""
    with sharding.on_mesh(rules):
        return sharding.constrain(logits, out_rules, "batch", None, "tensor")


def build_prefill_step(cfg: ModelConfig, rules: sharding.Rules,
                       out_rules: Optional[sharding.Rules] = None):
    def serve_step(params, batch, cache):
        logits, cache = model.prefill(cfg, params, batch, cache, rules=rules)
        return _logits(logits, rules, out_rules or rules), cache
    return serve_step


def build_decode_step(cfg: ModelConfig, rules: sharding.Rules,
                      out_rules: Optional[sharding.Rules] = None):
    def serve_step(params, token, cache, cache_len):
        logits, cache = model.decode_step(cfg, params, token, cache,
                                          cache_len, rules=rules)
        return _logits(logits, rules, out_rules or rules), cache
    return serve_step


# ---------------------------------------------------------------------------
# Trace one cell on a mesh
# ---------------------------------------------------------------------------


def trace_cell(arch: str, shape_name: str, mesh, *,
               cfg: Optional[ModelConfig] = None, count: bool = True):
    """Run the cell's step once on ``meta`` DTensors over ``mesh`` inside
    an ``analysis.Counter`` (counting nothing where ``count`` is false).
    Returns (the counter, meta), meta carrying the analytic FLOPs."""
    cfg = cfg or configs.get(arch)
    ok, reason = applicable(cfg, shape_name)
    if not ok:
        raise ValueError(f"cell ({arch}, {shape_name}) skipped: {reason}")
    rules = sharding.rules_for_mesh(mesh)
    sp = SHAPES[shape_name]
    dt = model.cache_dtype(cfg)
    params_ab = model.model_abstract(cfg)
    params = place(sharding.sds_tree(params_ab, dt),
                   sharding.pspec_tree(params_ab, rules), mesh)
    in_sds, in_specs = input_specs(cfg, shape_name, rules, mesh)
    inputs = place(in_sds, in_specs, mesh)
    out_rules = rules
    if not _batch_divisible(mesh, rules, sp.global_batch):
        out_rules = dataclasses.replace(rules, batch=())

    if sp.kind == "train":
        for t in sharding.tree_leaves(params):
            t.requires_grad_()
        specs = sharding.pspec_tree(params_ab, rules)
        opt = adamw.abstract_state(sharding.sds_tree(params_ab, dt))
        opt_specs = adamw.state_pspecs(specs)
        opt = opt._replace(m=place(opt.m, opt_specs.m, mesh),
                           v=place(opt.v, opt_specs.v, mesh), step=0)
        args = (params, opt, inputs)
        run = lambda: build_train_step(cfg, rules)(*args)  # noqa: E731
    elif sp.kind == "prefill":
        args = (params, inputs["batch"], inputs["cache"])
        run = lambda: build_prefill_step(  # noqa: E731
            cfg, rules, out_rules)(*args)
    else:
        args = (params, inputs["token"], inputs["cache"])
        run = lambda: build_decode_step(  # noqa: E731
            cfg, rules, out_rules)(*args, sp.seq_len - 1)
    counter = analysis.Counter(args, count=count)
    grad = contextlib.nullcontext() if sp.kind == "train" else \
        torch.no_grad()
    with counter, grad:
        run()
    return counter, cell_model_flops(cfg, shape_name)


def cell_model_flops(cfg: ModelConfig, shape_name: str) -> dict:
    """Analytic useful FLOPs of the cell (MODEL_FLOPS of the roofline):
    6 (train) or 2 (serve) x the active non-embedding parameters x the
    tokens."""
    sp = SHAPES[shape_name]
    n_active = model.non_embedding_params(cfg, active_only=True)
    tokens = sp.global_batch * (sp.seq_len if sp.kind != "decode" else 1)
    mult = 6 if sp.kind == "train" else 2
    return {
        "arch": cfg.name, "shape": shape_name, "kind": sp.kind,
        "n_params": model.count_params(cfg),
        "n_active_nonembed": n_active,
        "tokens": tokens,
        "model_flops": float(mult) * n_active * tokens,
    }
