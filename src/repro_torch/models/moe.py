"""Mixture-of-Experts layer: shapes only in this slice (the port's
counterpart of ``repro.models.moe``).

``moe_abstract`` is enough for ``count_params`` and the decoder's
parameter tree; the router and the capacity dispatch (``moe_apply``) are
ROADMAP A19b.
"""
from __future__ import annotations

from .config import ModelConfig
from .sharding import ParamSpec
from . import layers


def moe_abstract(cfg: ModelConfig):
    mo = cfg.moe
    D, F, E = cfg.d_model, mo.d_expert, mo.num_experts
    p = {
        "router": ParamSpec((D, E), ("fsdp", None)),
        "w_gate": ParamSpec((E, D, F), ("tensor", "fsdp", None)),
        "w_up": ParamSpec((E, D, F), ("tensor", "fsdp", None)),
        "w_down": ParamSpec((E, F, D), ("tensor", None, "fsdp")),
    }
    if mo.n_shared:
        p["shared"] = layers.swiglu_abstract(D, F * mo.n_shared)
    return p
