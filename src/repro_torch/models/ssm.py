"""Mamba2 (SSD) block: shapes only in this slice (the port's counterpart
of ``repro.models.ssm``).

``ssm_abstract`` and ``ssm_cache_abstract`` are enough for
``count_params`` and ``cache_abstract``; the chunked SSD scan and the
decode recurrence (``ssm_apply``) are ROADMAP A19b.
"""
from __future__ import annotations

from .config import ModelConfig
from .sharding import ParamSpec


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
