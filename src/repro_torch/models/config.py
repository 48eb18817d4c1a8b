"""ModelConfig: one declarative record per architecture (the port's copy
of ``repro.models.config``, the same fields, defaults and properties).

Covers every family in the assigned pool: dense GQA/MHA transformers,
MLA (DeepSeek-V2), MoE (routed + shared experts), SSM (Mamba2/SSD), hybrid
layer patterns (Jamba), VLM and audio backbones with stubbed frontends, and
encoder-decoder (Whisper).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN width
    n_shared: int = 0             # always-on shared experts (DeepSeek-V2)
    every_k: int = 1              # MoE replaces the MLP on layers l % k == 0
    first_dense: int = 0          # leading layers that stay dense (DSv2: 1)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    chunk: int = 256              # SSD chunk length (train/prefill)

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | vlm | ssm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # --- attention flavour ---
    attn_type: str = "gqa"        # gqa | mla | none
    qk_norm: bool = False
    rope_theta: float = 10000.0
    # --- MLA (DeepSeek-V2) ---
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128
    # --- mixture of experts ---
    moe: Optional[MoEConfig] = None
    # --- state space ---
    ssm: Optional[SSMConfig] = None
    # --- hybrid layer pattern; () means ("attn",) * n_layers ---
    # slots drawn from {"attn", "ssm"}; pattern length must divide n_layers.
    layer_pattern: Tuple[str, ...] = ()
    # --- encoder-decoder (Whisper) ---
    encoder_layers: int = 0       # > 0 => enc-dec; n_layers is the decoder
    encoder_seq: int = 1500       # precomputed frame count (audio stub)
    # --- multimodal stub ---
    frontend: str = "none"        # none | audio | vision
    num_patches: int = 0          # vision: patches prepended to the sequence
    # --- misc ---
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256 for clean tensor-parallel sharding (the
        standard Megatron/MaxText trick).  The loss masks the pad columns."""
        return (self.vocab_size + 255) // 256 * 256

    @property
    def pattern(self) -> Tuple[str, ...]:
        return self.layer_pattern if self.layer_pattern else ("attn",)

    @property
    def n_periods(self) -> int:
        period = len(self.pattern)
        assert self.n_layers % period == 0, (self.n_layers, period)
        return self.n_layers // period

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return all(s == "ssm" for s in self.pattern)

    @property
    def supports_long_decode(self) -> bool:
        """long_500k runs only for sub-quadratic-decode families: a pure SSM
        has O(1) state; a hybrid's few attention layers hold a sharded KV.
        Pure full-attention archs are skipped (DESIGN.md §shapes)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # every assigned arch has an autoregressive decoder

    def layer_kind(self, l: int) -> str:
        return self.pattern[l % len(self.pattern)]

    def is_moe_layer(self, l: int) -> bool:
        if self.moe is None:
            return False
        if l < self.moe.first_dense:
            return False
        return (l - self.moe.first_dense) % self.moe.every_k == 0

    def param_count(self) -> int:
        """Analytic parameter count (roofline: MODEL_FLOPS = 6·N·D)."""
        from . import model as _m
        return _m.count_params(self)

    def active_param_count(self) -> int:
        from . import model as _m
        return _m.count_params(self, active_only=True)
