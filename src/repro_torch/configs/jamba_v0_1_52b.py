"""Jamba v0.1 52B — Mamba+attention 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.  Period-8 pattern
with one attention layer per period (slot 4); MoE replaces the MLP on every
second layer (odd slots).  Jamba's SSM layers are Mamba-1 in the release;
we use our Mamba2/SSD block with Jamba's d_state=16 (DESIGN.md §5 notes the
adaptation — SSD is the TPU-native chunked formulation).
"""
from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=65536,
    layer_pattern=("ssm", "ssm", "ssm", "ssm", "attn", "ssm", "ssm", "ssm"),
    ssm=SSMConfig(d_state=16, head_dim=64, expand=2, d_conv=4),
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=14336, n_shared=0,
                  every_k=2, first_dense=0),
)

SMOKE = ModelConfig(
    name="jamba-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    layer_pattern=("ssm", "attn"),
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, d_conv=4, chunk=32),
    moe=MoEConfig(num_experts=4, top_k=2, d_expert=128, every_k=2),
    dtype="float32",
)
