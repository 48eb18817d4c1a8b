"""Qwen3-30B-A3B — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf].

48L d_model=2048 32H (GQA kv=4) d_expert=768 vocab=151936, qk_norm.
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=768, vocab_size=151936, qk_norm=True, rope_theta=1000000.0,
    moe=MoEConfig(num_experts=128, top_k=8, d_expert=768, n_shared=0,
                  every_k=1, first_dense=0),
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=64, vocab_size=256, qk_norm=True,
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=64),
    dtype="float32",
)
