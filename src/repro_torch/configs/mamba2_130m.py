"""Mamba2 130M — SSD (state-space duality) [arXiv:2405.21060; unverified].

24L d_model=768, attention-free, ssm_state=128, vocab=50280, tied embeddings.
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=24, n_kv_heads=24, head_dim=64,
    d_ff=0, vocab_size=50280, attn_type="none",
    layer_pattern=("ssm",),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, d_conv=4),
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=0, vocab_size=256, attn_type="none",
    layer_pattern=("ssm",),
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, d_conv=4, chunk=32),
    tie_embeddings=True, dtype="float32",
)
