"""Pixtral 12B — pixtral-ViT frontend + mistral-nemo decoder
[hf:mistralai/Pixtral-12B-2409; unverified].

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.  The ViT frontend
is a STUB: ``input_specs()`` provides precomputed patch embeddings
(B, 256, d_model) that are prepended to the token sequence.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072, rope_theta=1000000.0,
    frontend="vision", num_patches=256,
)

SMOKE = ModelConfig(
    name="pixtral-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, frontend="vision", num_patches=8,
    dtype="float32",
)
