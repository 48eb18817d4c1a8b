"""Whisper tiny — enc-dec, conv frontend stubbed [arXiv:2212.04356;
unverified].

4+4L d_model=384 6H d_ff=1536 vocab=51865.  The mel/conv frontend is a STUB:
``input_specs()`` provides precomputed frame embeddings (B, 1500, 384).
GELU MLPs (family="audio"); every decoder layer cross-attends the encoder.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, head_dim=64,
    d_ff=1536, vocab_size=51865,
    encoder_layers=4, encoder_seq=1500, frontend="audio",
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256,
    encoder_layers=2, encoder_seq=64, frontend="audio",
    dtype="float32",
)
