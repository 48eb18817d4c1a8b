"""DeepSeek-Coder 33B — llama-arch [arXiv:2401.14196; hf].

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=19200, vocab_size=32256, rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="deepseek-coder-smoke", family="dense",
    n_layers=2, d_model=56, n_heads=7, n_kv_heads=1, head_dim=8,
    d_ff=160, vocab_size=256, dtype="float32",
)
