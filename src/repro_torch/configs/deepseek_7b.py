"""DeepSeek-LLM 7B — llama-arch [arXiv:2401.02954; hf].

30L d_model=4096 32H (GQA kv=32 == MHA) d_ff=11008 vocab=102400.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=11008, vocab_size=102400, rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="deepseek-7b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=160, vocab_size=256, dtype="float32",
)
