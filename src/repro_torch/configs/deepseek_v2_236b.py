"""DeepSeek-V2 236B — MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434; hf].

60L d_model=5120 128H d_expert=1536 vocab=102400; first layer dense
(d_ff=12288); q_lora=1536, rope/nope head dims 64/128, v_head_dim 128.
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=192,
    d_ff=12288, vocab_size=102400,
    attn_type="mla", kv_lora_rank=512, q_lora_rank=1536,
    rope_head_dim=64, nope_head_dim=128, v_head_dim=128,
    moe=MoEConfig(num_experts=160, top_k=6, d_expert=1536, n_shared=2,
                  every_k=1, first_dense=1),
)

SMOKE = ModelConfig(
    name="deepseek-v2-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=48,
    d_ff=128, vocab_size=256,
    attn_type="mla", kv_lora_rank=32, q_lora_rank=48,
    rope_head_dim=16, nope_head_dim=32, v_head_dim=32,
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=32, n_shared=1,
                  every_k=1, first_dense=1),
    dtype="float32",
)
