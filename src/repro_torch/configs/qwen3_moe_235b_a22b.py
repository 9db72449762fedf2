"""qwen3-moe-235b-a22b — 128-expert top-8 MoE with GQA(kv=4) + QK-norm.

[hf:Qwen/Qwen3-30B-A3B scaled per assignment] 94L d_model=4096 64H kv=4
head_dim=128, expert d_ff=1536, vocab=151936, MoE 128e top-8.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4, head_dim=128,
    d_ff=1536, vocab_size=151936,
    num_experts=128, num_experts_per_tok=8, moe_d_ff=1536,
    qk_norm=True, rope_theta=1_000_000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen3-moe-smoke", family="moe",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
    d_ff=128, vocab_size=512,
    num_experts=8, num_experts_per_tok=2, moe_d_ff=128,
    qk_norm=True, rope_theta=1_000_000.0,
)
