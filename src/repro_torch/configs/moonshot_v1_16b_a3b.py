"""moonshot-v1-16b-a3b (Moonlight) — 64-expert top-6 MoE + shared experts.

[hf:moonshotai/Moonlight-16B-A3B] 48L d_model=2048 16H kv=16 head_dim=128,
expert d_ff=1408, vocab=163840, MoE 64e top-6, 2 shared experts.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=163840,
    num_experts=64, num_experts_per_tok=6, num_shared_experts=2, moe_d_ff=1408,
    rope_theta=50_000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="moonshot-smoke", family="moe",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, head_dim=32,
    d_ff=128, vocab_size=512,
    num_experts=8, num_experts_per_tok=3, num_shared_experts=1, moe_d_ff=128,
    rope_theta=50_000.0,
)
