"""rwkv6-1.6b (Finch) — attention-free, data-dependent decay.

[arXiv:2404.05892] 24L d_model=2048 d_ff=7168 vocab=65536; 32 heads of 64.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=7168, vocab_size=65536,
    rwkv_head_dim=64, rwkv_decay_lora=64,
)

SMOKE_CONFIG = ModelConfig(
    name="rwkv6-smoke", family="ssm",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, head_dim=32,
    d_ff=256, vocab_size=512,
    rwkv_head_dim=32, rwkv_decay_lora=16,
)
