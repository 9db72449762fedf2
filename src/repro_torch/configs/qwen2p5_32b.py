"""qwen2.5-32b — dense GQA decoder with QKV bias. [hf:Qwen/Qwen2.5 family]

64L d_model=5120 40H kv=8 head_dim=128 d_ff=27648 vocab=152064.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=27648, vocab_size=152064,
    qkv_bias=True, rope_theta=1_000_000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2.5-smoke", family="dense",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
    d_ff=256, vocab_size=512,
    qkv_bias=True, rope_theta=1_000_000.0,
)
