"""starcoder2-15b — dense GQA, LayerNorm + non-gated GELU FFN, RoPE.

[arXiv:2402.19173] 40L d_model=6144 48H kv=4 head_dim=128 d_ff=24576
vocab=49152.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=4, head_dim=128,
    d_ff=24576, vocab_size=49152,
    norm="layernorm", mlp_act="gelu", qkv_bias=True, rope_theta=100_000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="starcoder2-smoke", family="dense",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
    d_ff=512, vocab_size=512,
    norm="layernorm", mlp_act="gelu", qkv_bias=True, rope_theta=100_000.0,
)
