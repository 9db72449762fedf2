"""llama-3.2-vision-90b — VLM: decoder with cross-attn image layers.

[hf:meta-llama/Llama-3.2-11B-Vision scaled] 100L (80 self + 20 cross,
every 5th is cross-attn) d_model=8192 64H kv=8 head_dim=128 d_ff=28672
vocab=128256. Vision tower is a STUB: ``input_specs()`` provides
precomputed patch embeddings [B, num_image_tokens, d_model].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    num_layers=100, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128256,
    cross_attn_period=5, num_image_tokens=1601, rope_theta=500_000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="llama-vision-smoke", family="vlm",
    num_layers=4, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
    d_ff=256, vocab_size=512,
    cross_attn_period=2, num_image_tokens=16, rope_theta=500_000.0,
)
