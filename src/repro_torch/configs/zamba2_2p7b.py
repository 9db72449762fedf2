"""zamba2-2.7b — hybrid Mamba2 backbone + shared attention block.

[arXiv:2411.15242; hf] 54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000,
ssm_state=64. The shared transformer block (full attn + SwiGLU MLP) is one
parameter set invoked every ``attn_period`` Mamba2 layers (Zamba2 design).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32, head_dim=80,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_conv=4, ssm_head_dim=64, ssm_chunk=128,
    attn_period=6, rope_theta=10000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    num_layers=4, d_model=128, num_heads=4, num_kv_heads=4, head_dim=32,
    d_ff=256, vocab_size=512,
    ssm_state=16, ssm_expand=2, ssm_conv=4, ssm_head_dim=32, ssm_chunk=32,
    attn_period=2, rope_theta=10000.0,
)
