"""llama-3-70b — paper's large evaluation model."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3-70b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128256,
    rope_theta=500_000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="llama3-70b-smoke", family="dense",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
    d_ff=256, vocab_size=512,
    rope_theta=500_000.0,
)
