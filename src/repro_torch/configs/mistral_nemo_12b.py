"""mistral-nemo-12b — dense GQA, 128k context. [hf:mistralai/Mistral-Nemo-Base-2407]

40L d_model=5120 32H kv=8 head_dim=128 d_ff=14336 vocab=131072.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b", family="dense",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072,
    rope_theta=1_000_000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="mistral-nemo-smoke", family="dense",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
    d_ff=256, vocab_size=512,
    rope_theta=1_000_000.0,
)
