"""hubert-xlarge — encoder-only audio transformer (w2v2 arch).

[arXiv:2106.07447] 48L d_model=1280 16H kv=16 head_dim=80 d_ff=5120
vocab=504 (cluster targets). The conv waveform frontend is a STUB:
``input_specs()`` provides precomputed frame embeddings [B, T, d_model].
A conv positional embedding (k=128) is real.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16, head_dim=80,
    d_ff=5120, vocab_size=504,
    encoder_only=True, causal=False, norm="layernorm", mlp_act="gelu",
    conv_pos_width=128,
)

SMOKE_CONFIG = ModelConfig(
    name="hubert-smoke", family="audio",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, head_dim=32,
    d_ff=256, vocab_size=64,
    encoder_only=True, causal=False, norm="layernorm", mlp_act="gelu",
    conv_pos_width=16,
)
