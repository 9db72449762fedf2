"""Model configuration (dense and MoE families) and the architecture
registry.

Counterpart of ``repro/configs/base.py``, cut to the fields the serving
path reads: RMSNorm or LayerNorm, SwiGLU or tanh-GELU MLP, RoPE, GQA,
optional q/k/v bias and QK-norm, untied head; for the ``moe`` family the
routed experts (top-k of ``num_experts``, each a SwiGLU of width
``moe_d_ff``, capacity ``max(int(capacity_factor·T·k/E), 4)`` slots) and
``num_shared_experts`` shared ones (one SwiGLU of width
``moe_d_ff·num_shared_experts``).
"""

from __future__ import annotations

import dataclasses
import importlib

__all__ = ["ModelConfig", "ARCH_IDS", "get_config", "get_smoke_config"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    rope_theta: float = 1_000_000.0
    qkv_bias: bool = False
    qk_norm: bool = False
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    mlp_act: str = "swiglu"      # swiglu | gelu
    norm_eps: float = 1e-5

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.001

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


ARCH_IDS = ["llama3_8b", "llama3_70b", "mistral_nemo_12b", "qwen2_72b",
            "qwen2p5_32b", "starcoder2_15b", "moonshot_v1_16b_a3b",
            "qwen3_moe_235b_a22b"]


def _module(arch: str):
    arch = arch.replace("-", "_").replace(".", "p")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return _module(arch).SMOKE_CONFIG
