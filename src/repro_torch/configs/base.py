"""Model configuration (every family) and the architecture registry.

Counterpart of ``repro/configs/base.py``, cut to the fields the model
reads: RMSNorm or LayerNorm, SwiGLU or tanh-GELU MLP, RoPE, GQA,
optional q/k/v bias and QK-norm, causal or bidirectional attention,
untied head; for the ``moe`` family the routed experts (top-k of
``num_experts``, each a SwiGLU of width ``moe_d_ff``, capacity
``max(int(capacity_factor·T·k/E), 4)`` slots) and ``num_shared_experts``
shared ones (one SwiGLU of width ``moe_d_ff·num_shared_experts``); the
Mamba2 backbone of the ``hybrid`` family (Zamba2: a shared attention
block every ``attn_period`` layers), RWKV-6 of the ``ssm`` family, the
gated cross-attention layers of the ``vlm`` family (every
``cross_attn_period``-th layer, over ``num_image_tokens`` image
embeddings) and the encoder of the ``audio`` family (HuBERT: a
convolutional positional embedding of width ``conv_pos_width``).
"""

from __future__ import annotations

import dataclasses
import importlib

__all__ = ["ModelConfig", "ARCH_IDS", "get_config", "get_smoke_config"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # --- attention ---
    rope_theta: float = 1_000_000.0
    qkv_bias: bool = False
    qk_norm: bool = False
    causal: bool = True
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

    # --- SSM (Mamba2 / zamba2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    attn_period: int = 0         # hybrid: shared attn block every N ssm layers

    # --- RWKV6 ---
    rwkv_head_dim: int = 64
    rwkv_decay_lora: int = 64

    # --- VLM ---
    cross_attn_period: int = 0   # every Nth layer is a cross-attn layer
    num_image_tokens: int = 0    # stub frontend: precomputed patch embeds

    # --- encoder-only (audio) ---
    encoder_only: bool = False
    conv_pos_width: int = 0      # HuBERT conv positional embedding kernel

    @property
    def num_self_layers(self) -> int:
        if self.cross_attn_period:
            return self.num_layers - self.num_layers // self.cross_attn_period
        return self.num_layers

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def has_decode(self) -> bool:
        return not self.encoder_only


ARCH_IDS = ["llama3_8b", "llama3_70b", "mistral_nemo_12b", "qwen2_72b",
            "qwen2p5_32b", "starcoder2_15b", "moonshot_v1_16b_a3b",
            "qwen3_moe_235b_a22b", "zamba2_2p7b", "rwkv6_1p6b",
            "llama3p2_vision_90b", "hubert_xlarge"]


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
