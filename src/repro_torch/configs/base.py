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

The dry run's input shapes are the reference's (``SHAPES``): each arch is
exercised on

  train_4k     seq 4096  × global_batch 256   → the train step
  prefill_32k  seq 32768 × global_batch 32    → a prefill
  decode_32k   seq 32768 × global_batch 128   → one decode step
  long_500k    seq 524288 × global_batch 1    → one decode step

with the reference's skip rules: ``long_500k`` only for sub-quadratic
archs (ssm / hybrid), decode shapes skipped for encoder-only archs.
"""

from __future__ import annotations

import dataclasses
import importlib

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "ARCH_IDS",
           "get_config", "get_smoke_config", "applicable_shapes",
           "all_cells"]


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

    def param_count(self) -> int:
        """The reference's analytic parameter count N (for the 6·N·D
        roofline term): its formulas, approximations included (RWKV-6's
        time-mix as 6·d², Zamba2's Mamba2 without its conv and scalars);
        the port's head is never tied to the embedding."""
        d, v = self.d_model, self.vocab_size
        emb = 2 * v * d
        if self.family in ("dense", "moe", "vlm", "audio"):
            attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if self.family == "moe":
                n_e = self.num_experts + self.num_shared_experts
                ffn = n_e * 3 * d * self.moe_d_ff + d * self.num_experts
            elif self.mlp_act == "swiglu":
                ffn = 3 * d * self.d_ff
            else:
                ffn = 2 * d * self.d_ff
            return emb + self.num_layers * (attn + ffn)
        if self.family == "ssm":  # rwkv6
            tm = 5 * d * d + d * d
            cm = 2 * d * self.d_ff
            return emb + self.num_layers * (tm + cm)
        if self.family == "hybrid":  # zamba2: one shared attention block
            d_in = self.ssm_expand * d
            m = d * (2 * d_in + 2 * self.ssm_state) + d_in * d
            attn = (d * self.q_dim * 2 + 2 * d * self.kv_dim
                    + 3 * d * self.d_ff)
            return emb + self.num_layers * m + attn
        raise ValueError(self.family)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only the routed experts count)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        n_active = self.num_experts_per_tok + self.num_shared_experts
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        ffn = n_active * 3 * d * self.moe_d_ff + d * self.num_experts
        return 2 * self.vocab_size * d + self.num_layers * (attn + ffn)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


ARCH_IDS = ["llama3_8b", "llama3_70b", "mistral_nemo_12b", "qwen2_72b",
            "qwen2p5_32b", "starcoder2_15b", "moonshot_v1_16b_a3b",
            "qwen3_moe_235b_a22b", "zamba2_2p7b", "rwkv6_1p6b",
            "llama3p2_vision_90b", "hubert_xlarge"]
# the reference's registry order, which its dry-run cells follow (the
# paper's own evaluation models last)
CELL_ARCH_ORDER = ["zamba2_2p7b", "qwen3_moe_235b_a22b",
                   "moonshot_v1_16b_a3b", "qwen2_72b", "qwen2p5_32b",
                   "starcoder2_15b", "mistral_nemo_12b", "rwkv6_1p6b",
                   "hubert_xlarge", "llama3p2_vision_90b", "llama3_8b",
                   "llama3_70b"]


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


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    names = ["train_4k", "prefill_32k"]
    if cfg.has_decode:
        names.append("decode_32k")
        if cfg.sub_quadratic:
            names.append("long_500k")
    return names


def all_cells(include_paper_models: bool = False) -> list:
    """Every (arch, shape) dry-run cell, honouring the skip rules, in the
    reference's order."""
    return [(arch, shape) for arch in CELL_ARCH_ORDER
            if include_paper_models or not arch.startswith("llama3_")
            for shape in applicable_shapes(get_config(arch))]
