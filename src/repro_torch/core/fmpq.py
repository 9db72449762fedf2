"""FMPQ — Fine-grained Mixed-Precision Quantization (COMET §3), the
port's own copy of ``repro/core/fmpq.py``.

1. **Calibration**: per-channel absmax of every projection's input over
   sample prompts (:func:`collect_channel_stats`).
2. **Outliers**: channels whose absmax exceeds ``outlier_threshold ×
   median`` (:func:`identify_outlier_channels`, the median in float64).
3. **Permutation**: normal channels, then outliers, each by ascending
   absmax (a stable sort, so ties keep channel order): the outliers
   cluster in the trailing 128-blocks (:func:`make_permutation`). The
   weight's rows are permuted alike, so the GEMM stays exact.
4. **Block precision**: a block holding an outlier channel is INT8, else
   INT4; after the permutation the INT8 blocks are the contiguous tail.

Plans are host numpy (:class:`FMPQPlan`), made offline; at serving time
the activation is gathered by ``perm`` before the fused act-quant
(``core/qlinear.py``). Weights and activations are tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import quantizer as Q

__all__ = [
    "FMPQConfig", "FMPQPlan", "collect_channel_stats",
    "identify_outlier_channels", "make_permutation",
    "assign_block_precision", "plan_fmpq", "apply_fmpq_to_weight",
    "quantize_activation_mixed", "int4_block_fraction", "BLOCK_K",
]

BLOCK_K = 128


def _check_block(name: str, size: int):
    """The W4Ax kernels read scales and the INT8 tail in 128-channel
    blocks: a plan or weight packed at another size would be misread."""
    if size != BLOCK_K:
        raise ValueError(f"{name} must be {BLOCK_K}, got {size}")


@dataclasses.dataclass(frozen=True)
class FMPQConfig:
    block_size: int = BLOCK_K
    outlier_threshold: float = 8.0   # absmax > thr × median → outlier
    act_clip_ratio: float = 1.0
    weight_clip_ratio: float = 1.0
    weight_group_size: int = 128
    max_int8_fraction: float = 1.0   # cap on the outlier channel share

    def __post_init__(self):
        _check_block("block_size", self.block_size)
        _check_block("weight_group_size", self.weight_group_size)


@dataclasses.dataclass(frozen=True)
class FMPQPlan:
    """One projection input's plan: ``perm`` [K] int32 (activation
    columns and weight rows), ``inv_perm`` its inverse, ``block_bits``
    [K/block] int8 (4 or 8 per block after the permutation, the 8s a
    contiguous tail) and ``num_int4_blocks``."""

    perm: np.ndarray
    inv_perm: np.ndarray
    block_bits: np.ndarray
    num_int4_blocks: int
    block_size: int

    def __post_init__(self):
        _check_block("block_size", self.block_size)

    @property
    def k(self) -> int:
        return self.perm.shape[0]

    @property
    def num_blocks(self) -> int:
        return self.block_bits.shape[0]

    @property
    def k4(self) -> int:
        """Leading channels quantized to INT4."""
        return self.num_int4_blocks * self.block_size

    @property
    def int4_fraction(self) -> float:
        return self.num_int4_blocks / max(1, self.num_blocks)


def collect_channel_stats(activations: torch.Tensor) -> torch.Tensor:
    """Per-channel absmax over a calibration batch ``[..., K]``."""
    return activations.reshape(-1, activations.shape[-1]).abs().amax(0)


def identify_outlier_channels(channel_absmax,
                              threshold: float = 8.0) -> np.ndarray:
    """Boolean mask of outlier channels: absmax > threshold × median."""
    absmax = np.asarray(channel_absmax, dtype=np.float64)
    med = np.median(absmax)
    if med <= 0:
        med = np.mean(absmax) + 1e-12
    return absmax > threshold * med


def make_permutation(outlier_mask: np.ndarray,
                     channel_absmax) -> np.ndarray:
    """Normal channels then outliers, each in ascending absmax (stable)."""
    absmax = np.asarray(channel_absmax, dtype=np.float64)
    order = np.argsort(absmax, kind="stable")
    normal = [i for i in order if not outlier_mask[i]]
    outlier = [i for i in order if outlier_mask[i]]
    return np.asarray(normal + outlier, dtype=np.int32)


def assign_block_precision(outlier_mask_permuted: np.ndarray,
                           block_size: int) -> np.ndarray:
    """Per-block bits: 8 if the block holds an outlier channel, else 4."""
    k = outlier_mask_permuted.shape[0]
    if k % block_size:
        raise ValueError(f"K={k} not divisible by block={block_size}")
    blocks = outlier_mask_permuted.reshape(-1, block_size)
    return np.where(blocks.any(axis=1), 8, 4).astype(np.int8)


def plan_fmpq(channel_absmax, config: FMPQConfig = FMPQConfig()) -> FMPQPlan:
    """The offline plan from calibration statistics. Past the
    ``max_int8_fraction`` cap only the most extreme channels stay
    outliers."""
    absmax = np.asarray(channel_absmax)
    k = absmax.shape[0]
    if k % config.block_size:
        raise ValueError(f"K={k} not divisible by block={config.block_size}")
    mask = identify_outlier_channels(absmax, config.outlier_threshold)
    max_outlier_channels = int(config.max_int8_fraction * k)
    if mask.sum() > max_outlier_channels:
        keep = np.argsort(absmax)[::-1][:max_outlier_channels]
        mask = np.zeros(k, dtype=bool)
        mask[keep] = True
    perm = make_permutation(mask, absmax)
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(k, dtype=np.int32)
    block_bits = assign_block_precision(mask[perm], config.block_size)
    num_int4 = int((block_bits == 4).sum())
    assert (block_bits[:num_int4] == 4).all() and \
        (block_bits[num_int4:] == 8).all(), (
            "permutation must cluster INT8 blocks contiguously at the tail")
    return FMPQPlan(perm=perm, inv_perm=inv_perm, block_bits=block_bits,
                    num_int4_blocks=num_int4, block_size=config.block_size)


def _perm(plan: FMPQPlan, device) -> torch.Tensor:
    return torch.from_numpy(plan.perm.astype(np.int64)).to(device)


def apply_fmpq_to_weight(w: torch.Tensor, plan: FMPQPlan,
                         config: FMPQConfig = FMPQConfig()):
    """Rows of ``w [K, N]`` permuted by the plan, then packed int4 →
    (packed uint8 [K/2, N], group scales [K/g, N]); every block stays
    int4 (only activations are mixed)."""
    return Q.quantize_weight_int4(w[_perm(plan, w.device)],
                                  group_size=config.weight_group_size,
                                  clip_ratio=config.weight_clip_ratio)


def quantize_activation_mixed(x: torch.Tensor, plan: FMPQPlan,
                              config: FMPQConfig = FMPQConfig()):
    """Columns of ``x [M, K]`` permuted, blocks [0, k4) to INT4 and the
    rest to INT8 → (q int8 [M, K], scale f32 [M, K/block])."""
    bs, k4 = plan.block_size, plan.k4
    xp = x[:, _perm(plan, x.device)]
    parts = []
    if k4 > 0:
        parts.append(Q.quantize_act_groupwise(
            xp[:, :k4], block_size=bs, bits=4,
            clip_ratio=config.act_clip_ratio))
    if k4 < x.shape[1]:
        parts.append(Q.quantize_act_groupwise(
            xp[:, k4:], block_size=bs, bits=8,
            clip_ratio=config.act_clip_ratio))
    return (torch.cat([q for q, _ in parts], 1),
            torch.cat([s for _, s in parts], 1))


def int4_block_fraction(plan: FMPQPlan) -> float:
    """Share of K-blocks (= of GEMM MACs) computed in W4A4."""
    return plan.int4_fraction
