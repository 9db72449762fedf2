"""On-the-fly activation quantization: the CUDA kernel and its plain version.

Kernel: ``csrc/act_quant.cu`` (replaces ``repro/kernels/act_quant.py``
``act_quant_int4``/``act_quant_int8``; bound by bytes; one warp per
(row, 128-block) with coalesced float4 loads — see the source note).
``act_quant_ref`` is the plain PyTorch version, byte-identical by
construction (same IEEE division, same round-half-to-even).
"""

from __future__ import annotations

import torch

from repro_torch.core import quantizer as Q
from repro_torch.kernels import _build

BLOCK_K = 128

__all__ = ["act_quant_ref", "act_quant_int4", "act_quant_int8"]


def act_quant_ref(x: torch.Tensor, block_size: int = BLOCK_K, bits: int = 4):
    """x: [M, K] → (payload, scale [M, K/B]); bits=4 gives packed uint8
    [M, K/2], bits=8 gives int8 [M, K]."""
    q, s = Q.quantize_act_groupwise(x, block_size=block_size, bits=bits)
    if bits == 4:
        return Q.pack_int4_interleaved(q, dim=1, block_size=block_size), s
    return q, s


def _check(x: torch.Tensor):
    if not x.is_cuda:
        raise ValueError("act_quant kernel needs a CUDA tensor")
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"expected contiguous f32 [M, K], got {x.dtype} "
                         f"{tuple(x.shape)}")
    if x.shape[1] % BLOCK_K:
        raise ValueError(f"K={x.shape[1]} must be a multiple of {BLOCK_K}")


def act_quant_int4(x: torch.Tensor):
    """x: f32 [M, K] on the card → (packed uint8 [M, K/2], f32 [M, K/128])."""
    _check(x)
    m, k = x.shape
    packed = torch.empty((m, k // 2), dtype=torch.uint8, device=x.device)
    scale = torch.empty((m, k // BLOCK_K), dtype=torch.float32, device=x.device)
    _build.call("act_quant", "act_quant_int4", x.device, x, packed, scale, m, k)
    act_quant_int4.launches += 1
    return packed, scale


def act_quant_int8(x: torch.Tensor):
    """x: f32 [M, K] on the card → (int8 [M, K], f32 [M, K/128])."""
    _check(x)
    m, k = x.shape
    q = torch.empty((m, k), dtype=torch.int8, device=x.device)
    scale = torch.empty((m, k // BLOCK_K), dtype=torch.float32, device=x.device)
    _build.call("act_quant", "act_quant_int8", x.device, x, q, scale, m, k)
    act_quant_int8.launches += 1
    return q, scale


act_quant_int4.launches = 0
act_quant_int8.launches = 0
