"""Low-bit quantization primitives (W4 / A4 / A8), byte-compatible with
``repro/core/quantizer.py``.

* INT4 values live in [-8, 7] and are stored biased by +8 as unsigned
  nibbles, two per uint8 byte, in the blocked "location switch" layout:
  within each block of ``block_size`` elements byte ``j`` holds element
  ``j`` (low nibble) and ``j + block_size/2`` (high nibble).
* INT8 values live in [-128, 127] as plain int8.
* Scales are float32, one per (row, 128-block) for activations and one
  per (128-block, output column) for weights.
* KV is asymmetric per channel: codes ``clip(round(x/scale + zero), 0,
  15)`` with static scale/zero ``[..., 1, D]``, packed along the head
  dimension as byte ``j`` = channel ``j`` (low nibble) and channel
  ``j + D/2`` (high nibble) — not the weights' per-128 layout.

Rounding is half-to-even (``torch.round``) and every division is IEEE
float32, so codes and scales match the reference bit for bit.
"""

from __future__ import annotations

import torch

INT4_MIN, INT4_MAX, INT4_BIAS = -8, 7, 8
INT8_MIN, INT8_MAX = -128, 127

__all__ = [
    "INT4_MIN", "INT4_MAX", "INT4_BIAS",
    "absmax_scale", "asym_scale_zero", "quantize_int4", "quantize_int8",
    "dequantize_int4", "dequantize_int8",
    "pack_int4", "unpack_int4", "unpack_int4_biased",
    "pack_int4_interleaved", "unpack_int4_interleaved",
    "quantize_weight_int4", "dequantize_weight_int4",
    "quantize_act_groupwise", "quantize_kv_channelwise", "kv_codes",
    "quantize_kv_with", "qdq_kv_with",
    "pack_kv_nibbles", "unpack_kv_nibbles", "dequantize_kv_channelwise",
]


def absmax_scale(x: torch.Tensor, dim, bits: int,
                 clip_ratio: float = 1.0) -> torch.Tensor:
    """Symmetric scale s.t. ``clip_ratio``·absmax maps to the max quant
    level: ``max(amax·clip, 1e-8) / qmax``, in that order."""
    amax = x.abs().amax(dim=dim, keepdim=True)
    if clip_ratio != 1.0:
        amax = amax * clip_ratio
    amax = torch.clamp_min(amax, 1e-8)
    # divide by a tensor: PyTorch on the card turns division by a Python
    # scalar into a multiply by its rounded reciprocal, which is not the
    # IEEE quotient the reference (and the CUDA kernel) computes
    qmax = amax.new_full((), float(2 ** (bits - 1) - 1))
    return (amax / qmax).to(torch.float32)


def asym_scale_zero(x: torch.Tensor, dim, bits: int):
    """Asymmetric scale/zero-point: x ≈ (q − zero)·scale, q in [0, 2^b−1];
    scale ``max((max − min)/qmax, 1e-8)`` in f32, zero ``round(−min /
    scale)``."""
    xmin = x.amin(dim=dim, keepdim=True)
    xmax = x.amax(dim=dim, keepdim=True)
    qmax = xmin.new_full((), float(2 ** bits - 1))
    scale = torch.clamp_min((xmax - xmin) / qmax, 1e-8).to(torch.float32)
    zero = torch.round(-xmin / scale)
    return scale, zero.to(torch.float32)


def quantize_int4(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric int4 quantization → int8 tensor of values in [-8, 7]."""
    return torch.clamp(torch.round(x / scale), INT4_MIN, INT4_MAX).to(
        torch.int8)


def quantize_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), INT8_MIN, INT8_MAX).to(
        torch.int8)


def dequantize_int4(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def pack_int4(q: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """int8 values in [-8, 7] → uint8 along ``dim``: byte ``j`` holds
    elements ``2j`` (low nibble) and ``2j+1`` (high), biased by +8."""
    dim = dim % q.ndim
    if q.shape[dim] % 2:
        raise ValueError(f"pack axis length {q.shape[dim]} must be even")
    biased = (q.to(torch.int32) + INT4_BIAS).to(torch.uint8).movedim(dim, -1)
    return (biased[..., 0::2] | (biased[..., 1::2] << 4)).movedim(-1, dim) \
        .contiguous()


def unpack_int4_biased(packed: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Inverse of :func:`pack_int4` without the bias subtract: int8
    nibbles in [0, 15]."""
    dim = dim % packed.ndim
    lo = (packed & 0x0F).to(torch.int8)
    hi = (packed >> 4).to(torch.int8)
    shape = list(packed.shape)
    shape[dim] *= 2
    return torch.stack([lo, hi], dim=dim + 1).reshape(shape)


def unpack_int4(packed: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Inverse of :func:`pack_int4` → int8 values in [-8, 7]."""
    return unpack_int4_biased(packed, dim) - INT4_BIAS


def pack_int4_interleaved(q: torch.Tensor, dim: int = 0,
                          block_size: int | None = None) -> torch.Tensor:
    """int8 values in [-8, 7] → biased nibbles packed in the blocked
    location-switch layout along ``dim`` (whole axis if no block size)."""
    dim = dim % q.ndim
    k = q.shape[dim]
    bs = k if block_size is None else block_size
    if bs % 2 or k % bs:
        raise ValueError(f"axis length {k} must tile into even blocks of {bs}")
    biased = (q.to(torch.int32) + INT4_BIAS).to(torch.uint8)
    moved = biased.movedim(dim, 0)
    nb = k // bs
    moved = moved.reshape(nb, bs, *moved.shape[1:])
    packed = moved[:, : bs // 2] | (moved[:, bs // 2:] << 4)
    packed = packed.reshape(nb * (bs // 2), *packed.shape[2:])
    return packed.movedim(0, dim).contiguous()


def unpack_int4_interleaved(packed: torch.Tensor, dim: int = 0,
                            block_size: int | None = None) -> torch.Tensor:
    """Inverse of :func:`pack_int4_interleaved` → int8 values in [-8, 7]."""
    dim = dim % packed.ndim
    kp = packed.shape[dim]
    bsh = kp if block_size is None else block_size // 2
    if kp % bsh:
        raise ValueError(f"packed axis {kp} must tile into blocks of {bsh}")
    moved = packed.movedim(dim, 0)
    nb = kp // bsh
    moved = moved.reshape(nb, bsh, *moved.shape[1:])
    lo = (moved & 0x0F).to(torch.int8) - INT4_BIAS
    hi = (moved >> 4).to(torch.int8) - INT4_BIAS
    out = torch.cat([lo, hi], dim=1).reshape(nb * bsh * 2, *moved.shape[2:])
    return out.movedim(0, dim).contiguous()


def quantize_weight_int4(w: torch.Tensor, group_size: int = 128,
                         clip_ratio: float = 1.0):
    """[K, N] weight → (packed uint8 [K/2, N], scale f32 [K/g, N]).

    One scale per (K-group of ``group_size``, output column); the packing
    blocks match the groups, so a GEMM K step never splits a byte.
    ``group_size=-1``: one scale per column (``[1, N]``), packed over the
    whole K axis. A stack ``[E, K, N]`` (an MoE layer's experts) is
    quantized expert by expert into ``[E, K/2, N]`` and ``[E, K/g, N]``,
    each expert's bytes those of its own ``[K, N]`` (as the reference's
    ``vmap``), one expert's temporaries at a time."""
    if w.ndim == 3:
        parts = [quantize_weight_int4(we, group_size, clip_ratio) for we in w]
        return (torch.stack([p for p, _ in parts]),
                torch.stack([s for _, s in parts]))
    if w.ndim != 2:
        raise ValueError(f"expected [K, N] or [E, K, N] weight, got "
                         f"{tuple(w.shape)}")
    k, n = w.shape
    if group_size == -1:
        scale = absmax_scale(w, dim=0, bits=4, clip_ratio=clip_ratio)
        q = quantize_int4(w, scale)
        return pack_int4_interleaved(q, dim=0), scale
    if k % group_size:
        raise ValueError(f"K={k} not divisible by group_size={group_size}")
    wg = w.reshape(k // group_size, group_size, n)
    scale = absmax_scale(wg, dim=1, bits=4, clip_ratio=clip_ratio)
    q = quantize_int4(wg, scale).reshape(k, n)
    packed = pack_int4_interleaved(q, dim=0, block_size=group_size)
    return packed, scale[:, 0, :].contiguous()


def dequantize_weight_int4(packed: torch.Tensor, scale: torch.Tensor,
                           group_size: int = 128) -> torch.Tensor:
    """Packed [..., K/2, N] + scale [..., K/g, N] → f32 [..., K, N]
    (``group_size=-1``: scale [..., 1, N] per column)."""
    if group_size == -1:
        q = unpack_int4_interleaved(packed, dim=-2)
        return q.to(torch.float32) * scale
    q = unpack_int4_interleaved(packed, dim=-2, block_size=group_size)
    *lead, k, n = q.shape
    q = q.to(torch.float32).reshape(*lead, k // group_size, group_size, n)
    return (q * scale[..., :, None, :]).reshape(*lead, k, n)


def quantize_act_groupwise(x: torch.Tensor, block_size: int = 128,
                           bits: int = 4, clip_ratio: float = 1.0):
    """[M, K] activations → (q int8 [M, K], scale f32 [M, K/block])."""
    m, k = x.shape
    if k % block_size:
        raise ValueError(f"K={k} not divisible by block={block_size}")
    xb = x.reshape(m, k // block_size, block_size)
    scale = absmax_scale(xb, dim=2, bits=bits, clip_ratio=clip_ratio)
    if bits == 4:
        q = quantize_int4(xb, scale)
    elif bits == 8:
        q = quantize_int8(xb, scale)
    else:
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    return q.reshape(m, k), scale[:, :, 0]


def quantize_kv_channelwise(kv: torch.Tensor, dim: int = -1):
    """Asymmetric int4 over the head-dim channels of ``kv [..., T, D]``,
    each channel's scale and zero taken over the token axis → (packed
    uint8 ``[..., T, D/2]``, scale ``[..., 1, D]``, zero ``[..., 1, D]``)."""
    if dim != -1:
        raise NotImplementedError("channel axis must be last")
    scale, zero = asym_scale_zero(kv, dim=-2, bits=4)
    return pack_kv_nibbles(kv_codes(kv, scale, zero)), scale, zero


def kv_codes(x: torch.Tensor, scale, zero) -> torch.Tensor:
    """The KV codebook: ``clip(round(x / scale + zero), 0, 15)`` in x's
    dtype (unpacked codes)."""
    return torch.clamp(torch.round(x / scale + zero), 0, 15)


def quantize_kv_with(k, v, k_scale, k_zero, v_scale, v_zero):
    """k/v ``[B, T, Hkv, D]`` float → packed ``[B, Hkv, T, D/2]`` uint8
    by the static affine (scale/zero ``[..., Hkv, 1, D]``), in f32."""
    def pack(x, scale, zero):
        return pack_kv_nibbles(kv_codes(x.transpose(1, 2).float(), scale,
                                        zero))
    return pack(k, k_scale, k_zero), pack(v, v_scale, v_zero)


def qdq_kv_with(k, v, k_scale, k_zero, v_scale, v_zero):
    """Fake-quantize k/v (``[B, T, Hkv, D]``) through the int4 codebook →
    the f32 values a reader dequantizes from the cache."""
    def roundtrip(x, scale, zero):
        n = kv_codes(x.transpose(1, 2).float(), scale, zero)
        return ((n - zero) * scale).transpose(1, 2)
    return roundtrip(k, k_scale, k_zero), roundtrip(v, v_scale, v_zero)


def pack_kv_nibbles(n: torch.Tensor) -> torch.Tensor:
    """KV codes ``[..., D]`` in [0, 15] → uint8 ``[..., D/2]``: byte j =
    channel j | channel j + D/2 << 4."""
    n = n.to(torch.uint8)
    half = n.shape[-1] // 2
    return n[..., :half] | (n[..., half:] << 4)


def unpack_kv_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_kv_nibbles` → f32 codes ``[..., D]``."""
    return torch.cat([(packed & 0x0F).float(), (packed >> 4).float()], -1)


def dequantize_kv_channelwise(packed: torch.Tensor, scale: torch.Tensor,
                              zero: torch.Tensor) -> torch.Tensor:
    """Packed KV ``[..., T, D/2]`` → f32 ``(code − zero)·scale`` with
    scale/zero broadcastable to ``[..., 1, D]``."""
    return (unpack_kv_nibbles(packed) - zero) * scale
