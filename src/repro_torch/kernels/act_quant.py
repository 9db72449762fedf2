"""On-the-fly activation quantization: the CUDA kernel and its plain version.

Kernel: ``csrc/act_quant.cu`` (replaces ``repro/kernels/act_quant.py``
``act_quant_int4``/``act_quant_int8``; bound by bytes and, at decode
widths, by the launch; one launch quantizes both channel ranges of a W4Ax
activation, reading bf16 or f32 where it lies — see the source note).
:func:`act_quant_w4ax` is the op the projections run; :func:`act_quant_int4`
and :func:`act_quant_int8` are the same kernel over one range, the single
counterparts of the two TPU kernels. ``act_quant_ref`` and
``act_quant_w4ax_ref`` are the plain PyTorch versions, byte-identical by
construction (same IEEE division, same round-half-to-even).
"""

from __future__ import annotations

import torch

from repro_torch.core import quantizer as Q
from repro_torch.kernels import _build

BLOCK_K = 128
# the C entry's input type tag
DTYPE_TAG = {torch.float32: 0, torch.bfloat16: 1}

__all__ = ["act_quant_ref", "act_quant_w4ax_ref", "act_quant_w4ax",
           "act_quant_int4", "act_quant_int8"]


def act_quant_ref(x: torch.Tensor, block_size: int = BLOCK_K, bits: int = 4):
    """x: [M, K] → (payload, scale [M, K/B]); bits=4 gives packed uint8
    [M, K/2], bits=8 gives int8 [M, K]."""
    q, s = Q.quantize_act_groupwise(x, block_size=block_size, bits=bits)
    if bits == 4:
        return Q.pack_int4_interleaved(q, dim=1, block_size=block_size), s
    return q, s


def _outputs(m: int, k: int, k4: int, device, fill=torch.empty):
    """(a4 uint8 [M, k4/2], s4 f32 [M, k4/128], a8 int8 [M, K−k4], s8 f32
    [M, (K−k4)/128])."""
    k8 = k - k4
    return (fill((m, k4 // 2), dtype=torch.uint8, device=device),
            fill((m, k4 // BLOCK_K), dtype=torch.float32, device=device),
            fill((m, k8), dtype=torch.int8, device=device),
            fill((m, k8 // BLOCK_K), dtype=torch.float32, device=device))


def act_quant_w4ax_ref(x: torch.Tensor, k4: int):
    """x: [M, K] float → (a4, s4, a8, s8): channels [0, k4) as packed int4
    with their scales, [k4, K) as int8 with theirs, each range quantized
    from ``x.float()``; an empty range gives zero-width tensors."""
    m, k = x.shape
    a4, s4, a8, s8 = _outputs(m, k, k4, x.device, fill=torch.zeros)
    if k4:
        a4, s4 = act_quant_ref(x[:, :k4].float(), bits=4)
    if k4 < k:
        a8, s8 = act_quant_ref(x[:, k4:].float(), bits=8)
    return a4, s4, a8, s8


def _check(x: torch.Tensor):
    if not x.is_cuda:
        raise ValueError("act_quant kernel needs a CUDA tensor")
    if x.dtype not in DTYPE_TAG or x.ndim != 2:
        raise ValueError(f"expected bf16 or f32 [M, K], got {x.dtype} "
                         f"{tuple(x.shape)}")
    m, k = x.shape
    if k % BLOCK_K:
        raise ValueError(f"K={k} must be a multiple of {BLOCK_K}")
    if k > 1 and x.stride(1) != 1:
        raise ValueError("the channel stride must be 1")
    if x.data_ptr() % 16 or (m > 1 and x.stride(0) * x.element_size() % 16):
        raise ValueError("the base pointer and the row stride must keep "
                         "16-byte alignment")


def _launch(x: torch.Tensor, k4: int):
    """One launch over both ranges of a checked ``x`` → (a4, s4, a8, s8)."""
    m, k = x.shape
    if k4 % BLOCK_K or not 0 <= k4 <= k:
        raise ValueError(f"k4={k4} must be a multiple of {BLOCK_K} in "
                         f"[0, {k}]")
    out = _outputs(m, k, k4, x.device)
    _build.call("act_quant", "act_quant_w4ax", x.device, x, DTYPE_TAG[x.dtype],
                x.stride(0), m, k, k4, *out)
    return out


def act_quant_w4ax(x: torch.Tensor, k4: int):
    """x: bf16 or f32 [M, K] on the card (unit channel stride, any 16-byte
    aligned row stride; never copied) → (a4 uint8 [M, k4/2], s4 f32 [M,
    k4/128], a8 int8 [M, K−k4], s8 f32 [M, (K−k4)/128]) in one launch."""
    _check(x)
    out = _launch(x, k4)
    act_quant_w4ax.launches += 1
    return out


def act_quant_int4(x: torch.Tensor):
    """x: bf16 or f32 [M, K] on the card → (packed uint8 [M, K/2], f32
    [M, K/128]): the kernel with an empty int8 range."""
    _check(x)
    a4, s4, _, _ = _launch(x, x.shape[1])
    act_quant_int4.launches += 1
    return a4, s4


def act_quant_int8(x: torch.Tensor):
    """x: bf16 or f32 [M, K] on the card → (int8 [M, K], f32 [M, K/128]):
    the kernel with an empty int4 range."""
    _check(x)
    _, _, a8, s8 = _launch(x, 0)
    act_quant_int8.launches += 1
    return a8, s8


act_quant_w4ax.launches = 0
act_quant_int4.launches = 0
act_quant_int8.launches = 0
