"""W4Ax mixed-precision GEMM: the CUDA kernels and their plain versions.

Kernels: ``csrc/w4ax_matmul.cu`` (replaces ``repro/kernels/w4ax_matmul.py``
``w4a4_matmul``/``w4a8_matmul``/``w4ax_matmul_mixed``; bound by bytes at
serving batch sizes; raw bytes through a ``cp.async`` ring, int4 nibbles
unpacked to int8 in registers for ``mma.sync`` int8 with the
zero-extension correction algebra, a decode kernel for M ≤ 16 and a
prefill kernel above — see the source note). Two schedules:
``w4ax_matmul_split`` composes the uniform kernels as the reference's
split schedule (W4A4 over the K4 prefix, W4A8
over the K8 tail, summed); ``w4ax_matmul_mixed`` is the paper's single
kernel, whose K loop switches from INT4 to INT8 activation blocks.
The ``*_experts`` wrappers are the same kernels over an MoE layer's
experts in one launch (the expert in ``blockIdx.z``; the reference's
``jax.vmap`` of these ``pallas_call``s, ``repro/layers/mlp.py``
``_expert_linear``): activations ``[E, C, ·]``, weights ``[E, K/2, N]``,
output ``[E, C, N]``.

The plain versions unpack to exact int32 per-block dots and apply the
per-(row, block) × per-(block, column) scales in f32, like
``repro/kernels/ref.py``: ``d·(a_s·w_s)`` for the uniform kernels,
``(d·a_s)·w_s`` into one accumulator for the mixed one, each in its
kernel's rounding order. They take leading batch dims (activations
``[..., M, ·]``, weights ``[..., K/2, N]``): each expert computes exactly
what it computes alone.
"""

from __future__ import annotations

import torch

from repro_torch.core import quantizer as Q
from repro_torch.kernels import _build

BLOCK_K = 128
PACKED_BLOCK = BLOCK_K // 2

__all__ = ["w4a4_matmul_ref", "w4a8_matmul_ref", "w4ax_matmul_ref",
           "w4ax_matmul_mixed_ref", "w4a4_matmul", "w4a8_matmul",
           "w4ax_matmul_split", "w4ax_matmul_mixed", "w4a4_matmul_experts",
           "w4a8_matmul_experts", "w4ax_matmul_mixed_experts",
           "w4ax_matmul_split_experts"]


def _block_dot_scaled(a: torch.Tensor, w: torch.Tensor, a_scale, w_scale,
                      block_size: int) -> torch.Tensor:
    """int8 a [..., M, K] × int8 w [..., K, N] → Σ_b f32(int32 block
    dot)·a_s·w_s."""
    k = a.shape[-1]
    out = torch.zeros((*a.shape[:-1], w.shape[-1]), dtype=torch.float32,
                      device=a.device)
    for b in range(k // block_size):
        sl = slice(b * block_size, (b + 1) * block_size)
        # the block dot is an integer below 2^18: exact in f64 (PyTorch has
        # no integer matmul on the card) and exact again in f32
        part = (a[..., sl].to(torch.float64)
                @ w[..., sl, :].to(torch.float64)).float()
        out += part * (a_scale[..., b:b + 1].float()
                       * w_scale[..., b:b + 1, :].float())
    return out


def w4a4_matmul_ref(a_packed, a_scale, w_packed, w_scale,
                    block_size: int = BLOCK_K) -> torch.Tensor:
    """Packed int4 [..., M, K/2] × packed int4 [..., K/2, N] → f32
    [..., M, N]."""
    a = Q.unpack_int4_interleaved(a_packed, dim=-1, block_size=block_size)
    w = Q.unpack_int4_interleaved(w_packed, dim=-2, block_size=block_size)
    return _block_dot_scaled(a, w, a_scale, w_scale, block_size)


def w4a8_matmul_ref(a_q, a_scale, w_packed, w_scale,
                    block_size: int = BLOCK_K) -> torch.Tensor:
    """int8 [..., M, K] × packed int4 [..., K/2, N] → f32 [..., M, N]."""
    w = Q.unpack_int4_interleaved(w_packed, dim=-2, block_size=block_size)
    return _block_dot_scaled(a_q, w, a_scale, w_scale, block_size)


def w4ax_matmul_ref(a4_packed, a4_scale, a8_q, a8_scale, w4_packed, w4_scale,
                    w8_packed, w8_scale, block_size: int = BLOCK_K):
    """K4 channels in W4A4 plus the trailing K8 in W4A8, one output."""
    out = None
    if a4_packed.shape[-1] > 0:
        out = w4a4_matmul_ref(a4_packed, a4_scale, w4_packed, w4_scale,
                              block_size)
    if a8_q.shape[-1] > 0:
        o8 = w4a8_matmul_ref(a8_q, a8_scale, w8_packed, w8_scale, block_size)
        out = o8 if out is None else out + o8
    if out is None:
        raise ValueError("empty GEMM")
    return out


def _mixed_blocks(a4_packed, a4_scale, a8_q, a8_scale) -> tuple[int, int]:
    """(INT4 blocks, INT8 blocks) of a mixed GEMM's two activation parts."""
    nb4 = a4_scale.shape[-1] if a4_packed.shape[-1] else 0
    nb8 = a8_scale.shape[-1] if a8_q.shape[-1] else 0
    if nb4 + nb8 == 0:
        raise ValueError("empty GEMM")
    return nb4, nb8


def w4ax_matmul_mixed_ref(a4_packed, a4_scale, a8_q, a8_scale, w_packed,
                          w_scale, block_size: int = BLOCK_K) -> torch.Tensor:
    """The mixed kernel's function: one accumulator over the nb4 INT4
    blocks, then the nb8 INT8 blocks (weight rows contiguous across both),
    each block adding ``(f32(d)·a_s)·w_s`` as ``_w4ax_mixed_kernel`` does.
    A uniform operand (nb4 = 0 or nb8 = 0) takes the W4A8 or W4A4 plain
    version, as the reference's wrapper does."""
    nb4, nb8 = _mixed_blocks(a4_packed, a4_scale, a8_q, a8_scale)
    if nb4 == 0:
        return w4a8_matmul_ref(a8_q, a8_scale, w_packed, w_scale, block_size)
    if nb8 == 0:
        return w4a4_matmul_ref(a4_packed, a4_scale, w_packed, w_scale,
                               block_size)
    a = torch.cat([Q.unpack_int4_interleaved(a4_packed, dim=-1,
                                             block_size=block_size), a8_q], -1)
    a_scale = torch.cat([a4_scale, a8_scale], -1).float()
    w = Q.unpack_int4_interleaved(w_packed, dim=-2, block_size=block_size)
    out = torch.zeros((*a.shape[:-1], w.shape[-1]), dtype=torch.float32,
                      device=a.device)
    for b in range(nb4 + nb8):
        sl = slice(b * block_size, (b + 1) * block_size)
        part = (a[..., sl].to(torch.float64)
                @ w[..., sl, :].to(torch.float64)).float()
        out = out + ((part * a_scale[..., b:b + 1])
                     * w_scale[..., b:b + 1, :].float())
    return out


def _check_gemm(a, a_scale, w_packed, w_scale, nb, a_cols):
    for name, t in (("a", a), ("a_scale", a_scale), ("w_packed", w_packed),
                    ("w_scale", w_scale)):
        if not t.is_cuda:
            raise ValueError(f"w4ax kernel needs CUDA tensors ({name} is not)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    m, n = a.shape[0], w_packed.shape[1]
    if (a.shape[1] != a_cols or tuple(a_scale.shape) != (m, nb)
            or w_packed.shape[0] != nb * PACKED_BLOCK
            or tuple(w_scale.shape) != (nb, n)):
        raise ValueError(
            f"shape mismatch: a {tuple(a.shape)}, a_scale "
            f"{tuple(a_scale.shape)}, w_packed {tuple(w_packed.shape)}, "
            f"w_scale {tuple(w_scale.shape)}")
    if w_packed.dtype != torch.uint8 or a_scale.dtype != torch.float32 \
            or w_scale.dtype != torch.float32:
        raise ValueError("w_packed must be uint8 and the scales f32")
    if n % 4:
        raise ValueError(f"N={n} must be a multiple of 4")
    return m, n


def w4a4_matmul(a_packed, a_scale, w_packed, w_scale, *,
                conversion: str = "zeroext") -> torch.Tensor:
    """Packed int4 [M, K/2] × packed int4 [K/2, N] on the card → f32 [M, N]."""
    nb = a_scale.shape[1]
    if a_packed.dtype != torch.uint8:
        raise ValueError("a_packed must be uint8")
    m, n = _check_gemm(a_packed, a_scale, w_packed, w_scale, nb,
                       nb * PACKED_BLOCK)
    out = torch.empty((m, n), dtype=torch.float32, device=a_packed.device)
    _build.call("w4ax_matmul", "w4a4_matmul", a_packed.device, a_packed,
                a_scale, w_packed, w_scale, out, m, n, nb,
                int(conversion == "zeroext"))
    w4a4_matmul.launches += 1
    return out


def w4a8_matmul(a_q, a_scale, w_packed, w_scale, *,
                conversion: str = "zeroext") -> torch.Tensor:
    """int8 [M, K] × packed int4 [K/2, N] on the card → f32 [M, N]."""
    nb = a_scale.shape[1]
    if a_q.dtype != torch.int8:
        raise ValueError("a_q must be int8")
    m, n = _check_gemm(a_q, a_scale, w_packed, w_scale, nb, nb * BLOCK_K)
    out = torch.empty((m, n), dtype=torch.float32, device=a_q.device)
    _build.call("w4ax_matmul", "w4a8_matmul", a_q.device, a_q, a_scale,
                w_packed, w_scale, out, m, n, nb,
                int(conversion == "zeroext"))
    w4a8_matmul.launches += 1
    return out


def w4ax_matmul_mixed(a4_packed, a4_scale, a8_q, a8_scale, w_packed,
                      w_scale) -> torch.Tensor:
    """The mixed schedule on the card: ONE launch whose K loop runs the
    nb4 INT4 blocks, then the nb8 INT8 blocks, into one accumulator → f32
    [M, N]. A uniform operand launches the W4A8 or W4A4 kernel instead,
    as the reference's wrapper does."""
    nb4, nb8 = _mixed_blocks(a4_packed, a4_scale, a8_q, a8_scale)
    if nb4 == 0:
        return w4a8_matmul(a8_q, a8_scale, w_packed, w_scale)
    if nb8 == 0:
        return w4a4_matmul(a4_packed, a4_scale, w_packed, w_scale)
    if a4_packed.dtype != torch.uint8 or a8_q.dtype != torch.int8:
        raise ValueError("a4_packed must be uint8 and a8_q int8")
    m, n = _check_gemm(a4_packed, a4_scale, w_packed[:nb4 * PACKED_BLOCK],
                       w_scale[:nb4], nb4, nb4 * PACKED_BLOCK)
    if _check_gemm(a8_q, a8_scale, w_packed[nb4 * PACKED_BLOCK:],
                   w_scale[nb4:], nb8, nb8 * BLOCK_K) != (m, n):
        raise ValueError("the INT4 and INT8 parts have different row counts")
    out = torch.empty((m, n), dtype=torch.float32, device=a4_packed.device)
    _build.call("w4ax_matmul", "w4ax_matmul_mixed", a4_packed.device,
                a4_packed, a4_scale, a8_q, a8_scale, w_packed, w_scale, out,
                m, n, nb4, nb8)
    w4ax_matmul_mixed.launches += 1
    return out


w4a4_matmul.launches = 0
w4a8_matmul.launches = 0
w4ax_matmul_mixed.launches = 0


def w4ax_matmul_split(a4_packed, a4_scale, a8_q, a8_scale, w_packed, w_scale,
                      *, conversion: str = "zeroext") -> torch.Tensor:
    """Two uniform sub-GEMMs over the contiguous K4 / K8 channel ranges.
    The weight halves are row slices of one contiguous [K/2, N] array, so
    they go to the kernels without a copy."""
    nb4 = a4_scale.shape[1] if a4_packed.shape[1] else 0
    k4p = nb4 * PACKED_BLOCK
    out = None
    if nb4 > 0:
        out = w4a4_matmul(a4_packed, a4_scale, w_packed[:k4p], w_scale[:nb4],
                          conversion=conversion)
    if a8_q.shape[1] > 0:
        o8 = w4a8_matmul(a8_q, a8_scale, w_packed[k4p:], w_scale[nb4:],
                         conversion=conversion)
        out = o8 if out is None else out.add_(o8)
    if out is None:
        raise ValueError("empty GEMM")
    return out


# ----------------------------------------------------- expert-batched forms

def _check_experts(a, a_scale, w_packed, w_scale, nb, a_cols):
    """[E, M, a_cols] activations, [E, M, nb] scales (contiguous) against
    [E, nb·64, N] packed weights and [E, nb, N] scales whose rows are
    contiguous (a K-range of a whole stack is such a view) → (E, M, N,
    the weights' and their scales' expert strides)."""
    for name, t in (("a", a), ("a_scale", a_scale), ("w_packed", w_packed),
                    ("w_scale", w_scale)):
        if not t.is_cuda:
            raise ValueError(f"w4ax kernel needs CUDA tensors ({name} is not)")
        if t.dim() != 3:
            raise ValueError(f"{name} must be [E, ·, ·], got "
                             f"{tuple(t.shape)}")
    for name, t in (("a", a), ("a_scale", a_scale)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    e, m, n = a.shape[0], a.shape[1], w_packed.shape[2]
    for name, t in (("w_packed", w_packed), ("w_scale", w_scale)):
        if t.stride(2) != 1 or t.stride(1) != n:
            raise ValueError(f"{name}'s rows must be contiguous")
    if (a.shape[2] != a_cols or tuple(a_scale.shape) != (e, m, nb)
            or tuple(w_packed.shape) != (e, nb * PACKED_BLOCK, n)
            or tuple(w_scale.shape) != (e, nb, n)):
        raise ValueError(
            f"shape mismatch: a {tuple(a.shape)}, a_scale "
            f"{tuple(a_scale.shape)}, w_packed {tuple(w_packed.shape)}, "
            f"w_scale {tuple(w_scale.shape)}")
    if w_packed.dtype != torch.uint8 or a_scale.dtype != torch.float32 \
            or w_scale.dtype != torch.float32:
        raise ValueError("w_packed must be uint8 and the scales f32")
    if n % 4:
        raise ValueError(f"N={n} must be a multiple of 4")
    return e, m, n, w_packed.stride(0), w_scale.stride(0)


def w4a4_matmul_experts(a_packed, a_scale, w_packed, w_scale, *,
                        conversion: str = "zeroext") -> torch.Tensor:
    """Packed int4 [E, M, K/2] × packed int4 [E, K/2, N] on the card → f32
    [E, M, N]: K3 for every expert in one launch."""
    nb = a_scale.shape[-1]
    if a_packed.dtype != torch.uint8:
        raise ValueError("a_packed must be uint8")
    e, m, n, ws, wss = _check_experts(a_packed, a_scale, w_packed, w_scale,
                                      nb, nb * PACKED_BLOCK)
    out = torch.empty((e, m, n), dtype=torch.float32,
                      device=a_packed.device)
    _build.call("w4ax_matmul", "w4a4_matmul_experts", a_packed.device,
                a_packed, a_scale, w_packed, w_scale, out, e, m, n, nb, ws,
                wss, int(conversion == "zeroext"))
    w4a4_matmul_experts.launches += 1
    return out


def w4a8_matmul_experts(a_q, a_scale, w_packed, w_scale, *,
                        conversion: str = "zeroext") -> torch.Tensor:
    """int8 [E, M, K] × packed int4 [E, K/2, N] on the card → f32
    [E, M, N]: K4 for every expert in one launch."""
    nb = a_scale.shape[-1]
    if a_q.dtype != torch.int8:
        raise ValueError("a_q must be int8")
    e, m, n, ws, wss = _check_experts(a_q, a_scale, w_packed, w_scale, nb,
                                      nb * BLOCK_K)
    out = torch.empty((e, m, n), dtype=torch.float32, device=a_q.device)
    _build.call("w4ax_matmul", "w4a8_matmul_experts", a_q.device, a_q,
                a_scale, w_packed, w_scale, out, e, m, n, nb, ws, wss,
                int(conversion == "zeroext"))
    w4a8_matmul_experts.launches += 1
    return out


def w4ax_matmul_mixed_experts(a4_packed, a4_scale, a8_q, a8_scale, w_packed,
                              w_scale) -> torch.Tensor:
    """K5 for every expert in one launch → f32 [E, M, N]; a uniform
    operand launches the expert-batched W4A8 or W4A4 kernel instead, as
    :func:`w4ax_matmul_mixed` does."""
    nb4, nb8 = _mixed_blocks(a4_packed, a4_scale, a8_q, a8_scale)
    if nb4 == 0:
        return w4a8_matmul_experts(a8_q, a8_scale, w_packed, w_scale)
    if nb8 == 0:
        return w4a4_matmul_experts(a4_packed, a4_scale, w_packed, w_scale)
    if a4_packed.dtype != torch.uint8 or a8_q.dtype != torch.int8:
        raise ValueError("a4_packed must be uint8 and a8_q int8")
    k4p = nb4 * PACKED_BLOCK
    e, m, n, ws, wss = _check_experts(a4_packed, a4_scale, w_packed[:, :k4p],
                                      w_scale[:, :nb4], nb4, k4p)
    if _check_experts(a8_q, a8_scale, w_packed[:, k4p:], w_scale[:, nb4:],
                      nb8, nb8 * BLOCK_K)[:3] != (e, m, n):
        raise ValueError("the INT4 and INT8 parts have different shapes")
    out = torch.empty((e, m, n), dtype=torch.float32,
                      device=a4_packed.device)
    _build.call("w4ax_matmul", "w4ax_matmul_mixed_experts", a4_packed.device,
                a4_packed, a4_scale, a8_q, a8_scale, w_packed, w_scale, out,
                e, m, n, nb4, nb8, ws, wss)
    w4ax_matmul_mixed_experts.launches += 1
    return out


w4a4_matmul_experts.launches = 0
w4a8_matmul_experts.launches = 0
w4ax_matmul_mixed_experts.launches = 0


def w4ax_matmul_split_experts(a4_packed, a4_scale, a8_q, a8_scale, w_packed,
                              w_scale) -> torch.Tensor:
    """The split schedule over every expert: one expert-batched K3 over
    the K4 prefix plus one K4 over the K8 tail, summed as
    :func:`w4ax_matmul_split` sums them; the weight ranges are views of
    the stacks (rows contiguous, the expert stride the stack's)."""
    nb4 = a4_scale.shape[-1] if a4_packed.shape[-1] else 0
    k4p = nb4 * PACKED_BLOCK
    out = None
    if nb4 > 0:
        out = w4a4_matmul_experts(a4_packed, a4_scale, w_packed[:, :k4p],
                                  w_scale[:, :nb4])
    if a8_q.shape[-1] > 0:
        o8 = w4a8_matmul_experts(a8_q, a8_scale, w_packed[:, k4p:],
                                 w_scale[:, nb4:])
        out = o8 if out is None else out.add_(o8)
    if out is None:
        raise ValueError("empty GEMM")
    return out
