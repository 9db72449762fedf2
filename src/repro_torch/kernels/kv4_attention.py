"""Flash-decode over a contiguous int4 KV cache (the gather baseline): the
CUDA kernel and its plain version.

Kernel: ``csrc/kv4_attention.cu`` (replaces ``repro/kernels/
kv4_attention.py`` ``kv4_decode_attention``; bound by bytes, but at decode
batch sizes by the launch; one block per (sequence, kv head) row whose
threads split the keys, the whole op in one launch — see the source
note).

The plain version takes ``compute_dtype`` like the reference's oracle:
the reference's ops run it in bf16 on its ref path (so the gather engine
matches on the CPU), while the kernel computes in f32 and is held to the
f32 plain version on the card.

Exact mode. On a CUDA tensor the plain versions of the KV4 attention
kernels (this one and K6–K9 in ``paged_attention``) accumulate every
contraction and sum in float64 and round it once to float32, and take the
float64 exponential rounded — as the kernels do — so kernel and plain
version agree bit for bit whatever order either sums in. On the CPU they
mirror the reference's float32 oracles op for op, which the port's engine
matches bit for bit there. (Differences of 1e-6 in attention outputs are
not harmless: bf16 rounding and int4 act-quant turn them into other
quantization codes, and at a near-tied logit into another token.)
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import quantizer as Q
from repro_torch.kernels import _build

__all__ = ["kv4_decode_attention_ref", "kv4_decode_attention",
           "shared_scales", "check_kv4_inputs", "exact", "contract", "exp",
           "row_sum", "softmax", "sqrt_d"]


def exact(t: torch.Tensor) -> bool:
    """Whether the plain versions run in exact mode for this tensor."""
    return t.is_cuda


def contract(spec: str, a, b, exact_mode: bool) -> torch.Tensor:
    """``torch.einsum`` of two f32 operands; in exact mode accumulated in
    float64 and rounded once."""
    if exact_mode:
        return torch.einsum(spec, a.double(), b.double()).float()
    return torch.einsum(spec, a, b)


def exp(x: torch.Tensor, exact_mode: bool) -> torch.Tensor:
    return torch.exp(x.double()).float() if exact_mode else torch.exp(x)


def row_sum(x: torch.Tensor, exact_mode: bool) -> torch.Tensor:
    """Sum over the last axis, kept; in exact mode in float64, rounded."""
    if exact_mode:
        return x.double().sum(-1, keepdim=True).float()
    return x.sum(-1, keepdim=True)


def softmax(scores: torch.Tensor, exact_mode: bool) -> torch.Tensor:
    """e = exp(s − max s), p = e / Σ e: the reference's softmax."""
    e = exp(scores - scores.amax(-1, keepdim=True), exact_mode)
    return e / row_sum(e, exact_mode)


def sqrt_d(d: int, device) -> torch.Tensor:
    """√D as the reference computes it: an f32 scalar (a tensor, so the
    division stays an IEEE division on the card too)."""
    return torch.tensor(float(d), dtype=torch.float32, device=device).sqrt()


def kv4_decode_attention_ref(q, k_packed, k_scale, k_zero, v_packed, v_scale,
                             v_zero, length: Optional[torch.Tensor] = None,
                             compute_dtype=torch.float32) -> torch.Tensor:
    """q ``[B, Hq, D]``, k/v ``[B, Hkv, T, D/2]`` uint8, scales/zeros
    ``[B, Hkv, 1, D]`` (or broadcastable), length ``[B]`` → f32
    ``[B, Hq, D]`` (reference ``ref.kv4_decode_attention_ref``: dequantize,
    round the operands to ``compute_dtype``, f32 products; keys at or past
    ``length`` score −inf)."""
    b, hq, d = q.shape
    hkv, t = k_packed.shape[1], k_packed.shape[2]
    g = hq // hkv
    ex = exact(q)

    def operand(x):           # rounded to the compute type, multiplied in f32
        return x.to(compute_dtype).float()

    k_deq = operand(Q.dequantize_kv_channelwise(k_packed, k_scale, k_zero))
    v_deq = operand(Q.dequantize_kv_channelwise(v_packed, v_scale, v_zero))
    qg = operand(q.reshape(b, hkv, g, d))
    scores = (contract("bhgd,bhtd->bhgt", qg, k_deq, ex)
              / sqrt_d(d, q.device))
    if length is not None:
        mask = (torch.arange(t, device=q.device)[None, None, None, :]
                < length.to(q.device)[:, None, None, None])
        scores = torch.where(mask, scores, float("-inf"))
    p = softmax(scores, ex)
    out = contract("bhgt,bhtd->bhgd", operand(p), v_deq, ex)
    return out.reshape(b, hq, d)


def shared_scales(scales, b: int, hkv: int, d: int):
    """The four KV scale/zero tensors as the decode kernels read them →
    (contiguous f32 tensors, batch stride in floats): ``[Hkv, D]`` with
    stride 0 when the batch shares them (``[Hkv, 1, D]``, or a broadcast
    ``[B, Hkv, 1, D]`` view), else ``[B, Hkv, D]`` with stride Hkv·D."""
    def shared(s):
        return s.dim() < 4 or s.shape[0] == 1 or s.stride(0) == 0

    if all(shared(s) for s in scales):
        return [(s[0] if s.dim() == 4 else s).reshape(hkv, d).float()
                .contiguous() for s in scales], 0
    return [torch.broadcast_to(s, (b, hkv, 1, d)).reshape(b, hkv, d).float()
            .contiguous() for s in scales], hkv * d


def check_kv4_inputs(q, k, v, d: int, what: str, g=None):
    """What every KV4 attention kernel takes: CUDA tensors, head_dim 128,
    contiguous uint8 KV; for the decode kernels (``g`` given) a GQA group
    of 1, 2, 4 or 8 query heads per kv head."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{what} kernel needs CUDA tensors ({name} is "
                             "not)")
    if d != 128:
        raise ValueError(f"the kernel is built for head_dim 128, got {d}")
    if (k.dtype != torch.uint8 or v.dtype != torch.uint8
            or not k.is_contiguous() or not v.is_contiguous()):
        raise ValueError(f"{what}: packed KV must be contiguous uint8")
    if g is not None and g not in (1, 2, 4, 8):
        raise ValueError(f"{what}: built for 1, 2, 4 or 8 query heads per "
                         f"kv head, got {g}")


def kv4_decode_attention(q, k_packed, k_scale, k_zero, v_packed, v_scale,
                         v_zero, length) -> torch.Tensor:
    """The K10 kernel: same arguments as :func:`kv4_decode_attention_ref`
    (``length`` required), computed in f32. Hq/Hkv ∈ {1, 2, 4, 8}."""
    b, hq, d = q.shape
    hkv, t = k_packed.shape[1], k_packed.shape[2]
    k_packed, v_packed = k_packed.contiguous(), v_packed.contiguous()
    check_kv4_inputs(q, k_packed, v_packed, d, "kv4_decode_attention",
                     hq // hkv)
    (ks, kz, vs, vz), sstride = shared_scales(
        (k_scale, k_zero, v_scale, v_zero), b, hkv, d)
    q = q.float().contiguous()
    length = length.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((b, hq, d), dtype=torch.float32, device=q.device)
    _build.call("kv4_attention", "kv4_decode_attention", q.device, q,
                k_packed, v_packed, ks, kz, vs, vz, sstride, length, out, b,
                hkv, hq // hkv, t, d)
    kv4_decode_attention.launches += 1
    return out


kv4_decode_attention.launches = 0
