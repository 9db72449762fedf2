"""Flash-decode over a contiguous int4 KV cache (the gather baseline): the
CUDA kernel and its plain version.

Kernel: ``csrc/kv4_attention.cu`` (replaces ``repro/kernels/
kv4_attention.py`` ``kv4_decode_attention``): the dense kernel of
``csrc/dense_attention.cuh`` that K6 runs on the page pools, reading the
contiguous ``[B, Hkv, T, D/2]`` cache instead — each key scored once on
the f64 tensor cores, the keys of one (sequence, kv head) row split over
a thread-block cluster that :func:`dense_plan` (the dense kernel's
launch planner, here for K6, K7 and K10 alike) sizes from B·Hkv and T,
the whole op in one launch. Bound by bytes, but at decode
batch sizes by the launch (see the source note).

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

from typing import NamedTuple, Optional

import torch

from repro_torch.core import quantizer as Q
from repro_torch.kernels import _build

__all__ = ["kv4_decode_attention_ref", "kv4_decode_attention",
           "shared_scales", "check_kv4_inputs", "exact", "contract", "exp",
           "row_sum", "softmax", "sqrt_d", "DensePlan", "dense_plan",
           "round_up", "HEAD_DIMS"]


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


def check_kv4_inputs(q, k, v, d: int, what: str):
    """What every KV4 attention kernel (K6–K10) takes: CUDA tensors, a
    head_dim it is built for (:data:`HEAD_DIMS`), contiguous uint8 KV. Any
    GQA group: the launch plans size the row tiles to C·G."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{what} kernel needs CUDA tensors ({name} is "
                             "not)")
    if d not in HEAD_DIMS:
        built = ", ".join(map(str, HEAD_DIMS[:-1])) + f" and {HEAD_DIMS[-1]}"
        raise ValueError(f"the kernel is built for head_dim {built}, got {d}")
    if (k.dtype != torch.uint8 or v.dtype != torch.uint8
            or not k.is_contiguous() or not v.is_contiguous()):
        raise ValueError(f"{what}: packed KV must be contiguous uint8")


class DensePlan(NamedTuple):
    """How the dense kernel (K7, K6, K10) is launched: ``rows`` query
    rows per block, ``split`` blocks (one thread-block cluster) per (b,
    kv head, row tile) sharing its keys, score rows ``sstride`` floats apart,
    ``smem`` dynamic shared bytes, and ``scratch`` floats of device
    memory for the scores when they do not fit in shared memory (else
    0)."""
    rows: int
    split: int
    sstride: int
    smem: int
    scratch: int


DENSE_KEY_TILE = 64          # keys per staged tile (csrc KT)
# the head_dims K6–K10 are instantiated for (csrc head_dim_built): the
# smoke configs' 32, the TP test model's 64, Zamba2's 80, the 8B's 128
HEAD_DIMS = (32, 64, 80, 128)


def dense_fixed_smem(d: int = 128) -> int:
    """Shared bytes of the dense kernel besides the scores at head_dim d
    (csrc ``dn_fixed``): the f64 K/V tile, two packed tiles, the page
    ids, the scales and the row partials."""
    return (DENSE_KEY_TILE * (d + 4) * 8 + 2 * DENSE_KEY_TILE * (d // 2)
            + 512 * 4 + 4 * d * 4 + 32 * 8 + (64 + 2 * 32) * 4)


DENSE_FIXED_SMEM = dense_fixed_smem(128)     # 80,640 (DN_FIXED)
DENSE_SMEM_MAX = 232448      # the H100's per-block opt-in
DENSE_SM_SMEM = 233472       # shared memory of one H100 SM
DENSE_SMS = 132
# blocks of each tile height one SM holds by its registers (4 warps at
# ≤ 128 registers; 8 warps at ≤ 128; 8 warps at ~160)
DENSE_REG_BLOCKS = {8: 4, 16: 2, 32: 1}


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def dense_plan(b: int, c: int, g: int, hkv: int, np_: int,
               ps: int, d: int = 128) -> DensePlan:
    """The dense kernel's launch for these shapes, from shapes alone (no
    device read). Rows: the smallest of 8, 16, 32 that holds C·G. Split: the
    least number of blocks per (b, h, tile) whose scores for ``NP·ps + C``
    keys fit in shared memory (at most 8, a portable cluster), widened
    while the wider grid still runs in one wave on the card and every
    block keeps a key tile. The scores go to scratch when 8 does not
    fit. ``d``: the head_dim, which sizes the fixed shared memory."""
    fixed = dense_fixed_smem(d)
    cg = c * g
    rows = 8 if cg <= 8 else 16 if cg <= 16 else 32
    blocks = b * hkv * -(-cg // rows)
    tmax = np_ * ps + c

    def stride(split):     # key columns of one block, + 8 (banks)
        per = round_up(-(-tmax // split), 8)
        return round_up(round_up(per, DENSE_KEY_TILE), 32) + 8

    def smem(split):
        return fixed + rows * stride(split) * 4

    def resident(split):   # blocks the card holds at once
        per_sm = min(DENSE_REG_BLOCKS[rows],
                     DENSE_SM_SMEM // (min(smem(split), DENSE_SMEM_MAX)
                                       + 1024))
        return DENSE_SMS * per_sm

    split = next((s for s in range(1, 9) if smem(s) <= DENSE_SMEM_MAX), 8)
    while (split < min(8, -(-tmax // DENSE_KEY_TILE))
           and blocks * (split + 1) <= resident(split + 1)):
        split += 1
    sstride = stride(split)
    if smem(split) <= DENSE_SMEM_MAX:
        return DensePlan(rows, split, sstride, smem(split), 0)
    return DensePlan(rows, split, sstride, fixed,
                     blocks * split * rows * sstride)


def kv4_decode_attention(q, k_packed, k_scale, k_zero, v_packed, v_scale,
                         v_zero, length) -> torch.Tensor:
    """The K10 kernel: same arguments as :func:`kv4_decode_attention_ref`
    (``length`` required) and its f32 result, bit for bit on the card. q
    f32 or bf16; any Hq/Hkv; a head_dim of :data:`HEAD_DIMS`; T any length
    (keys at or past ``min(length, T)`` are never read)."""
    b, hq, d = q.shape
    hkv, t = k_packed.shape[1], k_packed.shape[2]
    k_packed, v_packed = k_packed.contiguous(), v_packed.contiguous()
    check_kv4_inputs(q, k_packed, v_packed, d, "kv4_decode_attention")
    (ks, kz, vs, vz), sb = shared_scales(
        (k_scale, k_zero, v_scale, v_zero), b, hkv, d)
    q_bf16 = q.dtype == torch.bfloat16
    q = (q if q_bf16 else q.float()).contiguous()
    length = length.to(device=q.device, dtype=torch.int32).contiguous()
    plan = dense_plan(b, 1, hq // hkv, hkv, 1, t, d)   # one "page" of T keys
    scratch = (torch.empty(plan.scratch, dtype=torch.float32,
                           device=q.device) if plan.scratch else None)
    out = torch.empty((b, hq, d), dtype=torch.float32, device=q.device)
    _build.call("kv4_attention", "kv4_decode_attention", q.device, q,
                int(q_bf16), k_packed, v_packed, ks, kz, vs, vz, sb, length,
                out, scratch, b, hkv, hq // hkv, t, d, plan.rows, plan.split,
                plan.sstride, plan.smem)
    kv4_decode_attention.launches += 1
    return out


kv4_decode_attention.launches = 0
