"""Public wrappers around the ported kernels (``repro/kernels/ops.py``).

Every op takes ``impl`` ∈ {"auto", "cuda", "ref"}:

* ``auto`` — a CUDA tensor launches the kernel, a CPU tensor takes the
  plain version;
* ``cuda`` — the kernel; a CPU tensor raises;
* ``ref``  — the plain version, on whatever device the tensor is.

A kernel that fails to build or launch raises; nothing falls back.

Shape policy: ``[..., K]`` activations are flattened to ``[M, K]`` and the
result reshaped back. Unlike the Pallas wrappers, nothing is padded to a
tile multiple: the CUDA kernels mask their ragged edge themselves.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import act_quant as AQ
from repro_torch.kernels import kv4_attention as KA
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import w4ax_matmul as WK

BLOCK_K = WK.BLOCK_K

__all__ = ["act_quant", "act_quant_w4ax", "w4ax_matmul", "w4ax_matmul_experts",
           "paged_kv4_prefill_attention_wq", "paged_kv4_prefill_attention",
           "paged_kv4_decode_attention", "paged_kv4_decode_attention_wq",
           "kv4_decode_attention",
           "combine_plan", "work_plan", "use_kernel", "KERNELS"]

# every kernel wrapper of the ported path, by the name its launch count is
# reported under
KERNELS = {
    "act_quant_w4ax": AQ.act_quant_w4ax,
    "act_quant_int4": AQ.act_quant_int4,
    "act_quant_int8": AQ.act_quant_int8,
    "w4a4_matmul": WK.w4a4_matmul,
    "w4a8_matmul": WK.w4a8_matmul,
    "w4ax_matmul_mixed": WK.w4ax_matmul_mixed,
    "w4a4_matmul_experts": WK.w4a4_matmul_experts,
    "w4a8_matmul_experts": WK.w4a8_matmul_experts,
    "w4ax_matmul_mixed_experts": WK.w4ax_matmul_mixed_experts,
    "paged_kv4_prefill_attention_wq": PA.paged_kv4_prefill_attention_wq,
    "paged_kv4_decode_attention": PA.paged_kv4_decode_attention,
    "paged_kv4_prefill_attention": PA.paged_kv4_prefill_attention,
    "paged_kv4_decode_attention_wq": PA.paged_kv4_decode_attention_wq,
    "kv4_decode_attention": KA.kv4_decode_attention,
}
combine_plan = PA.combine_plan
work_plan = PA.work_plan


def use_kernel(impl: str, t: torch.Tensor) -> bool:
    """Resolve ``impl`` for a tensor: True → launch the CUDA kernel."""
    if impl == "auto":
        return t.is_cuda
    if impl == "cuda":
        if not t.is_cuda:
            raise ValueError("impl='cuda' needs CUDA tensors; this one lies "
                             f"on {t.device}")
        return True
    if impl == "ref":
        return False
    raise ValueError(f"impl must be auto|cuda|ref, got {impl!r}")


def _rows(x: torch.Tensor) -> torch.Tensor:
    """[..., K] → [M, K], a view where the layout allows; the kernel reads
    bf16 and f32 where they lie, other types are upcast to f32 first."""
    x2 = x.reshape(-1, x.shape[-1])
    return x2 if x2.dtype in AQ.DTYPE_TAG else x2.float()


def act_quant(x: torch.Tensor, *, bits: int = 4, impl: str = "auto"):
    """[..., K] float → (payload, scales [..., K/128]); bits=4 gives
    packed uint8 [..., K/2], bits=8 int8 [..., K]. The values are
    quantized from ``x`` upcast to f32, as the reference does."""
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = _rows(x)
    if use_kernel(impl, x2):
        kern = AQ.act_quant_int4 if bits == 4 else AQ.act_quant_int8
        payload, scale = kern(x2)
    else:
        payload, scale = AQ.act_quant_ref(x2.float(), block_size=BLOCK_K,
                                          bits=bits)
    return (payload.reshape(*lead, payload.shape[-1]),
            scale.reshape(*lead, k // BLOCK_K))


def act_quant_w4ax(x: torch.Tensor, k4: int, *, impl: str = "auto"):
    """[..., K] float → (a4 packed uint8 [..., k4/2], s4 [..., k4/128],
    a8 int8 [..., K−k4], s8 [..., (K−k4)/128]): the int4 range [0, k4)
    and the int8 range [k4, K) of one W4Ax activation, each as
    :func:`act_quant` gives it, in one kernel launch."""
    lead = x.shape[:-1]
    x2 = _rows(x)
    fn = AQ.act_quant_w4ax if use_kernel(impl, x2) else AQ.act_quant_w4ax_ref
    return tuple(t.reshape(*lead, t.shape[-1]) for t in fn(x2, k4))


def w4ax_matmul(a4_packed, a4_scale, a8_q, a8_scale, w_packed, w_scale, *,
                schedule: str = "split", impl: str = "auto") -> torch.Tensor:
    """Mixed-precision W4Ax GEMM: dequant(a) @ dequant(w) → [..., N] f32.

    ``schedule="split"`` launches the W4A4 and W4A8 kernels over the two
    channel ranges and sums them; ``"mixed"`` launches the single mixed
    kernel. Off the kernel path a CPU tensor takes the reference oracle
    under either schedule, as the reference's ops do; a CUDA tensor under
    ``"mixed"`` takes the mixed kernel's plain version, which it matches
    bit for bit."""
    if schedule not in ("split", "mixed"):
        raise ValueError(f"schedule must be split|mixed, got {schedule}")
    lead = a4_packed.shape[:-1]
    m = math.prod(lead) if lead else 1
    n = w_packed.shape[1]
    a4p = a4_packed.reshape(m, a4_packed.shape[-1])
    a4s = a4_scale.reshape(m, a4_scale.shape[-1])
    a8q = a8_q.reshape(m, a8_q.shape[-1])
    a8s = a8_scale.reshape(m, a8_scale.shape[-1])
    if use_kernel(impl, a4p):
        fn = (WK.w4ax_matmul_mixed if schedule == "mixed"
              else WK.w4ax_matmul_split)
        out = fn(a4p, a4s, a8q, a8s, w_packed, w_scale)
    elif schedule == "mixed" and a4p.is_cuda:
        out = WK.w4ax_matmul_mixed_ref(a4p, a4s, a8q, a8s, w_packed, w_scale)
    else:
        nb4 = a4s.shape[1] if a4p.shape[1] else 0
        k4p = nb4 * WK.PACKED_BLOCK
        out = WK.w4ax_matmul_ref(a4p, a4s, a8q, a8s,
                                 w_packed[:k4p], w_scale[:nb4],
                                 w_packed[k4p:], w_scale[nb4:])
    return out.reshape(*lead, n)


def w4ax_matmul_experts(a4_packed, a4_scale, a8_q, a8_scale, w_packed,
                        w_scale, *, schedule: str = "split",
                        impl: str = "auto") -> torch.Tensor:
    """:func:`w4ax_matmul` for every expert of an MoE layer at once (the
    reference's ``jax.vmap`` over it): activations quantized as ``[E, C,
    ·]``, packed weights ``[E, K/2, N]`` and scales ``[E, K/128, N]`` → f32
    ``[E, C, N]``. On the kernel path one expert-batched launch per
    kernel of the schedule (K3 + K4, or K5); off it the per-expert plain
    versions, under the same rule as :func:`w4ax_matmul`."""
    if schedule not in ("split", "mixed"):
        raise ValueError(f"schedule must be split|mixed, got {schedule}")
    args = (a4_packed, a4_scale, a8_q, a8_scale)
    if use_kernel(impl, a4_packed):
        fn = (WK.w4ax_matmul_mixed_experts if schedule == "mixed"
              else WK.w4ax_matmul_split_experts)
        return fn(*args, w_packed, w_scale)
    if schedule == "mixed" and a4_packed.is_cuda:
        return WK.w4ax_matmul_mixed_ref(*args, w_packed, w_scale)
    nb4 = a4_scale.shape[-1] if a4_packed.shape[-1] else 0
    k4p = nb4 * WK.PACKED_BLOCK
    return WK.w4ax_matmul_ref(*args, w_packed[:, :k4p], w_scale[:, :nb4],
                              w_packed[:, k4p:], w_scale[:, nb4:])


def paged_kv4_prefill_attention_wq(q, k_new, v_new, k_pool, k_scale, k_zero,
                                   v_pool, v_scale, v_zero, work_items, *,
                                   plan=None,
                                   impl: str = "auto") -> torch.Tensor:
    """Work-queue chunked-prefill attention over int4 paged history plus
    each row's causal in-flight fp chunk → [B, C, Hq, D] f32 (rows past a
    row's q_len are padding garbage; mask outside). ``plan`` is the
    :func:`work_plan` of the descriptors (the kernel's jobs and the plain
    combine's :func:`combine_plan`), built on the host; the plain version
    also takes a bare :func:`combine_plan`. Without one the descriptors
    are read back once."""
    fn = (PA.paged_kv4_prefill_attention_wq if use_kernel(impl, q)
          else PA.paged_kv4_prefill_attention_wq_ref)
    return fn(q, k_new, v_new, k_pool, k_scale, k_zero, v_pool, v_scale,
              v_zero, work_items, plan)


def paged_kv4_prefill_attention(q, k_new, v_new, k_pool, k_scale, k_zero,
                                v_pool, v_scale, v_zero, block_tables,
                                ctx_lens, q_lens, *,
                                impl: str = "auto") -> torch.Tensor:
    """Dense-schedule chunked-prefill attention: each row's chunk queries
    over its int4 history through the block table ``[B, NP]`` (−1 =
    unmapped) plus its causal fp chunk → ``[B, C, Hq, D]`` f32 (rows past
    ``q_lens`` are finite garbage; mask outside)."""
    fn = (PA.paged_kv4_prefill_attention if use_kernel(impl, q)
          else PA.paged_kv4_prefill_attention_ref)
    return fn(q, k_new, v_new, k_pool, k_scale, k_zero, v_pool, v_scale,
              v_zero, block_tables, ctx_lens, q_lens)


def paged_kv4_decode_attention(q, k_pool, k_scale, k_zero, v_pool, v_scale,
                               v_zero, block_tables, length, *,
                               impl: str = "auto") -> torch.Tensor:
    """Dense-schedule flash-decode straight off the pools: q ``[B, Hq, D]``,
    block tables ``[B, NP]``, lengths ``[B]`` → ``[B, Hq, D]`` f32."""
    fn = (PA.paged_kv4_decode_attention if use_kernel(impl, q)
          else PA.paged_kv4_decode_attention_ref)
    return fn(q, k_pool, k_scale, k_zero, v_pool, v_scale, v_zero,
              block_tables, length)


def paged_kv4_decode_attention_wq(q, k_pool, k_scale, k_zero, v_pool,
                                  v_scale, v_zero, work_items, *, plan=None,
                                  impl: str = "auto") -> torch.Tensor:
    """Work-queue flash-decode: one partial per page item of the
    descriptors ``[W, 4]``, split-KV combine, V affine after → ``[B, Hq,
    D]`` f32. ``plan`` is the :func:`work_plan` of the descriptors at
    C = 1 (the kernel's jobs and the plain combine's :func:`combine_plan`),
    built on the host; the plain version also takes a bare
    :func:`combine_plan`. Without one the descriptors are read back
    once."""
    fn = (PA.paged_kv4_decode_attention_wq if use_kernel(impl, q)
          else PA.paged_kv4_decode_attention_wq_ref)
    return fn(q, k_pool, k_scale, k_zero, v_pool, v_scale, v_zero,
              work_items, plan)


def kv4_decode_attention(q, k_packed, k_scale, k_zero, v_packed, v_scale,
                         v_zero, length=None, *,
                         impl: str = "auto") -> torch.Tensor:
    """Flash-decode over contiguous int4 KV ``[B, Hkv, T, D/2]`` → ``[B,
    Hq, D]`` f32. On a CPU tensor the plain version computes in bf16 with
    f32 products, as the reference's ops do on their ref path; the kernel
    and the plain version on the card compute in f32."""
    if length is None:
        length = torch.full((q.shape[0],), k_packed.shape[2],
                            dtype=torch.int32, device=q.device)
    if use_kernel(impl, q):
        return KA.kv4_decode_attention(q, k_packed, k_scale, k_zero,
                                       v_packed, v_scale, v_zero, length)
    return KA.kv4_decode_attention_ref(
        q, k_packed, k_scale, k_zero, v_packed, v_scale, v_zero, length,
        compute_dtype=torch.float32 if q.is_cuda else torch.bfloat16)
