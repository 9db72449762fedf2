"""QLinear — the W4Ax projection of the serving path (``repro/core/
qlinear.py`` ``_dispatch_qlinear``), and its W4A16 weight-only branch.

Online, in two steps: quantize the activation's INT4 and INT8 channel
ranges on the fly (:func:`quantize_act`, one act-quant launch for both),
then run the W4Ax GEMM under the configured schedule
(:func:`qlinear_gemm`): ``split`` (the default: W4A4 and W4A8 kernels
over the two ranges, summed) or ``mixed`` (the paper's single kernel whose
K loop switches precision per block). The INT8 tail is the trailing
``K − K4`` channels with ``K4 = round(int4_fraction · K/128) · 128``, K
being the projection's own (under tensor parallelism a row-parallel
shard's K-slice, so K4 is rounded per shard).

Channel order. A projection built by :func:`quantize_linear` from an
FMPQ plan (``core/fmpq.py``) carries ``"perm"`` [K] int32: its weight
rows are permuted, and the activation's last axis is gathered by
``perm`` (``index_select``, the reference's ``jnp.take``) before the
fused act-quant, so the plan's outlier channels land in the INT8 tail.
Without ``"perm"`` the order is the identity (:func:`quantize_linear_
fraction`, ``LM.quantize``). As in the reference's dispatcher, K4 of a
dispatched projection comes from ``quant.int4_fraction``, not from the
plan: only a direct :func:`qlinear_apply` with :func:`quantize_linear`'s
spec uses the plan's ``k4``.

Projections of one input share its quantization
(:func:`qlinear_apply_many`) when their specs agree on ``(k, k4, impl)``
and they carry the same permutation tensor or none: act-quant is a
deterministic per-row function, so the codes are the ones each would
compute alone. The test is identity, never content, so the forward reads
nothing back from the card: ``LM.quantize_block`` and
``convert.params_from_jax`` give a block's equal permutations one tensor,
compared on the host offline (equal but separate tensors quantize the
input once each). ``out_dtype`` overrides only the output's
cast: the act-quant still sees the input in its own dtype, and a
row-parallel shard keeps its f32 partial sums for the cross-rank sum.

An MoE layer's expert stack (``w_packed [E, K/2, N]``, ``w_scale [E,
K/128, N]``) takes activations ``[E, C, K]``, expert e's rows through
expert e's weights (the reference's ``jax.vmap``): act-quant is per row,
so one act-quant launch covers all E·C rows, and the GEMM is one
expert-batched launch per kernel (``ops.w4ax_matmul_experts``). An
expert stack carries no permutation (the reference builds none).

Under ``weight_only`` (W4A16, the reference's baseline;
:func:`weight_only_linear`) the weight is dequantized to bf16 and
multiplied with the bf16 activation; the reference has no Pallas kernel
for it, and neither does the port: a bf16 ``torch.matmul``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import fmpq
from repro_torch.core import quantizer as Q
from repro_torch.kernels import ops

BLOCK_K = fmpq.BLOCK_K

__all__ = ["QLinearSpec", "QuantAct", "qlinear_spec", "quantize_act",
           "qlinear_gemm", "qlinear_apply", "qlinear_apply_many",
           "quantize_linear", "quantize_linear_fraction",
           "dispatch_qlinear", "weight_only_linear", "BLOCK_K"]


@dataclasses.dataclass(frozen=True)
class QLinearSpec:
    """Static metadata for one quantized projection."""

    k: int
    n: int
    k4: int                      # leading channels in W4A4 (multiple of 128)
    has_perm: bool = False       # gather x by params["perm"] first
    schedule: str = "split"      # split | mixed
    impl: str = "auto"

    @property
    def k8(self) -> int:
        return self.k - self.k4


@dataclasses.dataclass(frozen=True)
class QuantAct:
    """One activation quantized for the W4Ax GEMM (leading dims kept):
    packed int4 codes and scales of channels [0, k4), int8 codes and
    scales of [k4, K), and the input's dtype, which the projection
    returns."""

    a4: torch.Tensor
    s4: torch.Tensor
    a8: torch.Tensor
    s8: torch.Tensor
    dtype: torch.dtype


def quantize_act(spec: QLinearSpec, x: torch.Tensor,
                 perm: torch.Tensor | None = None) -> QuantAct:
    """x: [..., K] float → its two channel ranges quantized, after the
    gather of its last axis by ``perm`` where the spec has one."""
    dtype = x.dtype
    if spec.has_perm:
        if perm is None or perm.dim() != 1:
            raise ValueError("a permuted projection needs its [K] perm (an "
                             "expert stack carries none)")
        x = x.index_select(-1, perm)
    return QuantAct(*ops.act_quant_w4ax(x, spec.k4, impl=spec.impl),
                    dtype=dtype)


def qlinear_gemm(spec: QLinearSpec, qparams, qa: QuantAct,
                 out_dtype=None) -> torch.Tensor:
    """The W4Ax GEMM of a quantized activation → [..., N] in its dtype
    (or ``out_dtype``); a projection's f32 bias ``b`` is added to the f32
    GEMM output before that one cast (under the split schedule
    ``(K3 + K4) + b``). An expert stack takes ``[E, C, ·]`` codes."""
    gemm = (ops.w4ax_matmul_experts if qparams["w_packed"].dim() == 3
            else ops.w4ax_matmul)
    out = gemm(qa.a4, qa.s4, qa.a8, qa.s8, qparams["w_packed"],
               qparams["w_scale"], schedule=spec.schedule, impl=spec.impl)
    if "b" in qparams:
        out = out + qparams["b"]
    return out.to(out_dtype or qa.dtype)


def qlinear_apply(spec: QLinearSpec, qparams, x: torch.Tensor,
                  out_dtype=None) -> torch.Tensor:
    """x: [..., K] float → [..., N] in x's dtype (or ``out_dtype``)."""
    return qlinear_gemm(spec, qparams, quantize_act(spec, x, _perm(spec,
                                                                  qparams)),
                        out_dtype)


def _perm(spec: QLinearSpec, qparams):
    return qparams.get("perm") if spec.has_perm else None


def qlinear_apply_many(specs, qparams_list, x: torch.Tensor) -> list:
    """Several projections of one input → their outputs, in order; ``x``
    is quantized once per distinct ``(k, k4, impl)`` and permutation
    tensor among the specs."""
    acts: list = []
    outs = []
    for spec, qparams in zip(specs, qparams_list):
        key, perm = (spec.k, spec.k4, spec.impl), _perm(spec, qparams)
        qa = next((a for k, p, a in acts
                   if k == key and p is perm), None)
        if qa is None:
            qa = quantize_act(spec, x, perm)
            acts.append((key, perm, qa))
        outs.append(qlinear_gemm(spec, qparams, qa))
    return outs


def quantize_linear(w: torch.Tensor, plan: fmpq.FMPQPlan,
                    config: fmpq.FMPQConfig = fmpq.FMPQConfig(), *,
                    schedule: str = "split", impl: str = "auto"):
    """fp ``[K, N]`` weight + its input's FMPQ plan → (qparams
    ``{w_packed, w_scale, perm}``, spec with the plan's ``k4``)."""
    k, n = w.shape
    packed, scale = fmpq.apply_fmpq_to_weight(w, plan, config)
    qparams = {"w_packed": packed, "w_scale": scale,
               "perm": torch.from_numpy(plan.perm.astype("int32"))
               .to(w.device)}
    return qparams, QLinearSpec(k=k, n=n, k4=plan.k4, has_perm=True,
                                schedule=schedule, impl=impl)


def quantize_linear_fraction(w: torch.Tensor, int4_fraction: float = 0.875,
                             config: fmpq.FMPQConfig = fmpq.FMPQConfig(), *,
                             schedule: str = "split", impl: str = "auto"):
    """Plan-free variant: identity channel order, the INT8 tail the
    trailing ``K − round(f·K/128)·128`` channels → (qparams ``{w_packed,
    w_scale}``, spec)."""
    k, n = w.shape
    packed, scale = Q.quantize_weight_int4(
        w, group_size=config.weight_group_size,
        clip_ratio=config.weight_clip_ratio)
    return ({"w_packed": packed, "w_scale": scale},
            QLinearSpec(k=k, n=n, k4=_k4(k, int4_fraction),
                        schedule=schedule, impl=impl))


def _k4(k: int, int4_fraction: float) -> int:
    nb = k // BLOCK_K
    return max(0, min(nb, int(round(int4_fraction * nb)))) * BLOCK_K


def qlinear_spec(params, quant) -> QLinearSpec:
    """The spec of a packed projection under a quant config
    (``int4_fraction``, ``schedule``, ``impl``): K4 from the config's
    fraction even when the params carry a plan's ``"perm"``, as the
    reference's dispatcher computes it."""
    k = 2 * params["w_packed"].shape[-2]
    return QLinearSpec(k=k, n=params["w_packed"].shape[-1],
                       k4=_k4(k, quant.int4_fraction),
                       has_perm="perm" in params, schedule=quant.schedule,
                       impl=quant.impl)


def weight_only_linear(params, x: torch.Tensor,
                       out_dtype=None) -> torch.Tensor:
    """W4A16: the packed weight (or expert stack) dequantized per
    128-block in f32 and cast to bf16, ``x`` in bf16 times it, the bias
    added in bf16 → bf16 (or ``out_dtype``), as the reference's
    ``weight_only`` branch. A planned projection (``"perm"``) is refused:
    that branch multiplies the permuted rows by the unpermuted input."""
    if "perm" in params:
        raise ValueError("W4A16 over FMPQ-planned params is not ported: "
                         "the reference's weight-only branch ignores "
                         "'perm' (ROADMAP caveats)")
    w = Q.dequantize_weight_int4(params["w_packed"], params["w_scale"],
                                 BLOCK_K).to(torch.bfloat16)
    out = x.to(torch.bfloat16) @ w
    if "b" in params:
        out = out + params["b"].to(torch.bfloat16)
    return out if out_dtype is None else out.to(out_dtype)


def dispatch_qlinear(params, x: torch.Tensor, quant,
                     out_dtype=None) -> torch.Tensor:
    """A packed projection under a quant config → :func:`qlinear_apply`,
    or :func:`weight_only_linear` under ``quant.weight_only``."""
    if quant.weight_only:
        return weight_only_linear(params, x, out_dtype)
    return qlinear_apply(qlinear_spec(params, quant), params, x, out_dtype)
