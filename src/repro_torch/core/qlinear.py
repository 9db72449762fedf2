"""QLinear — the W4Ax projection of the serving path (``repro/core/
qlinear.py``, the W4Ax branch of ``_dispatch_qlinear``).

Online: quantize the INT4 and INT8 channel ranges of the activation on
the fly (two act-quant launches) and run the W4Ax GEMM under the
configured schedule: ``split`` (the default: W4A4 and W4A8 kernels over
the two ranges, summed) or ``mixed`` (the paper's single kernel whose K
loop switches precision per block). The channel order is the identity
(``quantize_linear_fraction``'s synthetic plan: no permutation); the INT8
tail is the trailing ``K − K4`` channels with
``K4 = round(int4_fraction · K/128) · 128``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops

BLOCK_K = 128

__all__ = ["QLinearSpec", "qlinear_apply", "dispatch_qlinear", "BLOCK_K"]


@dataclasses.dataclass(frozen=True)
class QLinearSpec:
    """Static metadata for one quantized projection."""

    k: int
    n: int
    k4: int                      # leading channels in W4A4 (multiple of 128)
    schedule: str = "split"      # split | mixed
    impl: str = "auto"

    @property
    def k8(self) -> int:
        return self.k - self.k4


def qlinear_apply(spec: QLinearSpec, qparams, x: torch.Tensor) -> torch.Tensor:
    """x: [..., K] float → [..., N] in x's dtype."""
    in_dtype = x.dtype
    lead = x.shape[:-1]
    dev = x.device
    if spec.k4 > 0:
        a4, s4 = ops.act_quant(x[..., :spec.k4], bits=4, impl=spec.impl)
    else:
        a4 = torch.zeros((*lead, 0), dtype=torch.uint8, device=dev)
        s4 = torch.zeros((*lead, 0), dtype=torch.float32, device=dev)
    if spec.k8 > 0:
        a8, s8 = ops.act_quant(x[..., spec.k4:], bits=8, impl=spec.impl)
    else:
        a8 = torch.zeros((*lead, 0), dtype=torch.int8, device=dev)
        s8 = torch.zeros((*lead, 0), dtype=torch.float32, device=dev)
    out = ops.w4ax_matmul(a4, s4, a8, s8, qparams["w_packed"],
                          qparams["w_scale"], schedule=spec.schedule,
                          impl=spec.impl)
    return out.to(in_dtype)


def dispatch_qlinear(params, x: torch.Tensor, quant) -> torch.Tensor:
    """A packed projection under a quant config (``int4_fraction``,
    ``schedule``, ``impl``) → :func:`qlinear_apply`."""
    k = 2 * params["w_packed"].shape[-2]
    nb = k // BLOCK_K
    nb4 = max(0, min(nb, int(round(quant.int4_fraction * nb))))
    spec = QLinearSpec(k=k, n=params["w_packed"].shape[-1],
                       k4=nb4 * BLOCK_K, schedule=quant.schedule,
                       impl=quant.impl)
    return qlinear_apply(spec, params, x)
