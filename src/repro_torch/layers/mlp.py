"""Dense SwiGLU MLP (``repro/layers/mlp.py`` ``mlp_apply``)."""

from __future__ import annotations

import torch

from repro_torch.layers import common as C

__all__ = ["mlp_apply"]


def silu_bf16(x: torch.Tensor) -> torch.Tensor:
    """SiLU as the reference's XLA computes it in bf16: x · 1/(1+e^{−x})
    with a bf16 rounding after every op. A fused silu rounds once and
    differs in the last bit often enough to flip the int4 codes of the
    down projection's act-quant."""
    return x * (1 / (torch.exp(-x) + 1))


def mlp_apply(params, x: torch.Tensor, quant=None) -> torch.Tensor:
    """SwiGLU; up and gate share one act-quant of x."""
    up, gate = C.linears([params["w_up"], params["w_gate"]], x, quant)
    return C.linear(params["w_down"], silu_bf16(gate) * up, quant)
