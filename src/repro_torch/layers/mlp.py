"""Dense MLP (``repro/layers/mlp.py`` ``mlp_apply``): SwiGLU, or the
non-gated tanh-GELU of StarCoder2."""

from __future__ import annotations

import torch

from repro_torch.layers import common as C

__all__ = ["mlp_apply", "silu_bf16", "gelu_bf16"]

_BF16_TINY = torch.finfo(torch.bfloat16).tiny
# the constants of jax.nn.gelu(approximate=True), rounded to bf16 as JAX
# rounds them for a bf16 input (np.sqrt(2/π).astype(dtype); the weakly
# typed 0.044715 takes the array's dtype)
_GELU_C = float(torch.tensor(0.7978845608028654, dtype=torch.bfloat16))
_GELU_K = float(torch.tensor(0.044715, dtype=torch.bfloat16))


def silu_bf16(x: torch.Tensor) -> torch.Tensor:
    """SiLU as the reference's XLA computes it in bf16: x · 1/(1+e^{−x})
    with a bf16 rounding after every op. A fused silu rounds once and
    differs in the last bit often enough to flip the int4 codes of the
    down projection's act-quant."""
    return x * (1 / (torch.exp(-x) + 1))


def _round(y: torch.Tensor) -> torch.Tensor:
    """An f32 result → bf16 as XLA's CPU rounds one bf16 op: subnormal
    results flushed to (signed) zero first, then one rounding."""
    return torch.where(y.abs() < _BF16_TINY, y * 0, y).to(torch.bfloat16)


def gelu_bf16(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x)`` (tanh form) on bf16 as the reference computes:
    x·(0.5·(1 + tanh(c·(x + k·x³)))) with x³ = x·(x·x) (``integer_pow``),
    c and k rounded to bf16, every op in f32 and rounded to bf16 after it,
    subnormal operands and results flushed to zero. Bit for bit on every
    finite bf16 input; ``F.gelu(approximate="tanh")`` differs on ~1,500 of
    them, and a differing bit moves the down projection's act-quant
    codes."""
    def r(y):
        return _round(y).float()

    x = r(x.float())
    x3 = r(x * r(x * x))
    inner = r(_GELU_C * r(x + r(_GELU_K * x3)))
    cdf = r(0.5 * r(1.0 + r(torch.tanh(inner))))
    return _round(x * cdf)


def mlp_apply(params, x: torch.Tensor, quant=None,
              act: str = "swiglu") -> torch.Tensor:
    """SwiGLU (up and gate share one act-quant of x) or, under ``act=
    "gelu"``, GELU of the up projection; then the down projection."""
    if act == "swiglu":
        up, gate = C.linears([params["w_up"], params["w_gate"]], x, quant)
        h = silu_bf16(gate) * up
    elif act == "gelu":
        h = gelu_bf16(C.linear(params["w_up"], x, quant))
    else:
        raise ValueError(act)
    return C.linear(params["w_down"], h, quant)
