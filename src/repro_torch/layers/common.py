"""Shared layer primitives (``repro/layers/common.py``): RMSNorm,
LayerNorm, RoPE and the linear dispatch (packed W4 params → W4Ax; plain
``w`` → bf16 matmul), one projection at a time or several of one input
sharing its act-quant.

Rounding points follow the reference: norms and RoPE compute in f32 and
return the input dtype; every projection returns bf16 (a plain ``w``
projection adds its bias ``b`` in bf16, a packed one in f32 before its
one cast).
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import qlinear as QL

__all__ = ["row_mean", "rmsnorm", "layernorm", "apply_norm",
           "rope_frequencies", "apply_rope", "linear", "linears",
           "resolve_device", "no_tf32", "trunc_normal", "init_linear",
           "init_norm", "einsum_exact", "bmm_f32", "cumsum_xla"]


def resolve_device(device) -> torch.device:
    """An explicit device; a CUDA request without a card raises rather
    than sliding onto the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was requested but none is "
                           "available; pass device='cpu' explicitly")
    return dev


def no_tf32() -> None:
    """The port's f32 products (attention pre-fold, no-history flash
    attention, plain kernel versions) must run in full f32, as on the
    reference: turn TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def row_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis, kept, of an f32 tensor. On the card it is
    an f64 sum rounded once: PyTorch's f32 reduction there sums a row in
    an order that depends on the tensor around it (a row's norm then
    differs from batch to batch, measured on the H100 in ``chip_smoke.py
    --phases specdiag``), while an f64 sum of these f32 values is exact
    or within f64 rounding, so a row's mean no longer depends on the
    batch. On the CPU the reference's f32 mean."""
    if x.is_cuda:
        return (x.double().sum(-1, keepdim=True) / x.shape[-1]).float()
    return x.mean(-1, keepdim=True)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    var = row_mean(x * x)
    return (x * torch.rsqrt(var + eps) * scale).to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = row_mean(x)
    var = row_mean((x - mu) ** 2)
    return ((x - mu) * torch.rsqrt(var + eps) * scale + bias).to(dt)


def apply_norm(params, x: torch.Tensor, kind: str, eps: float = 1e-5):
    """The config's norm (``ModelConfig.norm``) with its parameters."""
    if kind == "rmsnorm":
        return rmsnorm(x, params["scale"], eps)
    return layernorm(x, params["scale"], params["bias"], eps)


def rope_frequencies(head_dim: int, theta: float, device=None):
    """1/θ^(i/half) in f32. The power is taken in f64 and rounded once:
    the reference's f32 ``theta ** e`` is the correctly rounded power,
    which an f32 ``torch.pow`` misses by one ulp on some exponents (one of
    64 at θ = 10⁶, head_dim 128)."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    theta32 = torch.tensor(theta, dtype=torch.float32, device=device)
    return 1.0 / torch.pow(theta32.double(), exps.double()).float()


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: [..., S, H, D]; positions broadcastable to [..., S]."""
    d = x.shape[-1]
    half = d // 2
    freqs = rope_frequencies(d, theta, x.device)
    ang = positions[..., :, None].float() * freqs        # [..., S, half]
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def linear(params, x: torch.Tensor, quant=None) -> torch.Tensor:
    if "w_packed" in params:
        return QL.dispatch_qlinear(params, x, quant).to(torch.bfloat16)
    y = x.to(torch.bfloat16) @ params["w"].to(torch.bfloat16)
    if "b" in params:
        y = y + params["b"].to(torch.bfloat16)
    return y


def linears(params_list, x: torch.Tensor, quant=None) -> list:
    """Projections of one input, in order; packed W4 ones share the
    quantization of ``x`` (:func:`QL.qlinear_apply_many`) unless the
    quant config is weight-only."""
    if all("w_packed" in p for p in params_list) and not quant.weight_only:
        specs = [QL.qlinear_spec(p, quant) for p in params_list]
        return [y.to(torch.bfloat16)
                for y in QL.qlinear_apply_many(specs, params_list, x)]
    return [linear(p, x, quant) for p in params_list]


# ------------------------------------------------------------- init

def trunc_normal(shape, scale: float, gen: torch.Generator, device):
    """f32 normal truncated to [-2, 2], times ``scale`` (the reference's
    ``dense_init``)."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(scale)


def init_linear(d_in: int, d_out: int, gen: torch.Generator, device,
                bias: bool = False, scale: float | None = None) -> dict:
    """``{"w": f32 [d_in, d_out]}`` (scale 1/√d_in unless given), with a
    zero bias ``"b"`` if asked: the reference's ``init_linear``."""
    p = {"w": trunc_normal((d_in, d_out), 1.0 / math.sqrt(d_in)
                           if scale is None else scale, gen, device)}
    if bias:
        p["b"] = torch.zeros(d_out, device=device)
    return p


def init_norm(kind: str, d: int, device) -> dict:
    """Scale 1 over ``d`` channels (any width: Mamba2's gated norm is over
    its inner width), and a zero bias under ``"layernorm"``."""
    p = {"scale": torch.ones(d, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(d, device=device)
    return p


# ------------------------------------------- the reference's f32 sums

def einsum_exact(spec: str, *ops: torch.Tensor) -> torch.Tensor:
    """The reference's f32 einsums and its bf16 ones under
    ``preferred_element_type=float32`` (products of bf16 values exact in
    f32, an f32 sum), which XLA sums in its own order. On the CPU, where
    the port is held to the reference, the operands (f32 or bf16) are
    widened to f64, multiplied and summed there and rounded once to f32:
    the result does not depend on the order, and agrees with XLA's to the
    last bit or two of f32. PyTorch's bf16 ``einsum`` would round its
    result to bf16. On the card, where no reference runs, the einsum runs
    in f32 (TF32 off, :func:`no_tf32`): no f64 copies of the operands."""
    if ops[0].is_cuda:
        return torch.einsum(spec, *(o.float() for o in ops))
    return torch.einsum(spec, *(o.double() for o in ops)).float()


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [N, M, K] @ b [N, K, L] of bf16 operands → f32 [N, M, L], exact
    products and f32 sums: the reference's bf16 einsums under
    ``preferred_element_type=float32``. On the card one cuBLAS call that
    reads the bf16 operands as they are (``out_dtype``), on the CPU f64
    sums rounded once (:func:`einsum_exact`)."""
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.double(), b.double()).float()


_SCAN_BASE = 16


def cumsum_xla(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.cumsum`` of f32 as XLA's CPU computes it, bit for bit: along
    ``dim`` in blocks of 16, a sequential f32 sum within each block, the
    blocks' totals scanned the same way (recursively), each block's
    exclusive carry added to its partial sums. ``torch.cumsum`` sums in
    f64 on the CPU and in a parallel order on the card."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n <= _SCAN_BASE:
        out = x.clone()
        for j in range(1, n):
            out[..., j] = out[..., j - 1] + x[..., j]
        return out.movedim(-1, dim)
    pad = -n % _SCAN_BASE
    xp = torch.nn.functional.pad(x, (0, pad))
    loc = cumsum_xla(xp.reshape(*x.shape[:-1], -1, _SCAN_BASE), -1)
    inc = cumsum_xla(loc[..., -1], -1)
    carry = torch.cat([torch.zeros_like(inc[..., :1]), inc[..., :-1]], -1)
    out = (loc + carry[..., None]).reshape(xp.shape)[..., :n]
    return out.movedim(-1, dim)
