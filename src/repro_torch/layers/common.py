"""Shared layer primitives (``repro/layers/common.py``): RMSNorm,
LayerNorm, RoPE and the linear dispatch (packed W4 params → W4Ax; plain
``w`` → bf16 matmul), one projection at a time or several of one input
sharing its act-quant.

Rounding points follow the reference: norms and RoPE compute in f32 and
return the input dtype; every projection returns bf16 (a plain ``w``
projection adds its bias ``b`` in bf16, a packed one in f32 before its
one cast).

Over a training mesh's model axis (``parallel/sharding.py``): a
column-parallel projection is :func:`linear` on the rank's columns of its
input's ``fanout``; a row-parallel one (:func:`row_linear`: ``wo``,
``w_down``) sums the ranks' f32 partial products in rank order, adds its
bias once and rounds to bf16 once; the embedding looks up by vocabulary
range (:func:`vocab_embed`) and the head gathers its vocabulary columns
(:func:`vocab_head`). On an axis of one rank each is the one-device op.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import qlinear as QL
from repro_torch.parallel import sharding as SH

__all__ = ["row_mean", "rmsnorm", "layernorm", "apply_norm",
           "rope_frequencies", "apply_rope", "linear", "linears",
           "row_linear", "vocab_embed", "vocab_head",
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


class _MatmulF32(torch.autograd.Function):
    """x [..., K] @ w [K, N], bf16 operands → f32: exact products summed
    in f32 (on the card one cuBLAS call with f32 output; on the CPU f64
    sums rounded once, as :func:`bmm_f32`). The backward is a bf16
    matmul's: dx = dy·wᵀ and dw = xᵀ·dy in bf16 (the gradient of a
    result rounded to bf16 afterwards is bf16-exact)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        x2 = x.reshape(-1, x.shape[-1])
        y = (torch.mm(x2, w, out_dtype=torch.float32) if x.is_cuda
             else (x2.double() @ w.double()).float())
        return y.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(torch.bfloat16)
        dx = g @ w.t()
        dw = x.reshape(-1, x.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
        return dx, dw


def row_linear(params, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """A row-parallel fp projection over the mesh's model axis: this
    rank's K-slice ``x`` times its rows of ``w`` in f32, the ranks'
    partials summed in rank order (``SH.reduce_sum``), the bias added
    once, one rounding to bf16. Without a model axis :func:`linear`."""
    if mesh is None or mesh.size == 1:
        return linear(params, x)
    y = _MatmulF32.apply(x.to(torch.bfloat16),
                         params["w"].to(torch.bfloat16))
    y = SH.reduce_sum(y, mesh, "model")
    if "b" in params:
        y = y + params["b"].float()
    return y.to(torch.bfloat16)


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor, mesh=None):
    """The bf16 embedding of ``tokens``. Over the mesh's model axis
    ``table`` is this rank's vocabulary rows: a token outside them looks
    up −0.0, and the ranks' lookups are summed in rank order — x + (−0) =
    x, so the result is the one-device lookup bit for bit."""
    if mesh is None or mesh.size == 1:
        return table[tokens].to(torch.bfloat16)
    n = table.shape[0]
    local = tokens - mesh.model_rank * n
    inside = (local >= 0) & (local < n)
    rows = torch.where(inside[..., None], table[local.clamp(0, n - 1)],
                       table.new_full((), -0.0))
    return SH.reduce_sum(rows, mesh, "model").to(torch.bfloat16)


def vocab_head(w: torch.Tensor, x: torch.Tensor, mesh=None):
    """f32 logits of ``x`` under the head ``w`` [d, V]. Over the mesh's
    model axis ``w`` holds this rank's vocabulary columns: each rank's
    bf16 logits, gathered along the vocabulary (whose backward is this
    rank's slice: the loss after it runs alike on every rank), then
    f32."""
    if mesh is None or mesh.size == 1:
        return linear({"w": w}, x).float()
    y = linear({"w": w}, SH.fanout(x, mesh, "model"))
    return SH.gather_cols(y, mesh, "slice").float()


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
