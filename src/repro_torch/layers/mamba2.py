"""Mamba2 / SSD block of Zamba2's backbone (``repro/layers/mamba2.py``):
the chunked state-space-duality scan of a prompt and the one-token
recurrent step.

Within chunks of Q = ``ssm_chunk`` positions the recurrence is a masked
attention-like product, across chunks a loop carries the ``[B, H, N,
P]`` state; decode is the O(1) step. d_inner = expand·d_model, H =
d_inner / ``ssm_head_dim`` (P), one B/C group of state size N =
``ssm_state``. The fused ``in_proj`` (z, x, B, C, dt) and ``out_proj``
are W4Ax projections once quantized.

Rounding follows the reference, op for op: the causal conv runs in bf16
and rounds after every product and sum; the SSD's bf16 einsums (f32
products of bf16 operands, an f32 result) become :func:`C.einsum_exact`
on the same bf16 values, rounded where the reference rounds (``g``,
``decay``, the bf16 state of the inter-chunk term); the log-decay's
cumulative sum is XLA's (:func:`C.cumsum_xla`); softplus, ``exp`` and
SiLU are the reference's formulas (``mlp.softplus_f32``, ``exp_xla``,
``silu_bf16``/``silu_f32``). Only the order of the f32 sums is not
XLA's: the forms agree with the reference to the last bits of f32, not
bit for bit. On the card, where no reference runs, the einsums are f32
and ``exp``/SiLU PyTorch's (``C.einsum_exact``, ``mlp.exp_xla``): a
decode step then dispatches a third of the ops and writes no f64
copies of the state.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.layers import common as C
from repro_torch.layers import mlp as MLP

__all__ = ["init_mamba2", "mamba2_train", "mamba2_decode",
           "init_mamba2_state"]

BF16 = torch.bfloat16


def _dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    return d_in, d_in // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state


def init_mamba2(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    """fp parameters with the reference's distributions: ``in_proj``
    ``[d, 2·d_in + 2N + H]``, ``conv_w`` 0.1·normal ``[K, d_in + 2N]``,
    ``conv_b`` 0, ``dt_bias`` = softplus⁻¹ of a log-uniform step in
    [0.001, 0.1], ``A_log`` = log(1..H), ``D`` = 1, the gated RMSNorm
    over d_in, ``out_proj`` ``[d_in, d]``."""
    d = cfg.d_model
    d_in, h, _, n = _dims(cfg)
    conv_ch = d_in + 2 * n
    in_proj = C.init_linear(d, 2 * d_in + 2 * n + h, gen, device)
    conv_w = 0.1 * torch.randn((cfg.ssm_conv, conv_ch), generator=gen,
                               device=device)
    u = torch.rand((h,), generator=gen, device=device)
    lo, hi = math.log(0.001), math.log(0.1)
    dt_bias = torch.log(torch.expm1(torch.exp(lo + (hi - lo) * u)))
    return {"in_proj": in_proj, "conv_w": conv_w,
            "conv_b": torch.zeros(conv_ch, device=device),
            "dt_bias": dt_bias,
            "A_log": torch.log(torch.arange(1, h + 1, dtype=torch.float32,
                                            device=device)),
            "D": torch.ones(h, device=device),
            "norm": C.init_norm("rmsnorm", d_in, device),
            "out_proj": C.init_linear(d_in, d, gen, device)}


def _split_proj(params, cfg: ModelConfig, u, quant):
    d_in, h, _, n = _dims(cfg)
    zxbcdt = C.linear(params["in_proj"], u, quant)     # bf16 [B, L, ·]
    return (zxbcdt[..., :d_in], zxbcdt[..., d_in:2 * d_in + 2 * n],
            zxbcdt[..., 2 * d_in + 2 * n:])


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Depthwise causal conv1d in bf16, xbc [B, L, Ch], w [K, Ch]: each
    product and each partial sum rounded to bf16 (the reference's Python
    ``sum`` over the K taps), then the bias and SiLU in bf16."""
    k, l = w.shape[0], xbc.shape[1]
    pad = torch.nn.functional.pad(xbc, (0, 0, k - 1, 0))
    wb = w.to(BF16)
    out = pad[:, :l] * wb[0]
    for i in range(1, k):
        out = out + pad[:, i:i + l] * wb[i]
    return MLP.silu_bf16(out + b.to(BF16))


def _ssd_chunked(x, dt, a_log, b_mat, c_mat, chunk: int):
    """Chunked SSD scan. x [B, L, H, P] bf16, dt [B, L, H] f32 (after
    softplus), b_mat/c_mat [B, L, N] bf16 → (y [B, L, H, P] f32, final
    state [B, H, N, P] f32). A prompt not a multiple of the chunk is
    padded with dt = 0 (decay 1, no state or output contribution)."""
    bsz, l, h, p = x.shape
    n = b_mat.shape[-1]
    q = min(chunk, l)
    l_orig, pad = l, -l % q
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        b_mat = torch.nn.functional.pad(b_mat, (0, 0, 0, pad))
        c_mat = torch.nn.functional.pad(c_mat, (0, 0, 0, pad))
        l += pad
    nc = l // q
    a = -MLP.exp_xla(a_log)                             # [H], negative
    xr = x.reshape(bsz, nc, q, h, p)
    dtr = dt.reshape(bsz, nc, q, h)
    br = b_mat.reshape(bsz, nc, q, n)
    cr = c_mat.reshape(bsz, nc, q, n)
    cums = C.cumsum_xla((dt * a).reshape(bsz, nc, q, h), 2)

    # intra-chunk: M[i, j] = exp(cums_i − cums_j)·dt_j·(C_i·B_j), j ≤ i,
    # with the reference's bf16 roundings of the decay, C·B and M
    seg = cums[:, :, :, None, :] - cums[:, :, None, :, :]
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    decay = torch.where(tri[None, None, :, :, None], MLP.exp_xla(seg),
                        torch.zeros((), device=x.device)).to(BF16)
    g = C.einsum_exact("bcin,bcjn->bcij", cr, br).to(BF16)
    m = g[..., None] * decay * dtr[:, :, None].to(BF16)
    y_intra = C.einsum_exact("bcijh,bcjhp->bcihp", m, xr)

    # chunk-final states: S_c = Σ_j exp(cums_Q − cums_j)·dt_j · B_j ⊗ x_j
    dec_end = MLP.exp_xla(cums[:, :, -1:] - cums)
    sc = C.einsum_exact("bcjh,bcjn,bcjhp->bchnp", (dec_end * dtr).to(BF16),
                        br, xr)
    chunk_decay = MLP.exp_xla(cums[:, :, -1])           # [B, NC, H]
    s_prev = torch.zeros((bsz, h, n, p), dtype=torch.float32,
                         device=x.device)
    before = []
    for c in range(nc):
        before.append(s_prev)
        s_prev = s_prev * chunk_decay[:, c, :, None, None] + sc[:, c]
    s_before = torch.stack(before, 1)                   # [B, NC, H, N, P]

    # inter-chunk: y_i += exp(cums_i)·(C_i · S_prev); the reference
    # (opt_einsum's path at these widths) forms exp(cums_i)·C_i exactly
    # first, then sums over N against the bf16 state
    y_inter = C.einsum_exact("bcih,bcin,bchnp->bcihp",
                             MLP.exp_xla(cums).to(BF16), cr,
                             s_before.to(BF16))
    y = (y_intra + y_inter).reshape(bsz, l, h, p)
    return y[:, :l_orig], s_prev


def mamba2_train(params, cfg: ModelConfig, u: torch.Tensor, quant=None,
                 return_state: bool = False):
    """u [B, L, d_model] bf16 → [B, L, d_model] bf16 (also the prefill's
    forward); with ``return_state`` also ``{"ssm": f32 [B, H, N, P],
    "conv": bf16 [B, K − 1, d_in + 2N]}`` (the last K − 1 conv inputs)."""
    d_in, h, p, n = _dims(cfg)
    bsz, l, _ = u.shape
    z, xbc_raw, dt = _split_proj(params, cfg, u, quant)
    xbc = _causal_conv(xbc_raw, params["conv_w"], params["conv_b"])
    x = xbc[..., :d_in].reshape(bsz, l, h, p)
    b_mat = xbc[..., d_in:d_in + n]
    c_mat = xbc[..., d_in + n:]
    dt = MLP.softplus_f32(dt.float() + params["dt_bias"])
    y, s_final = _ssd_chunked(x, dt, params["A_log"], b_mat, c_mat,
                              cfg.ssm_chunk)
    y = y.to(u.dtype) + params["D"].to(u.dtype)[None, None, :, None] * x
    y = C.rmsnorm(y.reshape(bsz, l, d_in), params["norm"]["scale"],
                  cfg.norm_eps)
    y = y * MLP.silu_bf16(z)
    out = C.linear(params["out_proj"], y.to(u.dtype), quant)
    if return_state:
        return out, {"ssm": s_final,
                     "conv": xbc_raw[:, -(cfg.ssm_conv - 1):, :]}
    return out


def init_mamba2_state(cfg: ModelConfig, batch: int, device="cuda") -> dict:
    d_in, h, p, n = _dims(cfg)
    dev = C.resolve_device(device)
    return {"ssm": torch.zeros((batch, h, n, p), dtype=torch.float32,
                               device=dev),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_in + 2 * n),
                                dtype=BF16, device=dev)}


def mamba2_decode(params, cfg: ModelConfig, u: torch.Tensor, state: dict,
                  quant=None):
    """One token u [B, 1, d_model] → (out [B, 1, d_model], the new state):
    the conv over the state's K − 1 inputs and this one in f32, the SSM
    recurrence S ← S·e^{dt·A} + dt·B ⊗ x in f32 (dt·B formed first, as
    the reference's einsum path does), y = C·S + D·x."""
    d_in, h, p, n = _dims(cfg)
    bsz = u.shape[0]
    z, xbc, dt = _split_proj(params, cfg, u, quant)
    conv_in = torch.cat([state["conv"].to(xbc.dtype), xbc], 1)  # [B, K, Ch]
    out = (C.einsum_exact("bkc,kc->bc", conv_in.float(), params["conv_w"])
           + params["conv_b"])
    xbc_t = MLP.silu_f32(out)                                   # [B, Ch]
    x = xbc_t[:, :d_in].reshape(bsz, h, p)
    b_mat = xbc_t[:, d_in:d_in + n]
    c_mat = xbc_t[:, d_in + n:]
    dt_t = MLP.softplus_f32(dt[:, 0].float() + params["dt_bias"])
    dec = MLP.exp_xla(dt_t * -MLP.exp_xla(params["A_log"])[None, :])
    dtb = b_mat[:, :, None] * dt_t[:, None, :]                  # [B, N, H]
    s = (state["ssm"] * dec[:, :, None, None]
         + dtb.permute(0, 2, 1)[..., None] * x[:, :, None, :])
    y = C.einsum_exact("bn,bhnp->bhp", c_mat, s)
    y = y + params["D"][None, :, None] * x
    y = C.rmsnorm(y.reshape(bsz, 1, d_in), params["norm"]["scale"],
                  cfg.norm_eps)
    y = y * MLP.silu_f32(z.float())
    out = C.linear(params["out_proj"], y.to(u.dtype), quant)
    return out, {"ssm": s, "conv": conv_in[:, 1:]}
