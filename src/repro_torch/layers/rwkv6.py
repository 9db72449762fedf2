"""RWKV-6 "Finch" block (``repro/layers/rwkv6.py``): time-mix with a
data-dependent per-channel decay, and the squared-ReLU channel-mix.

Time-mix recurrence per head (d = head_dim):
    y_t = r_t · S_{t-1}  +  (r_t ⊙ u · k_t) · v_t
    S_t = diag(w_t) · S_{t-1}  +  k_t ⊗ v_t
with w_t = exp(−exp(w0 + LoRA(x̃_t))) per channel, u the per-channel
bonus of the current token and x̃ the token-shift interpolation. A
prompt runs the chunked parallel form (within chunks a masked product
against cumulative decay products, across chunks a loop over the
``[B, H, d, d]`` state); decode is the O(1) step. The r/k/v/g/o and
channel-mix projections are W4Ax once quantized; the decay LoRA stays
f32.

Rounding follows the reference: the token-shift mix is f32 (a bf16
difference times the f32 mix coefficient); the chunked form is f32 with
each einsum's sum exact and rounded once (:func:`C.einsum_exact`), the
three-operand ones in the reference's pairwise order (u·r rounded
first), the cumulative log-decay XLA's (:func:`C.cumsum_xla`), ``exp``
and the sigmoid/SiLU XLA's. ``tanh`` of the decay LoRA is PyTorch's
(XLA's CPU ``tanh`` is another approximation, differing in the last bit
of f32). So the forms agree with the reference to the last bits of f32.
On the card the einsums are f32 and ``exp``/sigmoid PyTorch's (as in
``layers/mamba2.py``).
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.layers import common as C
from repro_torch.layers import mlp as MLP

__all__ = ["init_rwkv6", "rwkv6_train", "rwkv6_decode", "init_rwkv6_state",
           "init_rwkv6_cmix", "rwkv6_cmix"]

BF16 = torch.bfloat16
MIX = ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w")
TIME_PROJ = ("w_r", "w_k", "w_v", "w_g")


def _dims(cfg: ModelConfig):
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    return d, d // hd, hd


def _chunk(cfg: ModelConfig) -> int:
    return cfg.ssm_chunk or 128


def init_rwkv6(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    """fp time-mix parameters with the reference's distributions: the
    mix coefficients uniform in [0, 1), the five d×d projections,
    ``decay_w0`` = −6 + 0.5·normal, ``decay_A`` [d, lora] at 1/√d and
    ``decay_B`` [lora, d] at 0.01 (truncated normal), ``bonus_u``
    0.5·normal [H, hd], the LayerNorm ``ln_x``."""
    d, h, hd = _dims(cfg)
    lora = cfg.rwkv_decay_lora
    p = {m: torch.rand((d,), generator=gen, device=device) for m in MIX}
    for name in TIME_PROJ + ("w_o",):
        p[name] = C.init_linear(d, d, gen, device)
    p["decay_w0"] = -6.0 + 0.5 * torch.randn((d,), generator=gen,
                                             device=device)
    p["decay_A"] = C.trunc_normal((d, lora), 1.0 / math.sqrt(d), gen, device)
    p["decay_B"] = C.trunc_normal((lora, d), 0.01, gen, device)
    p["bonus_u"] = 0.5 * torch.randn((h, hd), generator=gen, device=device)
    p["ln_x"] = C.init_norm("layernorm", d, device)
    return p


def _token_shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """x [B, L, D], x_prev [B, 1, D] (the previous segment's last token)."""
    return torch.cat([x_prev, x[:, :-1]], 1)


def _mixed(x, xs, mu):
    """x + (xs − x)·mu: the bf16 difference, then f32 (mu is f32)."""
    return x.float() + (xs - x).float() * mu


def _projections(params, x, xs, quant):
    """r, k, v, g (bf16, one act-quant each: their inputs differ) and the
    log decay −exp(w0 + tanh(x̃_w A) B) (f32)."""
    r, k, v, g = (C.linear(params[w], _mixed(x, xs, params[m]), quant)
                  for w, m in zip(TIME_PROJ, MIX))
    xw = _mixed(x, xs, params["mu_w"])
    lora = torch.tanh(C.einsum_exact("...i,ij->...j", xw, params["decay_A"]))
    lw = params["decay_w0"] + C.einsum_exact("...i,ij->...j", lora,
                                             params["decay_B"])
    return r, k, v, g, -MLP.exp_xla(lw)


def _chunked_linear_attn(r, k, v, logw, u, chunk: int):
    """r/k/v [B, L, H, D] bf16, logw [B, L, H, D] f32, u [H, D] → (y [B,
    L, H, D] f32, final state [B, H, D, D]). A prompt not a multiple of
    the chunk is padded with logw = 0 and k = 0 (state unchanged, y 0).
    The per-step log decay is clamped at −64/Q, Q = min(chunk, L), so the
    factored 1/P_s stays in f32's range over a chunk (the reference's
    "instant forget")."""
    b, l, h, d = r.shape
    q = min(chunk, l)
    l_orig, pad = l, -l % q
    if pad:
        r, k, v, logw = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                         for t in (r, k, v, logw))
        l += pad
    nc = l // q
    rr, kk, vv = (t.reshape(b, nc, q, h, d).float() for t in (r, k, v))
    lw = torch.clamp_min(logw.reshape(b, nc, q, h, d), -64.0 / q)

    cum = C.cumsum_xla(lw, 2)                           # log P_t, inclusive
    p_in = MLP.exp_xla(cum - lw)                        # P_{t-1}
    p_out = MLP.exp_xla(cum[:, :, -1:] - cum)           # P_Q / P_t
    p_end = MLP.exp_xla(cum[:, :, -1])                  # P_Q

    rp = rr * p_in
    kp = kk * MLP.exp_xla(-cum)
    scores = C.einsum_exact("bcthd,bcshd->bchts", rp, kp)
    tri = torch.ones((q, q), dtype=torch.bool, device=r.device).tril(-1)
    scores = torch.where(tri[None, None, None], scores,
                         torch.zeros((), device=r.device))
    # (u·r first, rounded, then the sum over d with k: the reference's
    # einsum path)
    diag = C.einsum_exact("bcthd,bcthd->bcth", u * rr, kk)
    y_intra = C.einsum_exact("bchts,bcshd->bcthd", scores, vv)
    y_intra = y_intra + diag[..., None] * vv

    s_chunk = C.einsum_exact("bcshd,bcshe->bchde", kk * p_out, vv)
    s_prev = torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
    before = []
    for c in range(nc):
        before.append(s_prev)
        s_prev = s_prev * p_end[:, c, ..., None] + s_chunk[:, c]
    s_before = torch.stack(before, 1)                   # [B, NC, H, D, D]
    y_inter = C.einsum_exact("bcthd,bchde->bcthe", rp, s_before)
    y = (y_intra + y_inter).reshape(b, l, h, d)
    return y[:, :l_orig], s_prev


def _output(params, cfg, y, g, x, quant):
    """LayerNorm ``ln_x`` (f32), times SiLU(g) in f32, then ``w_o``."""
    y = C.layernorm(y, params["ln_x"]["scale"], params["ln_x"]["bias"],
                    cfg.norm_eps)
    y = y * MLP.silu_f32(g.float())
    return C.linear(params["w_o"], y.to(x.dtype), quant)


def rwkv6_train(params, cfg: ModelConfig, x: torch.Tensor, state=None,
                quant=None):
    """Time-mix and output of x [B, L, D] → (y [B, L, D] bf16, ``{"s":
    final state, "shift_tm": x's last token}``); ``state["shift_tm"]`` is
    the previous token (zeros without a state)."""
    d, h, hd = _dims(cfg)
    b, l, _ = x.shape
    x_prev = (state["shift_tm"] if state is not None
              else torch.zeros((b, 1, d), dtype=x.dtype, device=x.device))
    r, k, v, g, logw = _projections(params, x, _token_shift(x, x_prev), quant)
    y, s_final = _chunked_linear_attn(
        r.reshape(b, l, h, hd), k.reshape(b, l, h, hd),
        v.reshape(b, l, h, hd), logw.reshape(b, l, h, hd),
        params["bonus_u"], _chunk(cfg))
    out = _output(params, cfg, y.reshape(b, l, d), g, x, quant)
    return out, {"s": s_final, "shift_tm": x[:, -1:, :]}


def init_rwkv6_state(cfg: ModelConfig, batch: int, dtype=BF16,
                     device="cuda") -> dict:
    d, h, hd = _dims(cfg)
    dev = C.resolve_device(device)
    return {"s": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                             device=dev),
            "shift_tm": torch.zeros((batch, 1, d), dtype=dtype, device=dev),
            "shift_cm": torch.zeros((batch, 1, d), dtype=dtype, device=dev)}


def rwkv6_decode(params, cfg: ModelConfig, x: torch.Tensor, state: dict,
                 quant=None):
    """One token x [B, 1, D] → (y, the state with ``s`` and ``shift_tm``
    advanced). The decay is clamped at −64/``ssm_chunk``, as the train
    form's at full chunks."""
    d, h, hd = _dims(cfg)
    b = x.shape[0]
    r, k, v, g, logw = _projections(params, x, state["shift_tm"], quant)
    rr, kk, vv = (t.reshape(b, h, hd).float() for t in (r, k, v))
    w = MLP.exp_xla(torch.clamp_min(logw.reshape(b, h, hd),
                                    -64.0 / _chunk(cfg)))
    s = state["s"]
    kv = kk[..., None] * vv[..., None, :]               # [B, H, D, D]
    y = (C.einsum_exact("bhd,bhde->bhe", rr, s)
         + C.einsum_exact("bhd,bhde->bhe", params["bonus_u"] * rr, kv))
    s_new = s * w[..., None] + kv
    out = _output(params, cfg, y.reshape(b, 1, d), g, x, quant)
    return out, dict(state, s=s_new, shift_tm=x)


# ---------------------------------------------------------- channel-mix

def init_rwkv6_cmix(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    d = cfg.d_model
    return {"mu_k": torch.rand((d,), generator=gen, device=device),
            "mu_r": torch.rand((d,), generator=gen, device=device),
            "w_k": C.init_linear(d, cfg.d_ff, gen, device),
            "w_v": C.init_linear(cfg.d_ff, d, gen, device),
            "w_r": C.init_linear(d, d, gen, device)}


def rwkv6_cmix(params, cfg: ModelConfig, x: torch.Tensor,
               x_prev: torch.Tensor, quant=None):
    """x [B, L, D], x_prev [B, 1, D] → (σ(x̃_r W_r) ⊙ relu(x̃_k W_k)² W_v,
    the new shift x[:, -1:]); the sigmoid in f32 (XLA's), rounded to bf16
    before the product."""
    xs = _token_shift(x, x_prev)
    k = torch.relu(C.linear(params["w_k"], _mixed(x, xs, params["mu_k"]),
                            quant))
    kv = C.linear(params["w_v"], k * k, quant)
    rgate = MLP.sigmoid_f32(C.linear(
        params["w_r"], _mixed(x, xs, params["mu_r"]), quant).float())
    return rgate.to(x.dtype) * kv, x[:, -1:, :]
