"""Attention pieces of the serving step (``repro/layers/attention.py``):
the q/k/v projection with RoPE and the fp causal attention used when no
row of a step has paged history (plain PyTorch in f32; the reference's is
jnp too, not a Pallas kernel)."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.layers import common as C

NEG_INF = -1e30

__all__ = ["project_qkv", "flash_attention"]


def project_qkv(params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, quant=None, num_heads=None,
                num_kv_heads=None):
    """x: [B, S, d_model] → q [B, S, Hq, D], k/v [B, S, Hkv, D] (bf16,
    RoPE applied to q and k); the three projections share one act-quant
    of x. Under ``cfg.qk_norm`` q and k are RMS-normalized over head_dim
    (``q_norm``/``k_norm`` scales) before RoPE, as the reference's
    ``_project_qkv``; the mean sums in f64 on the card, as every norm's
    does (``common.row_mean``). ``num_heads``/``num_kv_heads`` override
    the config's head counts (a tensor-parallel rank's local heads)."""
    b = x.shape[0]
    hq = num_heads or cfg.num_heads
    hkv = num_kv_heads or cfg.num_kv_heads
    q, k, v = C.linears([params["wq"], params["wk"], params["wv"]], x, quant)
    q = q.reshape(b, -1, hq, cfg.head_dim)
    k = k.reshape(b, -1, hkv, cfg.head_dim)
    v = v.reshape(b, -1, hkv, cfg.head_dim)
    if cfg.qk_norm:
        q = C.rmsnorm(q, params["q_norm"]["scale"], cfg.norm_eps)
        k = C.rmsnorm(k, params["k_norm"]["scale"], cfg.norm_eps)
    return (C.apply_rope(q, positions, cfg.rope_theta),
            C.apply_rope(k, positions, cfg.rope_theta), v)


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Causal: q [B, S, H, D], k/v [B, T, Hkv, D] → f32 [B, S, H, D]; GQA
    by head groups, masked scores at the finite NEG_INF like the
    reference."""
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    sm = float(torch.tensor(float(d)).sqrt().reciprocal())
    qs = (q.float() * sm).reshape(b, s, hkv, g, d)
    sc = torch.einsum("bqhgd,bkhd->bhgqk", qs, k.float())
    mask = (torch.arange(s, device=q.device)[:, None]
            >= torch.arange(t, device=q.device)[None, :])
    sc = torch.where(mask, sc, NEG_INF)
    m = sc.amax(-1, keepdim=True)
    p = torch.exp(sc - m)
    out = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    out = out / p.sum(-1, keepdim=True).clamp_min(1e-20)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)
