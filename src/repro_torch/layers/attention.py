"""Attention (``repro/layers/attention.py``): the q/k/v projection with
RoPE, the fp attention of training (causal, or bidirectional under
``cfg.causal = False``; cross-attention over image embeddings with
``kv_override``), of a prefill and of a serving step whose rows have no
paged history (plain PyTorch in f32; the reference's is jnp too, not a
Pallas kernel), and ``LM``'s contiguous caches:

* the bf16 cache ``{"k", "v": [B, T, Hkv, D], "length": [B]}``
  (:func:`init_fp_cache`, :func:`attention_prefill`,
  :func:`attention_decode_fp`: the decode step's softmax in plain f32);
* the packed int4 cache ``{"k_packed", "v_packed": uint8 [B, Hkv, T,
  D/2], "k_scale", "k_zero", "v_scale", "v_zero": f32 [B, Hkv, 1, D],
  "length"}`` with static per-channel scales (:func:`init_q4_cache`,
  :func:`attention_prefill_q4`: fp attention over the prompt's own k/v,
  then the packed write; :func:`attention_decode_q4`: the token's KV
  quantized and written at ``length``, then K10 over the packed cache).

The caches' tensors are updated in place and the dict returned with the
new ``length``. A decode at ``length ≥ T`` writes slot ``T − 1``, as the
reference's ``dynamic_update_slice`` clamps its start index.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import quantizer as Q
from repro_torch.kernels import kv4_attention as KA
from repro_torch.kernels import ops
from repro_torch.layers import common as C
from repro_torch.layers import mlp as MLP
from repro_torch.parallel import sharding as SH

NEG_INF = -1e30
CHUNK = 1024           # the reference's q_chunk and kv_chunk
KV_RANGE = 16.0        # init_q4_cache's default static range

__all__ = ["project_qkv", "flash_attention", "cross_kv", "cross_attention",
           "attention_train",
           "attention_prefill", "init_fp_cache", "attention_decode_fp",
           "init_q4_cache", "attention_prefill_q4", "attention_decode_q4"]


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q [B, S, H, D], k/v [B, T, Hkv, D] → f32 [B, S, H, D]; GQA by head
    groups, q scaled by 1/√D before the product, masked scores at the
    finite NEG_INF, keys in chunks of ``CHUNK`` with the reference's
    online softmax (one chunk: ``exp(s − max)·v / Σ``), queries in
    chunks of ``CHUNK`` (rows are independent)."""
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    sm = float(torch.tensor(float(d)).sqrt().reciprocal())
    qs = (q.float() * sm).reshape(b, s, hkv, g, d)
    kpos = torch.arange(t, device=q.device)
    outs = []
    for q0 in range(0, s, CHUNK):
        qc = qs[:, q0:q0 + CHUNK]
        qpos = q0 + torch.arange(qc.shape[1], device=q.device)
        m = l = acc = None
        for k0 in range(0, t, CHUNK):
            sc = torch.einsum("bqhgd,bkhd->bhgqk", qc,
                              k[:, k0:k0 + CHUNK].float())
            if causal:
                sc = torch.where(qpos[:, None] >= kpos[None, k0:k0 + CHUNK],
                                 sc, NEG_INF)
            vc = v[:, k0:k0 + CHUNK].float()
            if m is None:
                m = sc.amax(-1, keepdim=True)
                p = torch.exp(sc - m)
                acc = torch.einsum("bhgqk,bkhd->bhgqd", p, vc)
                l = p.sum(-1, keepdim=True)
            else:
                m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
                alpha = torch.exp(m - m_new)
                p = torch.exp(sc - m_new)
                acc = acc * alpha + torch.einsum("bhgqk,bkhd->bhgqd", p, vc)
                l = l * alpha + p.sum(-1, keepdim=True)
                m = m_new
        out = acc / l.clamp_min(1e-20)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, -1, h, d))
    return outs[0] if len(outs) == 1 else torch.cat(outs, 1)


def _positions(x: torch.Tensor) -> torch.Tensor:
    b, s = x.shape[:2]
    return torch.arange(s, device=x.device).expand(b, s)


def _self_attention(params, cfg: ModelConfig, x, positions, quant):
    """q/k/v of ``x`` and their attention (causal unless ``cfg.causal`` is
    false: the audio encoder's) → (the attention output in x's dtype [B,
    S, q_dim], k, v)."""
    b, s, _ = x.shape
    if positions is None:
        positions = _positions(x)
    q, k, v = project_qkv(params, cfg, x, positions, quant)
    out = flash_attention(q, k, v, causal=cfg.causal)
    return out.to(x.dtype).reshape(b, s, cfg.q_dim), k, v


def cross_kv(params, cfg: ModelConfig, img: torch.Tensor,
             quant=None) -> dict:
    """The cross-attention K and V of the image embeddings ``img`` [B,
    T_img, d_model] (bf16 ``[B, Hkv, T_img, D]``, head-major so that the
    decode step reads each head's keys as one matrix; k and v share one
    act-quant of ``img``), made once at prefill: the prompt's attention
    and the decode steps' cache read the same tensors."""
    b = img.shape[0]
    k, v = C.linears([params["wk"], params["wv"]], img, quant)
    shape = (b, -1, cfg.num_kv_heads, cfg.head_dim)
    return {n: t.reshape(shape).transpose(1, 2).to(torch.bfloat16)
            .contiguous() for n, t in (("k", k), ("v", v))}


def cross_attention(params, cfg: ModelConfig, x: torch.Tensor, ckv: dict,
                    quant=None) -> torch.Tensor:
    """q of x [B, S, d_model] over the image K/V ``ckv``
    (:func:`cross_kv`), QK-norm as the config says, no RoPE on either
    side, every key visible → the attention output in x's dtype [B, S,
    q_dim]."""
    b, s, _ = x.shape
    q = C.linear(params["wq"], x, quant).reshape(b, s, cfg.num_heads,
                                                 cfg.head_dim)
    k, v = ckv["k"].transpose(1, 2), ckv["v"].transpose(1, 2)
    if cfg.qk_norm:
        q = C.rmsnorm(q, params["q_norm"]["scale"], cfg.norm_eps)
        k = C.rmsnorm(k, params["k_norm"]["scale"], cfg.norm_eps)
    out = flash_attention(q, k, v, causal=False)
    return out.to(x.dtype).reshape(b, s, cfg.q_dim)


def attention_train(params, cfg: ModelConfig, x: torch.Tensor,
                    positions=None, quant=None, kv_override=None,
                    mesh=None, spec=None) -> torch.Tensor:
    """Self-attention of x [B, S, d_model] → [B, S, d_model] (causal as
    the config says); with ``kv_override`` [B, T, d_model] the
    cross-attention of x over it (:func:`cross_attention`). With a
    training ``mesh`` whose model axis shards ``wo`` (``spec``: the
    attention's param specs), :func:`_tp_attention`."""
    if mesh is not None and mesh.size > 1 and spec["wo"]["w"][0] == "model":
        return _tp_attention(params, cfg, x, mesh, spec)
    if kv_override is not None:
        out = cross_attention(params, cfg, x,
                              cross_kv(params, cfg, kv_override, quant), quant)
    else:
        out, _, _ = _self_attention(params, cfg, x, positions, quant)
    return C.linear(params["wo"], out, quant)


def _tp_cols(p, spec, x, x_fan, full: int, cols: tuple, mesh):
    """Output columns ``cols`` = (c0, c1) of one of q/k/v on this model
    rank. A column-sharded projection runs on ``x_fan`` (its input's
    gradient summed over the ranks); where its columns are not the ones
    this rank needs (a head count the axis does not divide) its output is
    gathered over the ranks, the gradient summed back. A replicated one
    (its width not divisible) runs whole on every rank, its output's
    gradient summed over the ranks (each rank uses its own heads)."""
    c0, c1 = cols
    if spec["w"][-1] != "model":
        y = SH.fanout(C.linear(p, x), mesh, "model")
        return y[..., c0:c1]
    y = C.linear(p, x_fan)
    n = full // mesh.size
    if (c0, c1) == (mesh.model_rank * n, (mesh.model_rank + 1) * n):
        return y
    return SH.gather_cols(y, mesh, "sum")[..., c0:c1]


def _tp_attention(params, cfg: ModelConfig, x: torch.Tensor, mesh, spec):
    """Training attention over the mesh's model axis, ``wo`` sharded over
    its K (``qdim``): this rank's Hq/M query heads and the kv heads they
    use (every head where M does not divide Hq), RoPE and the f32
    attention local; QK-norm scales' gradients summed over the ranks;
    the output's columns of this rank's ``wo`` rows into the row-parallel
    seam (:func:`common.row_linear`)."""
    b, s, _ = x.shape
    m, r, hd = mesh.size, mesh.model_rank, cfg.head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    g = hq // hkv
    h0, h1 = ((r * hq // m, (r + 1) * hq // m) if hq % m == 0 else (0, hq))
    k0, k1 = h0 // g, (h1 - 1) // g + 1
    if (h1 - h0) % g and g % (h1 - h0):
        raise NotImplementedError(
            f"{h1 - h0} query heads a rank do not cover whole kv groups of "
            f"{g} (num_heads {hq}, num_kv_heads {hkv}, model axis {m})")
    x_fan = SH.fanout(x, mesh, "model")
    q = _tp_cols(params["wq"], spec["wq"], x, x_fan, cfg.q_dim,
                 (h0 * hd, h1 * hd), mesh).reshape(b, s, h1 - h0, hd)
    k, v = (_tp_cols(params[n], spec[n], x, x_fan, cfg.kv_dim,
                     (k0 * hd, k1 * hd), mesh).reshape(b, s, k1 - k0, hd)
            for n in ("wk", "wv"))
    if cfg.qk_norm:
        q = C.rmsnorm(q, SH.fanout(params["q_norm"]["scale"], mesh),
                      cfg.norm_eps)
        k = C.rmsnorm(k, SH.fanout(params["k_norm"]["scale"], mesh),
                      cfg.norm_eps)
    pos = _positions(x)
    q = C.apply_rope(q, pos, cfg.rope_theta)
    k = C.apply_rope(k, pos, cfg.rope_theta)
    out = flash_attention(q, k, v, causal=cfg.causal).to(x.dtype)
    out = out.reshape(b, s, (h1 - h0) * hd)
    if (h0, h1) == (0, hq):          # every head here: this rank's columns
        n = cfg.q_dim // m
        out = out[..., r * n:(r + 1) * n]
    return C.row_linear(params["wo"], out, mesh)


def _check_fits(s: int, t: int):
    if s > t:
        raise ValueError(f"a prompt of {s} tokens does not fit a cache of "
                         f"{t}")


def attention_prefill(params, cfg: ModelConfig, x: torch.Tensor, cache,
                      positions=None, quant=None):
    """Causal self-attention, the prompt's k/v written to the bf16 cache
    at [0, S)."""
    s = x.shape[1]
    _check_fits(s, cache["k"].shape[1])
    out, k, v = _self_attention(params, cfg, x, positions, quant)
    cache["k"][:, :s] = k.to(cache["k"].dtype)
    cache["v"][:, :s] = v.to(cache["v"].dtype)
    length = torch.full_like(cache["length"], s)
    return C.linear(params["wo"], out, quant), dict(cache, length=length)


def init_fp_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device="cuda") -> dict:
    dev = C.resolve_device(device)
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "length": torch.zeros(batch, dtype=torch.int32, device=dev)}


def _write_slot(cache_t: torch.Tensor, new: torch.Tensor, length, axis: int):
    """Each row's ``new`` (its slot axis of size 1) into ``cache_t`` at
    ``length`` clamped to the last slot, as ``dynamic_update_slice``."""
    t = cache_t.shape[axis]
    slot = length.long().clamp(0, t - 1)
    rows = torch.arange(cache_t.shape[0], device=cache_t.device)
    index = (rows,) + (slice(None),) * (axis - 1) + (slot,)
    cache_t[index] = new.select(axis, 0).to(cache_t.dtype)


def attention_decode_fp(params, cfg: ModelConfig, x: torch.Tensor, cache,
                        quant=None):
    """One token x [B, 1, d_model] against the bf16 cache: scores in f32,
    divided by √D after the product, keys at or past the new length
    masked, the reference's f32 softmax (``mlp.softmax_f32``)."""
    b = x.shape[0]
    t = cache["k"].shape[1]
    q, k, v = project_qkv(params, cfg, x, cache["length"][:, None], quant)
    _write_slot(cache["k"], k, cache["length"], 1)
    _write_slot(cache["v"], v, cache["length"], 1)
    length = cache["length"] + 1
    g = cfg.num_heads // cfg.num_kv_heads
    qg = q[:, 0].float().reshape(b, cfg.num_kv_heads, g, cfg.head_dim)
    sc = (torch.einsum("bhgd,bThd->bhgT", qg, cache["k"].float())
          / KA.sqrt_d(cfg.head_dim, x.device))
    mask = (torch.arange(t, device=x.device)[None, None, None]
            < length[:, None, None, None])
    p = MLP.softmax_f32(torch.where(mask, sc, NEG_INF))
    out = torch.einsum("bhgT,bThd->bhgd", p, cache["v"].float())
    out = out.reshape(b, 1, cfg.q_dim).to(x.dtype)
    return C.linear(params["wo"], out, quant), dict(cache, length=length)


def init_q4_cache(cfg: ModelConfig, batch: int, max_len: int, k_stats=None,
                  v_stats=None, device="cuda") -> dict:
    """Packed int4 cache with static per-channel scale/zero. ``k_stats``/
    ``v_stats``: optional calibrated (scale, zero) ``[Hkv, 1, D]``; the
    default is scale 16/15, zero 7.5 (codes cover [−8, 8]). The scales
    are ``[B, Hkv, 1, D]`` views of one ``[Hkv, 1, D]`` tensor."""
    dev = C.resolve_device(device)
    hkv, d = cfg.num_kv_heads, cfg.head_dim

    def default():
        return (torch.full((hkv, 1, d), KV_RANGE / 15.0, device=dev),
                torch.full((hkv, 1, d), 7.5, device=dev))

    ks, kz = k_stats if k_stats is not None else default()
    vs, vz = v_stats if v_stats is not None else default()
    shape = (batch, hkv, max_len, d // 2)

    def bcast(a):
        return a.to(device=dev, dtype=torch.float32)[None].expand(
            batch, hkv, 1, d)

    return {"k_packed": torch.zeros(shape, dtype=torch.uint8, device=dev),
            "v_packed": torch.zeros(shape, dtype=torch.uint8, device=dev),
            "k_scale": bcast(ks), "k_zero": bcast(kz),
            "v_scale": bcast(vs), "v_zero": bcast(vz),
            "length": torch.zeros(batch, dtype=torch.int32, device=dev)}


def attention_prefill_q4(params, cfg: ModelConfig, x: torch.Tensor, cache,
                         positions=None, quant=None):
    """Prefill: fp causal attention over the prompt's own k/v, then its
    k/v quantized and written to the packed cache at [0, S)."""
    s = x.shape[1]
    _check_fits(s, cache["k_packed"].shape[2])
    out, k, v = _self_attention(params, cfg, x, positions, quant)
    kp, vp = Q.quantize_kv_with(k, v, cache["k_scale"], cache["k_zero"],
                                cache["v_scale"], cache["v_zero"])
    cache["k_packed"][:, :, :s] = kp
    cache["v_packed"][:, :, :s] = vp
    length = torch.full_like(cache["length"], s)
    return C.linear(params["wo"], out, quant), dict(cache, length=length)


def attention_decode_q4(params, cfg: ModelConfig, x: torch.Tensor, cache,
                        quant=None, *, impl: str = "auto"):
    """One token over the packed int4 cache (the COMET path): its k/v
    quantized and written at ``length``, then K10
    (``ops.kv4_decode_attention``) over the keys below the new length."""
    b = x.shape[0]
    q, k, v = project_qkv(params, cfg, x, cache["length"][:, None], quant)
    kp, vp = Q.quantize_kv_with(k, v, cache["k_scale"], cache["k_zero"],
                                cache["v_scale"], cache["v_zero"])
    _write_slot(cache["k_packed"], kp, cache["length"], 2)
    _write_slot(cache["v_packed"], vp, cache["length"], 2)
    length = cache["length"] + 1
    out = ops.kv4_decode_attention(
        q[:, 0], cache["k_packed"], cache["k_scale"], cache["k_zero"],
        cache["v_packed"], cache["v_scale"], cache["v_zero"], length,
        impl=impl)
    out = out.reshape(b, 1, cfg.q_dim).to(x.dtype)
    return C.linear(params["wo"], out, quant), dict(cache, length=length)
