"""Dense and MoE language models (``repro/models/lm.py``, dense and moe
families): parameters, PTQ (plan-free, or with per-input FMPQ plans), and
the model's own forward over a contiguous cache::

    lm = LM(cfg, quant=None | QuantConfig(...))
    params = lm.init(seed, device)                # packed W4 (LM.quantize)
    cache = lm.init_cache(batch, max_len, device) # int4 (kv4) or bf16
    logits, cache = lm.prefill(params, tokens, cache)   # [B, 1, V] f32
    logits, cache = lm.decode(params, tokens, cache)    # tokens [B, 1]
    logits, aux = lm.train_logits(params, tokens)       # [B, S, V] f32

The forward walks the layers in a Python loop (the reference scans
them); ``quant=None`` runs fp params (``{"w"}`` projections, bf16
``torch.matmul``) and a bf16 cache. The serving engine
(``serving/engine.py``) has its own paged forward and reads only
``embed``/``head`` from here.

Parameters are plain dictionaries shaped like the reference's tree, with
the layer stack as a Python list of per-layer dicts instead of a stacked
leading axis (the engine walks layers in a Python loop)::

    {"embed": {"table": bf16 [V, d]}, "final_norm": {"scale": f32 [d]},
     "lm_head": {"w": bf16 [d, V]},
     "blocks": [{"attn_norm": {"scale"}, "attn": {"wq", "wk", "wv", "wo"},
                 "mlp_norm": {"scale"}, "mlp": {"w_up", "w_gate",
                 "w_down"}}, ...]}

where each projection is ``{"w": f32 [K, N]}`` before :meth:`LM.quantize`
and ``{"w_packed": uint8 [K/2, N], "w_scale": f32 [K/128, N]}`` after.
:meth:`LM.axes` gives the tree of logical axes the reference's init
annotates (``"embed"``, ``"qdim"``, ``"kvdim"``, ``"mlp"``, ``"vocab"``),
per layer without the reference's leading ``"layers"``: tensor-parallel
serving shards by them (``parallel/sharding.py``), and ``LM.init(...,
mesh=)`` builds one rank's shard block by block.
The config adds: a ``"bias"`` to every norm under ``norm="layernorm"``, an
f32 ``"b"`` [N] to ``wq``/``wk``/``wv`` under ``qkv_bias`` (kept through
quantization), ``attn.q_norm``/``attn.k_norm`` (RMSNorm scales over
head_dim, axes ``(None,)``) under ``qk_norm``, and no ``w_gate`` under
``mlp_act="gelu"``. An MoE block (``family="moe"``) has ``"moe"`` where a
dense one has ``"mlp"``::

    {"router": {"w": f32 [d, E]},             # stays f32, bf16 at use
     "w_gate": {"w": f32 [E, d, F]}, "w_up": {"w": f32 [E, d, F]},
     "w_down": {"w": f32 [E, F, d]},          # packed [E, K/2, N] stacks
     "shared": {"w_up", "w_gate", "w_down"}}  # num_shared_experts > 0

with the expert stacks' axes ``("experts", "embed", "mlp")`` and
``("experts", "mlp", "embed")``, the router's ``("embed", "experts")``.
Random weights follow the reference's initializers (truncated normal in
[-2, 2] scaled by 1/√fan_in, fan_in being the first dimension — so
1/√E for an expert stack, as ``dense_init`` gives it; unit-scale
embedding; norm scales 1, norm and projection biases 0) from a seeded
``torch.Generator`` — the same distribution, not the same numbers.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import qlinear as QL
from repro_torch.core import quantizer as Q
from repro_torch.layers import attention as ATT
from repro_torch.layers import common as C
from repro_torch.layers import mlp as MLP
from repro_torch.parallel import sharding as SH

__all__ = ["LM", "QuantConfig", "QUANT_KEYS"]


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    int4_fraction: float = 0.875     # W4A4 block fraction (rest is W4A8)
    schedule: str = "split"          # split | mixed (paper baseline)
    impl: str = "auto"               # kernel impl: auto | cuda | ref
    kv4: bool = True                 # LM.init_cache: int4 cache vs bf16
    weight_only: bool = False        # W4A16: dequantized bf16 weights

    def __post_init__(self):
        if self.schedule not in ("split", "mixed"):
            raise ValueError(
                f"schedule must be split|mixed, got {self.schedule}")


QUANT_KEYS = frozenset({"wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down"})
FAMILIES = ("dense", "moe")
# the reference's logical axes of each projection's [K, N] weight
PROJ_AXES = {"wq": ("embed", "qdim"), "wk": ("embed", "kvdim"),
             "wv": ("embed", "kvdim"), "wo": ("qdim", "embed"),
             "w_up": ("embed", "mlp"), "w_gate": ("embed", "mlp"),
             "w_down": ("mlp", "embed")}
# an MoE block's router and expert stacks (its shared experts: PROJ_AXES)
MOE_AXES = {"router": ("embed", "experts"),
            "w_gate": ("experts", "embed", "mlp"),
            "w_up": ("experts", "embed", "mlp"),
            "w_down": ("experts", "mlp", "embed")}


class LM:
    def __init__(self, cfg: ModelConfig, quant: QuantConfig | None = None):
        """``quant``: the projections' runtime (fraction, schedule,
        ``impl``) and the cache kind; ``None`` for fp params, whose
        packed projections (if any) then take ``QuantConfig()``, as the
        reference's default runtime. The engine keeps its own."""
        if cfg.family not in FAMILIES:
            raise ValueError(
                f"only the {'/'.join(FAMILIES)} families are ported, got "
                f"{cfg.family!r} (the other families: ROADMAP Queue 1 "
                "item 6)")
        self.cfg = cfg
        self.quant = quant
        self._rt = quant if quant is not None else QuantConfig()

    # ------------------------------------------------------------ init

    @staticmethod
    def _trunc_normal(shape, scale, gen, device):
        w = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return w.mul_(scale)

    def _linear(self, d_in, d_out, gen, device, bias=False):
        p = {"w": self._trunc_normal((d_in, d_out), 1.0 / math.sqrt(d_in),
                                     gen, device)}
        if bias:
            p["b"] = torch.zeros(d_out, device=device)
        return p

    def _norm(self, device) -> dict:
        d = self.cfg.d_model
        p = {"scale": torch.ones(d, device=device)}
        if self.cfg.norm == "layernorm":
            p["bias"] = torch.zeros(d, device=device)
        return p

    def _mlp(self, d_ff: int, act: str, gen, device) -> dict:
        d = self.cfg.d_model
        mlp = {"w_up": self._linear(d, d_ff, gen, device),
               "w_down": self._linear(d_ff, d, gen, device)}
        if act == "swiglu":
            mlp["w_gate"] = self._linear(d, d_ff, gen, device)
        return mlp

    def _moe(self, gen, device) -> dict:
        """The router, the expert stacks (scaled by 1/√E: the reference's
        ``dense_init`` takes the stack's first dimension as fan-in) and
        the shared experts, as ``repro/layers/mlp.py`` ``init_moe``."""
        cfg = self.cfg
        d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
        se = 1.0 / math.sqrt(max(1, e))
        p = {"router": self._linear(d, e, gen, device),
             "w_gate": {"w": self._trunc_normal((e, d, f), se, gen, device)},
             "w_up": {"w": self._trunc_normal((e, d, f), se, gen, device)},
             "w_down": {"w": self._trunc_normal((e, f, d), se, gen, device)}}
        if cfg.num_shared_experts:
            p["shared"] = self._mlp(f * cfg.num_shared_experts, "swiglu",
                                    gen, device)
        return p

    def init_block(self, gen: torch.Generator, device) -> dict:
        """One fp block (f32 weights) on ``device``; the FFN's weights are
        drawn first, then the attention's (a seed gives the dense blocks
        it always gave)."""
        cfg = self.cfg
        d, qb = cfg.d_model, cfg.qkv_bias
        ffn = (("moe", self._moe(gen, device)) if cfg.family == "moe" else
               ("mlp", self._mlp(cfg.d_ff, cfg.mlp_act, gen, device)))
        attn = {"wq": self._linear(d, cfg.q_dim, gen, device, qb),
                "wk": self._linear(d, cfg.kv_dim, gen, device, qb),
                "wv": self._linear(d, cfg.kv_dim, gen, device, qb),
                "wo": self._linear(cfg.q_dim, d, gen, device)}
        if cfg.qk_norm:
            for name in ("q_norm", "k_norm"):
                attn[name] = {"scale": torch.ones(cfg.head_dim,
                                                  device=device)}
        return {"attn_norm": self._norm(device), "attn": attn,
                "mlp_norm": self._norm(device), ffn[0]: ffn[1]}

    def init_top(self, gen: torch.Generator, device) -> dict:
        """The fp embedding (f32), final norm and head, drawn first from
        ``gen`` (then :meth:`init_block` once per layer): :meth:`init`'s
        order, so a caller drawing blocks itself gets :meth:`init`'s
        weights before quantization."""
        cfg = self.cfg
        return {"embed": {"table": self._trunc_normal(
                    (cfg.vocab_size, cfg.d_model), 1.0, gen, device)},
                "final_norm": self._norm(device),
                "lm_head": self._linear(cfg.d_model, cfg.vocab_size, gen,
                                        device)}

    def init(self, seed: int = 0, device="cuda", mesh=None):
        """Random quantized parameters on ``device``, generated layer by
        layer: each block is made in f32, quantized, and its f32 weights
        freed before the next, so peak memory is one fp block plus the
        packed model. With a ``mesh`` (a tensor-parallel rank's) every
        rank draws the same blocks from the seed and keeps its shard of
        each under ``SERVE_RULES`` (the embedding and head whole)."""
        dev = C.resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        cfg = self.cfg
        params = self.quantize({**self.init_top(gen, dev), "blocks": []})
        for _ in range(cfg.num_layers):
            block = self.quantize_block(self.init_block(gen, dev))
            if mesh is not None:
                block = SH.shard_tree(block, SH.tree_pspecs(
                    self._block_axes(block), block, mesh, SH.SERVE_RULES),
                    mesh)
            params["blocks"].append(block)
            del block
        return params

    # ---------------------------------------------------- logical axes

    @staticmethod
    def _block_axes(tree: dict, proj_axes=PROJ_AXES) -> dict:
        out = {}
        for k, v in tree.items():
            if k in proj_axes:
                out[k] = {n: (proj_axes[k][-1],) if n == "b" else proj_axes[k]
                          for n in v}
            elif k == "moe":
                out[k] = {n: LM._block_axes(sub) if n == "shared"
                          else LM._block_axes({n: sub}, MOE_AXES)[n]
                          for n, sub in v.items()}
            elif k in ("q_norm", "k_norm"):     # over head_dim
                out[k] = {n: (None,) for n in v}
            elif isinstance(v, dict):
                out[k] = LM._block_axes(v)
            else:                       # a norm's scale or bias
                out[k] = ("embed",)
        return out

    def axes(self, params: dict) -> dict:
        """The logical axes of every tensor of ``params`` (fp or packed,
        the reference's ``LM.quantize`` → ``qaxes`` without ``"layers"``):
        a packed projection's ``w_packed`` and ``w_scale`` take its
        weight's ``(K, N)`` axes, its bias ``b`` the N axis, norms
        ``("embed",)``, the embedding ``("vocab", "embed")`` and the head
        ``("embed", "vocab")``."""
        return {
            "embed": {"table": ("vocab", "embed")},
            "final_norm": {k: ("embed",) for k in params["final_norm"]},
            "lm_head": {k: ("embed", "vocab") if k == "w" else ("vocab",)
                        for k in params["lm_head"]},
            "blocks": [self._block_axes(b) for b in params["blocks"]],
        }

    # ------------------------------------------------------ offline PTQ

    def quantize_block(self, block: dict, plans: dict | None = None) -> dict:
        """Replace every projection ``{"w"}`` of a block whose K is whole
        128-blocks by packed W4 (its bias ``b``, if any, kept in f32); an
        expert stack ``[E, K, N]`` expert by expert. The router is not a
        projection of ``QUANT_KEYS``: it stays f32. ``plans``: an FMPQ
        plan per projection name of the block's attention or dense MLP
        (``"wq"``, ``"w_up"``, …; projections of one input share their
        input's plan): those are built by ``qlinear.quantize_linear``
        (rows permuted, ``"perm"`` kept; one tensor per distinct
        permutation, compared on the host, so the projections of one
        input share one act-quant)."""
        plans = plans or {}
        perms: dict = {}

        def planned(key, w):
            plan = plans[key]
            qp, _ = QL.quantize_linear(w, plan)
            qp["perm"] = perms.setdefault(plan.perm.tobytes(), qp["perm"])
            return qp

        def tx(tree):
            out = {}
            for key, val in tree.items():
                if key in QUANT_KEYS and "w" in val \
                        and val["w"].shape[-2] % QL.BLOCK_K == 0:
                    if key in plans and val["w"].dim() == 2:
                        out[key] = planned(key, val["w"])
                    else:
                        packed, scale = Q.quantize_weight_int4(val["w"])
                        out[key] = {"w_packed": packed, "w_scale": scale}
                    if "b" in val:
                        out[key]["b"] = val["b"]
                elif isinstance(val, dict):
                    out[key] = tx(val)
                else:
                    out[key] = val
            return out
        return tx(block)

    def quantize(self, params: dict, plans: list | None = None) -> dict:
        """fp params → packed W4 params; the embedding table and the head
        are stored bf16 (unquantized, as in the reference). Their axes:
        :meth:`axes`. ``plans``: one :meth:`quantize_block` plan dict per
        layer."""
        out = dict(params)
        out["embed"] = {"table": params["embed"]["table"].to(torch.bfloat16)}
        out["lm_head"] = {"w": params["lm_head"]["w"].to(torch.bfloat16)}
        plans = plans or [None] * len(params["blocks"])
        out["blocks"] = [self.quantize_block(b, p)
                         for b, p in zip(params["blocks"], plans)]
        return out

    # ---------------------------------------------------- embed / head

    def embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"]["table"][tokens].to(torch.bfloat16)

    def head(self, params, x: torch.Tensor) -> torch.Tensor:
        return C.linear(params["lm_head"], x).float()

    # ------------------------------------------------ the model's forward

    def init_cache(self, batch: int, max_len: int, device="cuda") -> dict:
        """``{"attn": [one cache per layer]}``: the packed int4 cache
        (``attention.init_q4_cache``, default static range) under a quant
        config with ``kv4``, else the bf16 one."""
        if self.quant is not None and self.quant.kv4:
            make = ATT.init_q4_cache
        else:
            make = ATT.init_fp_cache
        return {"attn": [make(self.cfg, batch, max_len, device=device)
                         for _ in range(self.cfg.num_layers)]}

    def _block(self, bp, x, mode: str, cache, aux):
        """One layer (``_attn_mlp_block``): norm, attention (``train``,
        ``prefill`` or ``decode`` over the int4 or bf16 cache), residual,
        norm, the MLP or the MoE layer (its aux added), residual."""
        cfg, rt = self.cfg, self._rt
        h = C.apply_norm(bp["attn_norm"], x, cfg.norm, cfg.norm_eps)
        new_cache = None
        q4 = cache is not None and "k_packed" in cache
        if mode == "train":
            a = ATT.attention_train(bp["attn"], cfg, h, quant=rt)
        elif mode == "prefill":
            fn = ATT.attention_prefill_q4 if q4 else ATT.attention_prefill
            a, new_cache = fn(bp["attn"], cfg, h, cache, quant=rt)
        elif q4:
            a, new_cache = ATT.attention_decode_q4(bp["attn"], cfg, h, cache,
                                                   rt, impl=rt.impl)
        else:
            a, new_cache = ATT.attention_decode_fp(bp["attn"], cfg, h, cache,
                                                   rt)
        x = x + a
        h = C.apply_norm(bp["mlp_norm"], x, cfg.norm, cfg.norm_eps)
        if "moe" in bp:
            y, l_aux = MLP.moe_apply(bp["moe"], h, cfg, rt)
            aux = aux + l_aux
        else:
            y = MLP.mlp_apply(bp["mlp"], h, rt, cfg.mlp_act)
        return x + y, new_cache, aux

    def _layers(self, params, x, mode: str, cache=None):
        if x.is_cuda:
            C.no_tf32()
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        caches = []
        for li, bp in enumerate(params["blocks"]):
            c = cache["attn"][li] if cache is not None else None
            x, nc, aux = self._block(bp, x, mode, c, aux)
            caches.append(nc)
        return x, ({"attn": caches} if cache is not None else None), aux

    def _final(self, params, x):
        return C.apply_norm(params["final_norm"], x, self.cfg.norm,
                            self.cfg.norm_eps)

    @torch.no_grad()
    def train_hidden(self, params, tokens: torch.Tensor):
        """The backbone up to and with the final norm → (hidden [B, S, d]
        bf16, aux). A forward only: no autograd, no checkpointing."""
        x, _, aux = self._layers(params, self.embed(params, tokens), "train")
        return self._final(params, x), aux

    @torch.no_grad()
    def train_logits(self, params, tokens: torch.Tensor):
        """tokens [B, S] → (logits [B, S, V] f32, the MoE aux loss)."""
        hidden, aux = self.train_hidden(params, tokens)
        return self.head(params, hidden), aux

    @torch.no_grad()
    def prefill(self, params, tokens: torch.Tensor, cache: dict):
        """tokens [B, S] → (the last position's logits [B, 1, V] f32, the
        cache holding the prompt's KV at [0, S) with length S)."""
        x, cache, _ = self._layers(params, self.embed(params, tokens),
                                   "prefill", cache)
        return self.head(params, self._final(params, x[:, -1:])), cache

    @torch.no_grad()
    def decode(self, params, tokens: torch.Tensor, cache: dict):
        """tokens [B, 1] → (logits [B, 1, V] f32, the cache one longer),
        each row at its own position ``cache length``."""
        x, cache, _ = self._layers(params, self.embed(params, tokens),
                                   "decode", cache)
        return self.head(params, self._final(params, x)), cache
