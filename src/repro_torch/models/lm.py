"""Language models of every family (``repro/models/lm.py``): parameters,
PTQ (plan-free, or with per-input FMPQ plans for dense and moe), and the
model's own forward over a contiguous cache::

    lm = LM(cfg, quant=None | QuantConfig(...))
    params = lm.init(seed, device)                # packed W4 (LM.quantize)
    cache = lm.init_cache(batch, max_len, device) # int4 (kv4) or bf16
    logits, cache = lm.prefill(params, tokens, cache, extra)  # [B, 1, V]
    logits, cache = lm.decode(params, tokens, cache)    # tokens [B, 1]
    logits, aux = lm.train_logits(params, tokens, extra)  # [B, S, V] f32
    hidden, aux = lm.train_hidden(params, tokens, extra)  # differentiable
    fp = lm.init_fp(seed, device)      # f32 params, init's draws unquantized
    fp = lm.init_fp(seed, device, mesh)   # one training rank's shards
    specs = lm.train_specs(mesh)          # their TRAIN_RULES specs

Families: ``dense`` and ``moe`` (attention + MLP or MoE layers),
``hybrid`` (Zamba2: groups of one shared attention block, always
SwiGLU, then ``attn_period`` Mamba2 layers), ``ssm`` (RWKV-6 time-mix +
channel-mix layers), ``vlm`` (Llama-3.2-Vision: groups of
``cross_attn_period − 1`` self-attention layers and one gated
cross-attention layer over ``extra["image_embeds"]`` [B, T_img, d]) and
``audio`` (HuBERT: an encoder over ``extra["frames"]`` [B, T, d] with a
convolutional positional embedding; ``train_logits`` only). The engine
serves dense and moe; the others serve through ``prefill``/``decode``,
as in the reference.

The forward walks the layers in a Python loop (the reference scans
them); ``quant=None`` runs fp params (``{"w"}`` projections, bf16
``torch.matmul``) and a bf16 cache. ``train_hidden``/``train_logits``
are differentiable: with autograd on, each layer the reference wraps in
``jax.checkpoint`` runs under :func:`remat` (its activations recomputed
in the backward), and training (``training/train_loop.py``) takes the
gradients of the f32 params of :meth:`LM.init_fp`. ``prefill`` and
``decode`` run without autograd. The serving engine
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
mesh=)`` builds one rank's shard block by block; training over a
``(data, model)`` mesh shards the fp params by them under
``TRAIN_RULES`` (``LM.init_fp(..., mesh=)``, ``LM.train_specs``) and
``train_hidden(..., mesh=, specs=)`` runs one rank's part.
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
The other families' trees (``blocks`` a list as above)::

    hybrid: blocks [{"norm", "mamba": {"in_proj", "conv_w", "conv_b",
            "dt_bias", "A_log", "D", "norm", "out_proj"}}] × num_layers,
            "shared_attn": one dense block (SwiGLU MLP)
    ssm:    blocks [{"tm_norm", "tmix": {"mu_r", …, "w_r", "w_k", "w_v",
            "w_g", "w_o", "decay_w0", "decay_A", "decay_B", "bonus_u",
            "ln_x"}, "cm_norm", "cmix": {"mu_k", "mu_r", "w_k", "w_v",
            "w_r"}}] (both norms LayerNorm)
    vlm:    blocks [dense block] × (groups · (period − 1)),
            "cross_blocks" [{"attn_norm", "attn", "mlp_norm", "mlp",
            "gate": f32 0-d}] × groups
    audio:  "conv_pos": {"w": f32 [width, d], "b": f32 [d]} in place of
            "embed"; dense blocks

with every projection of ``QUANT_KEYS`` packed by :meth:`LM.quantize`
(``in_proj``/``out_proj``, ``w_r``/``w_k``/``w_v``/``w_g``/``w_o``);
the rest stays f32. Their caches: ``{"rwkv": [state]}``, ``{"mamba":
[state] × num_layers, "shared_attn": [cache] × groups}``, ``{"attn":
[cache] × self layers, "cross_kv": [{"k", "v": bf16 [B, Hkv, T_img,
D]}] × groups}``, ``{}`` (audio).
Random weights follow the reference's initializers (truncated normal in
[-2, 2] scaled by 1/√fan_in, fan_in being the first dimension — so
1/√E for an expert stack, as ``dense_init`` gives it; unit-scale
embedding; norm scales 1, norm and projection biases 0; the Mamba2 and
RWKV-6 parameters as ``layers/mamba2.py`` and ``layers/rwkv6.py`` say;
conv_pos 0.02·normal; the cross gate 0) from a seeded
``torch.Generator`` — the same distribution, not the same numbers.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import qlinear as QL
from repro_torch.core import quantizer as Q
from repro_torch.layers import attention as ATT
from repro_torch.layers import common as C
from repro_torch.layers import mamba2 as M2
from repro_torch.layers import mlp as MLP
from repro_torch.layers import rwkv6 as RW
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


QUANT_KEYS = frozenset({
    "wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down",
    "w_r", "w_k", "w_v", "w_g", "w_o", "in_proj", "out_proj",
})
FAMILIES = ("dense", "moe", "hybrid", "ssm", "vlm", "audio")
ENGINE_FAMILIES = ("dense", "moe")      # the paged engine's; TP, FMPQ
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
            raise ValueError(f"unknown family {cfg.family!r}; the port has "
                             f"{'/'.join(FAMILIES)}")
        self.cfg = cfg
        self.quant = quant
        self._rt = quant if quant is not None else QuantConfig()
        self.n_groups = self.self_per_group = 0
        if cfg.family == "hybrid":
            if cfg.num_layers % cfg.attn_period:
                raise ValueError("num_layers must be a multiple of "
                                 "attn_period")
            self.n_groups = cfg.num_layers // cfg.attn_period
        elif cfg.family == "vlm":
            if cfg.num_layers % cfg.cross_attn_period:
                raise ValueError("num_layers must be a multiple of "
                                 "cross_attn_period")
            self.n_groups = cfg.num_layers // cfg.cross_attn_period
            self.self_per_group = cfg.cross_attn_period - 1

    def _engine_family_only(self, what: str, item: int):
        if self.cfg.family not in ENGINE_FAMILIES:
            raise NotImplementedError(
                f"{what} covers the dense and moe families; the "
                f"{self.cfg.family} family's is not ported (ROADMAP Queue 1"
                f" item {item})")

    # ------------------------------------------------------------ init

    def _norm(self, device, kind: str | None = None) -> dict:
        return C.init_norm(kind or self.cfg.norm, self.cfg.d_model, device)

    def _mlp(self, d_ff: int, act: str, gen, device) -> dict:
        d = self.cfg.d_model
        mlp = {"w_up": C.init_linear(d, d_ff, gen, device),
               "w_down": C.init_linear(d_ff, d, gen, device)}
        if act == "swiglu":
            mlp["w_gate"] = C.init_linear(d, d_ff, gen, device)
        return mlp

    def _moe(self, gen, device) -> dict:
        """The router, the expert stacks (scaled by 1/√E: the reference's
        ``dense_init`` takes the stack's first dimension as fan-in) and
        the shared experts, as ``repro/layers/mlp.py`` ``init_moe``."""
        cfg = self.cfg
        d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
        se = 1.0 / math.sqrt(max(1, e))
        p = {"router": C.init_linear(d, e, gen, device),
             "w_gate": {"w": C.trunc_normal((e, d, f), se, gen, device)},
             "w_up": {"w": C.trunc_normal((e, d, f), se, gen, device)},
             "w_down": {"w": C.trunc_normal((e, f, d), se, gen, device)}}
        if cfg.num_shared_experts:
            p["shared"] = self._mlp(f * cfg.num_shared_experts, "swiglu",
                                    gen, device)
        return p

    def _attn(self, gen, device) -> dict:
        cfg = self.cfg
        d, qb = cfg.d_model, cfg.qkv_bias
        attn = {"wq": C.init_linear(d, cfg.q_dim, gen, device, qb),
                "wk": C.init_linear(d, cfg.kv_dim, gen, device, qb),
                "wv": C.init_linear(d, cfg.kv_dim, gen, device, qb),
                "wo": C.init_linear(cfg.q_dim, d, gen, device)}
        if cfg.qk_norm:
            for name in ("q_norm", "k_norm"):
                attn[name] = {"scale": torch.ones(cfg.head_dim,
                                                  device=device)}
        return attn

    def init_block(self, gen: torch.Generator, device) -> dict:
        """One fp block (f32 weights) on ``device`` of the layer stack
        ``blocks``: an RWKV-6 layer (ssm), a Mamba2 layer (hybrid), else
        an attention layer whose FFN's weights are drawn first, then the
        attention's (a seed gives the dense blocks it always gave)."""
        cfg = self.cfg
        if cfg.family == "ssm":
            return {"tm_norm": self._norm(device, "layernorm"),
                    "tmix": RW.init_rwkv6(cfg, gen, device),
                    "cm_norm": self._norm(device, "layernorm"),
                    "cmix": RW.init_rwkv6_cmix(cfg, gen, device)}
        if cfg.family == "hybrid":
            return {"norm": self._norm(device),
                    "mamba": M2.init_mamba2(cfg, gen, device)}
        ffn = (("moe", self._moe(gen, device)) if cfg.family == "moe" else
               ("mlp", self._mlp(cfg.d_ff, cfg.mlp_act, gen, device)))
        return {"attn_norm": self._norm(device),
                "attn": self._attn(gen, device),
                "mlp_norm": self._norm(device), ffn[0]: ffn[1]}

    def init_shared_attn(self, gen: torch.Generator, device) -> dict:
        """The hybrid's one shared attention block (its MLP always
        SwiGLU)."""
        return {"attn_norm": self._norm(device),
                "attn": self._attn(gen, device),
                "mlp_norm": self._norm(device),
                "mlp": self._mlp(self.cfg.d_ff, "swiglu", gen, device)}

    def init_cross_block(self, gen: torch.Generator, device) -> dict:
        """A VLM cross-attention block: the attention's keys as a self
        layer's, and the scalar ``gate`` (0: tanh(0) = 0, so a fresh
        model adds nothing of its image)."""
        return {"attn_norm": self._norm(device),
                "attn": self._attn(gen, device),
                "mlp_norm": self._norm(device),
                "mlp": self._mlp(self.cfg.d_ff, self.cfg.mlp_act, gen,
                                 device),
                "gate": torch.zeros((), device=device)}

    def init_top(self, gen: torch.Generator, device) -> dict:
        """The fp embedding (f32; audio: the conv positional embedding),
        final norm and head, drawn first from ``gen`` (then
        :meth:`init_block` once per layer): :meth:`init`'s order, so a
        caller drawing blocks itself gets :meth:`init`'s weights before
        quantization."""
        cfg = self.cfg
        if cfg.family == "audio":
            first = {"conv_pos": {
                "w": 0.02 * torch.randn((cfg.conv_pos_width, cfg.d_model),
                                        generator=gen, device=device),
                "b": torch.zeros(cfg.d_model, device=device)}}
        else:
            first = {"embed": {"table": C.trunc_normal(
                (cfg.vocab_size, cfg.d_model), 1.0, gen, device)}}
        return {**first, "final_norm": self._norm(device),
                "lm_head": C.init_linear(cfg.d_model, cfg.vocab_size, gen,
                                         device)}

    def _n_blocks(self) -> int:
        """Entries of ``blocks``: the VLM's self layers, else every layer."""
        return (self.n_groups * self.self_per_group
                if self.cfg.family == "vlm" else self.cfg.num_layers)

    def init_fp(self, seed: int = 0, device="cuda", mesh=None) -> dict:
        """Random fp parameters on ``device``, the reference's unquantized
        tree (f32 embedding table or conv_pos, f32 head, f32 blocks, the
        hybrid's ``shared_attn``, the VLM's ``cross_blocks``): the draws
        of :meth:`init` in its order, so ``quantize(init_fp(s))`` equals
        ``init(s)``. The parameters training updates. With a training
        ``mesh`` (dense and moe) every rank draws the same tensors and
        keeps its shard of each under ``TRAIN_RULES`` (:meth:`train_specs`),
        block by block: no rank holds the whole model."""
        dev = C.resolve_device(device)
        gen = (None if dev.type == "meta"
               else torch.Generator(device=dev).manual_seed(seed))
        if mesh is not None:
            self._engine_family_only("training over a mesh", 16)

        def keep(tree, axes):
            if mesh is None:
                return tree
            return SH.shard_tree(tree, SH.tree_pspecs(
                axes(tree), tree, mesh, SH.TRAIN_RULES), mesh)
        params = keep(self.init_top(gen, dev), self.axes)
        params["blocks"] = [keep(self.init_block(gen, dev), self._block_axes)
                            for _ in range(self._n_blocks())]
        if self.cfg.family == "hybrid":
            params["shared_attn"] = self.init_shared_attn(gen, dev)
        if self.cfg.family == "vlm":
            params["cross_blocks"] = [self.init_cross_block(gen, dev)
                                      for _ in range(self.n_groups)]
        return params

    def train_specs(self, mesh) -> dict:
        """The spec of every tensor of :meth:`init_fp`'s tree on ``mesh``
        under ``TRAIN_RULES`` (the reference's ``tree_pspecs(axes, params,
        mesh, TRAIN_RULES)``; a dimension its axis does not divide stays
        replicated), from the whole model's shapes (made on the meta
        device). Dense and moe only."""
        self._engine_family_only("training over a mesh", 16)
        full = self.init_fp(device="meta")
        return SH.tree_pspecs(self.axes(full), full, mesh, SH.TRAIN_RULES)

    def init(self, seed: int = 0, device="cuda", mesh=None):
        """Random quantized parameters on ``device``, generated layer by
        layer: each block is made in f32, quantized, and its f32 weights
        freed before the next, so peak memory is one fp block plus the
        packed model (the hybrid's shared block and the VLM's cross
        blocks after the stack). With a ``mesh`` (a tensor-parallel
        rank's; dense and moe) every rank draws the same blocks from the
        seed and keeps its shard of each under ``SERVE_RULES`` (the
        embedding and head whole)."""
        if mesh is not None:
            self._engine_family_only("LM.init(mesh=)", 16)
        dev = C.resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        cfg = self.cfg
        params = self.quantize({**self.init_top(gen, dev), "blocks": []})
        for _ in range(self._n_blocks()):
            block = self.quantize_block(self.init_block(gen, dev))
            if mesh is not None:
                block = SH.shard_tree(block, SH.tree_pspecs(
                    self._block_axes(block), block, mesh, SH.SERVE_RULES),
                    mesh)
            params["blocks"].append(block)
            del block
        if cfg.family == "hybrid":
            params["shared_attn"] = self.quantize_block(
                self.init_shared_attn(gen, dev))
        if cfg.family == "vlm":
            params["cross_blocks"] = [
                self.quantize_block(self.init_cross_block(gen, dev))
                for _ in range(self.n_groups)]
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
        ``("embed", "vocab")``; of whichever of those parts ``params``
        holds. Dense and moe only (the mesh's)."""
        self._engine_family_only("LM.axes", 16)
        top = {"embed": {"table": ("vocab", "embed")},
               "final_norm": {k: ("embed",) for k in params.get(
                   "final_norm", ())},
               "lm_head": {k: ("embed", "vocab") if k == "w" else ("vocab",)
                           for k in params.get("lm_head", ())}}
        return {k: [self._block_axes(b) for b in v] if k == "blocks"
                else top[k] for k, v in params.items()}

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
        layer (dense and moe). The hybrid's ``shared_attn`` and the VLM's
        ``cross_blocks`` are quantized as blocks."""
        if plans is not None and any(plans):
            self._engine_family_only("FMPQ planning", 17)
        out = dict(params)
        if "embed" in params:
            out["embed"] = {"table": params["embed"]["table"].to(
                torch.bfloat16)}
        out["lm_head"] = {"w": params["lm_head"]["w"].to(torch.bfloat16)}
        plans = plans or [None] * len(params["blocks"])
        out["blocks"] = [self.quantize_block(b, p)
                         for b, p in zip(params["blocks"], plans)]
        if "shared_attn" in params:
            out["shared_attn"] = self.quantize_block(params["shared_attn"])
        if "cross_blocks" in params:
            out["cross_blocks"] = [self.quantize_block(b)
                                   for b in params["cross_blocks"]]
        return out

    # ---------------------------------------------------- embed / head

    def embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"]["table"][tokens].to(torch.bfloat16)

    def head(self, params, x: torch.Tensor) -> torch.Tensor:
        return C.linear(params["lm_head"], x).float()

    # ------------------------------------------------ the model's forward

    def init_cache(self, batch: int, max_len: int, device="cuda") -> dict:
        """The family's cache (module docstring): an attention layer's is
        the packed int4 cache (``attention.init_q4_cache``, default static
        range) under a quant config with ``kv4``, else the bf16 one; the
        VLM's image KV bf16 ``[B, Hkv, num_image_tokens, D]`` (head-major;
        the reference's is ``[B, T_img, Hkv, D]``)."""
        cfg = self.cfg
        dev = C.resolve_device(device)
        make = (ATT.init_q4_cache if self.quant is not None and
                self.quant.kv4 else ATT.init_fp_cache)

        def attn(n):
            return [make(cfg, batch, max_len, device=dev) for _ in range(n)]

        fam = cfg.family
        if fam in ("dense", "moe"):
            return {"attn": attn(cfg.num_layers)}
        if fam == "ssm":
            return {"rwkv": [RW.init_rwkv6_state(cfg, batch, device=dev)
                             for _ in range(cfg.num_layers)]}
        if fam == "hybrid":
            return {"mamba": [M2.init_mamba2_state(cfg, batch, device=dev)
                              for _ in range(cfg.num_layers)],
                    "shared_attn": attn(self.n_groups)}
        if fam == "vlm":
            shape = (batch, cfg.num_kv_heads, cfg.num_image_tokens,
                     cfg.head_dim)
            return {"attn": attn(self.n_groups * self.self_per_group),
                    "cross_kv": [{n: torch.zeros(shape, dtype=torch.bfloat16,
                                                 device=dev)
                                  for n in ("k", "v")}
                                 for _ in range(self.n_groups)]}
        return {}                                    # audio: an encoder

    def _block(self, bp, x, mode: str, cache, aux, act: str | None = None,
               mesh=None, spec=None):
        """One layer (``_attn_mlp_block``): norm, attention (``train``,
        ``prefill`` or ``decode`` over the int4 or bf16 cache), residual,
        norm, the MLP (``act``, default the config's) or the MoE layer
        (its aux added), residual. ``mesh``/``spec``: a training mesh's
        model axis and the block's param specs (its seams)."""
        cfg, rt = self.cfg, self._rt
        h = C.apply_norm(bp["attn_norm"], x, cfg.norm, cfg.norm_eps)
        new_cache = None
        q4 = cache is not None and "k_packed" in cache
        if mode == "train":
            a = ATT.attention_train(bp["attn"], cfg, h, quant=rt, mesh=mesh,
                                    spec=spec and spec["attn"])
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
            y, l_aux = MLP.moe_apply(bp["moe"], h, cfg, rt, mesh=mesh,
                                     spec=spec and spec["moe"])
            aux = aux + l_aux
        else:
            y = MLP.mlp_apply(bp["mlp"], h, rt, act or cfg.mlp_act,
                              mesh=mesh, spec=spec and spec["mlp"])
        return x + y, new_cache, aux

    def _mesh_block(self, bp, spec, x, aux, mesh):
        """A training layer on one rank of ``mesh``: its params gathered
        over the data axis (``SH.gather_params``, inside :func:`remat`,
        so the backward gathers again), then :meth:`_block` with the
        model axis's seams."""
        x, _, aux = self._block(SH.gather_params(bp, spec, mesh), x, "train",
                                None, aux, mesh=mesh, spec=spec)
        return x, aux

    def _rwkv_block(self, bp, x, mode: str, c):
        """An RWKV-6 layer: LayerNorm, time-mix, residual, LayerNorm,
        channel-mix, residual. A prefill starts from the cache's shifts
        and a zero state (the reference's); decode carries all three."""
        cfg, rt = self.cfg, self._rt
        h = C.apply_norm(bp["tm_norm"], x, "layernorm", cfg.norm_eps)
        if mode == "decode":
            y, tm = RW.rwkv6_decode(bp["tmix"], cfg, h, c, rt)
        else:
            y, tm = RW.rwkv6_train(
                bp["tmix"], cfg, h,
                None if c is None else {"shift_tm": c["shift_tm"]}, rt)
        x = x + y
        h = C.apply_norm(bp["cm_norm"], x, "layernorm", cfg.norm_eps)
        x_prev = (torch.zeros((x.shape[0], 1, cfg.d_model), dtype=x.dtype,
                              device=x.device) if c is None
                  else c["shift_cm"])
        y, cm_shift = RW.rwkv6_cmix(bp["cmix"], cfg, h, x_prev, rt)
        return x + y, {"s": tm["s"], "shift_tm": tm["shift_tm"],
                       "shift_cm": cm_shift}

    def _hybrid(self, params, x, mode: str, cache):
        """Zamba2: for each group, the shared attention block (its own
        cache per group), then ``attn_period`` Mamba2 layers (state
        returned by a prefill, stepped by a decode)."""
        cfg, rt, per = self.cfg, self._rt, self.cfg.attn_period
        new = {"mamba": [], "shared_attn": []}
        for gi in range(self.n_groups):
            c = cache["shared_attn"][gi] if cache is not None else None
            x, nc, _ = self._block(params["shared_attn"], x, mode, c, 0.0,
                                   act="swiglu")
            new["shared_attn"].append(nc)
            for li in range(gi * per, (gi + 1) * per):
                c = cache["mamba"][li] if mode == "decode" else None
                x, st = remat(self._mamba_block, params["blocks"][li], x, c)
                new["mamba"].append(st)
        return x, new

    def _mamba_block(self, bp, x, c):
        """A Mamba2 layer: norm, the SSD over the sequence (state after
        its last position) or, with a state ``c``, one decode step;
        residual."""
        cfg, rt = self.cfg, self._rt
        h = C.apply_norm(bp["norm"], x, cfg.norm, cfg.norm_eps)
        if c is not None:
            y, st = M2.mamba2_decode(bp["mamba"], cfg, h, c, rt)
        else:
            y, st = M2.mamba2_train(bp["mamba"], cfg, h, rt,
                                    return_state=True)
        return x + y, st

    def _vlm(self, params, x, mode: str, cache, extra, aux):
        """Llama-3.2-Vision: for each group, its self-attention layers,
        then the gated cross-attention layer: over the image K/V,
        projected once from the embeddings (train; prefill, which also
        caches them) or read from the cache (decode), scaled by
        tanh(gate)."""
        cfg, rt, spg = self.cfg, self._rt, self.self_per_group
        img = None
        if mode != "decode":
            if extra is None or "image_embeds" not in extra:
                raise ValueError("the vlm family needs "
                                 "extra['image_embeds'] [B, T_img, d_model]")
            img = extra["image_embeds"].to(torch.bfloat16)
        new = {"attn": [], "cross_kv": []}
        for gi in range(self.n_groups):
            for li in range(gi * spg, (gi + 1) * spg):
                c = cache["attn"][li] if cache is not None else None
                x, nc, aux = remat(self._block, params["blocks"][li], x,
                                   mode, c, aux)
                new["attn"].append(nc)
            cb = params["cross_blocks"][gi]
            h = C.apply_norm(cb["attn_norm"], x, cfg.norm, cfg.norm_eps)
            if mode == "decode":
                ckv = cache["cross_kv"][gi]
                a = cross_decode(cfg, cb["attn"], h, ckv, rt)
            else:
                ckv = ATT.cross_kv(cb["attn"], cfg, img, rt)
                a = C.linear(cb["attn"]["wo"], ATT.cross_attention(
                    cb["attn"], cfg, h, ckv, rt), rt)
            new["cross_kv"].append(ckv if mode != "train" else None)
            x = x + torch.tanh(cb["gate"]).to(x.dtype) * a
            h = C.apply_norm(cb["mlp_norm"], x, cfg.norm, cfg.norm_eps)
            x = x + MLP.mlp_apply(cb["mlp"], h, rt, cfg.mlp_act)
        return x, new, aux

    def _layers(self, params, x, mode: str, cache=None, extra=None):
        if x.is_cuda:
            C.no_tf32()
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        fam = self.cfg.family
        if fam == "hybrid":
            x, new = self._hybrid(params, x, mode, cache)
        elif fam == "vlm":
            x, new, aux = self._vlm(params, x, mode, cache, extra, aux)
        elif fam == "ssm":
            new = {"rwkv": []}
            for li, bp in enumerate(params["blocks"]):
                c = cache["rwkv"][li] if cache is not None else None
                x, st = remat(self._rwkv_block, bp, x, mode, c)
                new["rwkv"].append(st)
        else:
            new = {"attn": []}
            for li, bp in enumerate(params["blocks"]):
                c = cache["attn"][li] if cache is not None else None
                x, nc, aux = remat(self._block, bp, x, mode, c, aux)
                new["attn"].append(nc)
        return x, (new if cache is not None else None), aux

    def _final(self, params, x):
        return C.apply_norm(params["final_norm"], x, self.cfg.norm,
                            self.cfg.norm_eps)

    def _input(self, params, tokens, extra):
        """The embedded tokens, or (audio) the frames ``extra["frames"]``
        [B, T, d] in bf16 plus their conv positional embedding."""
        if self.cfg.family != "audio":
            return self.embed(params, tokens)
        if extra is None or "frames" not in extra:
            raise ValueError("the audio family needs extra['frames'] "
                             "[B, T, d_model]")
        x = extra["frames"].to(torch.bfloat16)
        return x + conv_pos(params["conv_pos"], x)

    def _needs_decoder(self):
        if not self.cfg.has_decode:
            raise ValueError("encoder-only model has no prefill/decode")

    def train_hidden(self, params, tokens, extra=None, mesh=None,
                     specs=None):
        """The backbone up to and with the final norm → (hidden [B, S, d]
        bf16, aux), differentiable: with autograd on, the layers the
        reference checkpoints run under :func:`remat` (every layer of the
        stack; not the hybrid's shared attention block or the VLM's cross
        layers). ``extra``: ``{"frames"}`` (audio; ``tokens`` unused) or
        ``{"image_embeds"}`` (vlm). With a training ``mesh`` (dense and
        moe; ``specs`` from :meth:`train_specs`, ``params`` this rank's
        shards, ``tokens`` its data rows): every param gathered over the
        data axis where it is used (a layer's inside its remat), the
        embedding vocabulary-parallel (``common.vocab_embed``), each
        layer's seams over the model axis."""
        if mesh is None:
            x, _, aux = self._layers(params, self._input(params, tokens,
                                                         extra),
                                     "train", extra=extra)
            return self._final(params, x), aux
        self._engine_family_only("training over a mesh", 16)
        if self.cfg.family == "moe" and mesh.data_size > 1:
            raise NotImplementedError(
                "MoE training over a data axis above 1 is not ported: "
                "capacity and dispatch over the global batch (ROADMAP "
                "Queue 1 item 23); experts over the model axis train")
        if tokens.is_cuda:
            C.no_tf32()
        table, vmesh = self._vocab_param(params, specs, "embed", "table",
                                         mesh)
        x = C.vocab_embed(table, tokens, vmesh)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for bp, spec in zip(params["blocks"], specs["blocks"], strict=True):
            x, aux = remat(self._mesh_block, bp, spec, x, aux, mesh)
        norm = SH.gather_params(params["final_norm"], specs["final_norm"],
                                mesh)
        return C.apply_norm(norm, x, self.cfg.norm, self.cfg.norm_eps), aux

    def train_logits(self, params, tokens, extra=None):
        """tokens [B, S] → (logits [B, S, V] f32, the MoE aux loss)."""
        hidden, aux = self.train_hidden(params, tokens, extra)
        return self.head(params, hidden), aux

    def mesh_head(self, params, specs, x, mesh):
        """f32 logits of x on one rank of a training mesh: the head
        gathered over the data axis, its vocabulary columns gathered over
        the model axis (``common.vocab_head``)."""
        w, vmesh = self._vocab_param(params, specs, "lm_head", "w", mesh)
        return C.vocab_head(w, x, vmesh)

    @staticmethod
    def _vocab_param(params, specs, part: str, name: str, mesh):
        """The embedding table or head gathered over the data axis, and
        the mesh where its vocabulary is sharded over the model axis (else
        None: a replicated vocabulary runs as on one device)."""
        t = SH.gather_params(params[part], specs[part], mesh)[name]
        return t, (mesh if "model" in specs[part][name] else None)

    @torch.no_grad()
    def prefill(self, params, tokens: torch.Tensor, cache: dict,
                extra=None):
        """tokens [B, S] → (the last position's logits [B, 1, V] f32, the
        cache after the prompt: attention KV at [0, S) with length S, the
        recurrent states after position S − 1, the image KV)."""
        self._needs_decoder()
        x, cache, _ = self._layers(params, self.embed(params, tokens),
                                   "prefill", cache, extra)
        return self.head(params, self._final(params, x[:, -1:])), cache

    @torch.no_grad()
    def decode(self, params, tokens: torch.Tensor, cache: dict):
        """tokens [B, 1] → (logits [B, 1, V] f32, the cache one longer),
        each row at its own position ``cache length``."""
        self._needs_decoder()
        x, cache, _ = self._layers(params, self.embed(params, tokens),
                                   "decode", cache)
        return self.head(params, self._final(params, x)), cache


# ---------------------------------------------------------------- helpers

def remat(fn, *args):
    """``fn(*args)``; with autograd on, under non-reentrant
    ``torch.utils.checkpoint``: the backward keeps only the inputs and
    runs ``fn`` again for its activations (the reference's
    ``jax.checkpoint`` around a layer). The recomputation is the same
    code on the same inputs, so the gradients are those of the plain
    call."""
    if torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def conv_pos(params, x: torch.Tensor) -> torch.Tensor:
    """HuBERT's depthwise conv positional embedding of x [B, T, d]: the
    frames in f32 padded K//2 before and K − 1 − K//2 after, the K taps
    summed in order in f32, the bias, tanh-GELU in f32 (PyTorch's
    ``tanh``), cast to x's dtype."""
    w, b = params["w"], params["b"]
    k, t = w.shape[0], x.shape[1]
    pad = torch.nn.functional.pad(x.float(), (0, 0, k // 2, k - 1 - k // 2))
    out = pad[:, :t] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + t] * w[i]
    return MLP.gelu_f32(out + b).to(x.dtype)


def cross_decode(cfg: ModelConfig, ap, x: torch.Tensor, ckv: dict,
                 quant=None) -> torch.Tensor:
    """One token x [B, 1, d] against the cached bf16 image K/V [B, Hkv,
    T_img, D]: q in bf16 times a bf16 1/√D, scores and p·V with exact
    bf16 products and f32 sums (the reference's
    ``preferred_element_type=float32`` einsums; :func:`C.bmm_f32`, which
    reads the bf16 cache once on the card), the reference's f32 softmax,
    p rounded to bf16 before p·V, then ``wo``. The image K/V carry no
    RoPE and no mask."""
    b, hkv, d = x.shape[0], cfg.num_kv_heads, cfg.head_dim
    q = C.linear(ap["wq"], x, quant).reshape(b, cfg.num_heads, d)
    if cfg.qk_norm:
        q = C.rmsnorm(q, ap["q_norm"]["scale"], cfg.norm_eps)
    g = cfg.num_heads // hkv
    qg = q.reshape(b * hkv, g, d).to(torch.bfloat16)
    sm = torch.tensor(1.0 / math.sqrt(d), dtype=torch.bfloat16,
                      device=x.device)
    k = ckv["k"].reshape(b * hkv, -1, d)
    sc = C.bmm_f32(qg * sm, k.transpose(1, 2))          # [B·Hkv, G, T]
    p = MLP.softmax_f32(sc)
    o = C.bmm_f32(p.to(torch.bfloat16), ckv["v"].reshape(b * hkv, -1, d))
    return C.linear(ap["wo"], o.reshape(b, 1, cfg.q_dim).to(x.dtype), quant)
