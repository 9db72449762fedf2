"""Meta-device stand-ins, specs and per-rank bytes for every dry-run cell
(``repro/launch/specs.py``).

``build_cell(arch, shape_name, mesh)`` returns what ``launch/dryrun.py``
needs, with no memory allocated anywhere: the arguments of the cell's
step as tensors on the meta device at the cell's global shapes (params,
AdamW state, cache, batch), their specs on ``mesh`` and the step itself.

* ``train`` cells: the f32 params of ``LM.init_fp`` and their AdamW
  state under ``TRAIN_RULES`` (``"embed": None`` under ``fsdp=False``),
  the batch over :func:`sharding.batch_spec`'s axes; the step is
  ``make_train_step`` (the chunked CE, AdamW).
* ``prefill``/``decode`` cells: the packed W4 params of ``LM.quantize``
  under ``SERVE_RULES``, the family's int4 cache (``cache_pspecs``,
  ``seq_parallel`` when the batch is 1) and the tokens; the step is
  ``LM.prefill`` or ``LM.decode``. The encoder (HuBERT) has no cache:
  its ``prefill_32k`` is one quantized forward (``LM.train_logits``).

Params are made by :func:`shapes_of_init`: one block of each kind made
(and quantized) on the meta device, its shapes repeated over the stack.

Bytes count each tensor's logical shape (the q4 cache's per-row scales
are ``[B, Hkv, 1, D]`` views of one ``[Hkv, 1, D]`` tensor in the port,
materialized in the reference); a rank's bytes are its shard's
(:func:`sharding.shard_shape`).

:func:`trace_refusal` says, before any trace, why the port cannot run
one rank of a cell (None where it can).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      get_config)
from repro_torch.models.lm import LM, QuantConfig
from repro_torch.parallel import sharding as SH
from repro_torch.training import optimizer as OPT
from repro_torch.training.train_loop import make_train_step

__all__ = ["Cell", "build_cell", "input_specs", "shapes_of_init",
           "rank_args", "tree_bytes", "trace_refusal", "depth_unit",
           "with_depth", "SMOKE_SHAPES"]

META = torch.device("meta")
PARTS = ("params", "opt_state", "cache", "batch")
# ``--smoke``: the reference's smoke test's shapes
# (``tests/launch/test_sharding.py`` ``test_dryrun_smoke_subprocess``) and
# small prefill and long-decode ones in the same spirit
SMOKE_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 64, 8, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 128, 8, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 128, 8, "decode"),
    "long_500k": ShapeConfig("long_500k", 256, 1, "decode"),
}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Meta tensors of the model *inputs* of one cell, the reference's
    dtypes: int32 tokens (and labels), an f32 mask, ``frames`` [B, S, d]
    f32 for audio, ``image_embeds`` [B, T_img, d] f32 for vlm; a decode
    cell's one new token a row."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": _meta((b, 1), torch.int32)}
    out = {"tokens": _meta((b, s), torch.int32)}
    if shape.kind == "train":
        out["labels"] = _meta((b, s), torch.int32)
        out["mask"] = _meta((b, s), torch.float32)
    if cfg.family == "audio":
        out["frames"] = _meta((b, s, cfg.d_model), torch.float32)
    if cfg.family == "vlm":
        out["image_embeds"] = _meta((b, cfg.num_image_tokens, cfg.d_model),
                                    torch.float32)
    return out


def shapes_of_init(lm: LM, quantized: bool = False) -> dict:
    """``lm``'s params tree on the meta device (``LM.init_fp``'s f32
    tree, or ``LM.init``'s packed one): one block of each kind made (and
    quantized) there, and a fresh meta tensor of each of its shapes for
    every block of the stack (every block of a stack has the same
    shapes, so this is exact, and quantizing 48 × 64 expert stacks on the
    meta device once instead of 48 times takes a second, not 35)."""
    def one(make):
        block = make(None, META)
        return lm.quantize_block(block) if quantized else block

    def repeat(block, n):
        return [OPT.tree_map(torch.empty_like, block) for _ in range(n)]

    top = lm.init_top(None, META)
    params = lm.quantize({**top, "blocks": []}) if quantized else top
    params["blocks"] = repeat(one(lm.init_block), lm._n_blocks())
    if lm.cfg.family == "hybrid":
        params["shared_attn"] = one(lm.init_shared_attn)
    if lm.cfg.family == "vlm":
        params["cross_blocks"] = repeat(one(lm.init_cross_block), lm.n_groups)
    return params


def tree_bytes(tree, specs, mesh) -> int:
    """The bytes one rank holds of a tree under its specs (each leaf's
    logical shape, sharded)."""
    return sum(math.prod(SH.shard_shape(t.shape, s, mesh)) * t.element_size()
               for t, s in zip(OPT.tree_leaves(tree), OPT.spec_leaves(specs),
                               strict=True))


def _batch_specs(batch: dict, mesh) -> dict:
    """The batch dimension over the batch axes where they divide it
    (the reference's ``_batch_shardings``)."""
    baxes = SH.batch_spec(mesh)[0]
    n = SH.axes_size(mesh, baxes)
    return {k: (baxes if t.shape[0] % n == 0 and t.shape[0] > 0 else None,)
            + (None,) * (t.dim() - 1) for k, t in batch.items()}


@dataclasses.dataclass
class Cell:
    """One dry-run cell: its step's arguments on the meta device at the
    global shapes (``args``: ``params``, ``opt_state``, ``cache``,
    ``batch``, those the step takes) and their specs on the mesh."""
    arch: str
    shape: ShapeConfig
    kind: str
    cfg: ModelConfig
    lm: LM
    args: dict
    specs: dict

    def argument_bytes_by(self, mesh) -> dict:
        """One rank's bytes of each part the step takes."""
        return {p: tree_bytes(self.args[p], self.specs[p], mesh)
                for p in PARTS if p in self.args}

    def step(self, mesh=None, loss_chunk: int = 512, opt=None):
        """The cell's step, ``args`` (this dict's layout) → its outputs:
        one device's at the global shapes, or (``train``, a ``mesh``) one
        rank's, whose params and state are its shards and whose batch is
        the global one (each data rank takes its rows)."""
        lm = self.lm
        if self.kind == "train":
            fn = make_train_step(
                lm, opt or OPT.AdamWConfig(), loss_chunk=loss_chunk,
                mesh=mesh, specs=self.specs["params"] if mesh else None)
            return lambda a: fn(a["params"], a["opt_state"], a["batch"])
        if mesh is not None:
            raise NotImplementedError(trace_refusal(self.cfg, self.kind,
                                                    mesh))

        def extra(batch):
            return {k: v for k, v in batch.items()
                    if k in ("frames", "image_embeds")} or None

        if self.cfg.encoder_only:
            def encode(a):
                with torch.no_grad():
                    return lm.train_logits(a["params"], a["batch"]["tokens"],
                                           extra(a["batch"]))[0]
            return encode
        if self.kind == "prefill":
            return lambda a: lm.prefill(a["params"], a["batch"]["tokens"],
                                        a["cache"], extra(a["batch"]))
        return lambda a: lm.decode(a["params"], a["batch"]["tokens"],
                                   a["cache"])


def build_cell(arch: str, shape_name: str, mesh, *,
               quant: QuantConfig | None = None, fsdp: bool = True,
               cfg: ModelConfig | None = None,
               shape: ShapeConfig | None = None) -> Cell:
    """The cell ``(arch, shape_name)`` on ``mesh`` (module docstring).
    ``quant``: the serving cells' runtime (default ``impl="ref"``, the
    split schedule, int4 KV); ``cfg``/``shape``: in place of the
    registry's (a smoke config, a cut depth, a small shape)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    ins = input_specs(cfg, shape)
    bspecs = _batch_specs(ins, mesh)
    if shape.kind == "train":
        lm = LM(cfg)
        params = shapes_of_init(lm)
        rules = dict(SH.TRAIN_RULES)
        if not fsdp:
            rules["embed"] = None
        pspecs = SH.tree_pspecs(lm.axes(params), params, mesh, rules)
        return Cell(arch, shape, "train", cfg, lm,
                    {"params": params, "opt_state": OPT.adamw_init(params),
                     "batch": ins},
                    {"params": pspecs, "opt_state": OPT.state_specs(pspecs),
                     "batch": bspecs})
    # serving cells run the quantized W4AxKV4 model (the paper's system)
    lm = LM(cfg, quant=quant or QuantConfig(impl="ref"))
    params = shapes_of_init(lm, quantized=True)
    args = {"params": params, "batch": ins}
    specs = {"params": SH.tree_pspecs(lm.axes(params), params, mesh,
                                      SH.SERVE_RULES),
             "batch": bspecs}
    if not cfg.encoder_only:
        b, s = shape.global_batch, shape.seq_len
        args["cache"] = lm.init_cache(b, s, device=META)
        specs["cache"] = SH.cache_pspecs(args["cache"], mesh,
                                         seq_parallel=(b == 1))
    return Cell(arch, shape, shape.kind, cfg, lm, args, specs)


def trace_refusal(cfg: ModelConfig, kind: str, mesh) -> str | None:
    """Why the port cannot run one rank of this cell's step on ``mesh``
    (None where it can): today ``train`` of the dense family on a mesh
    without a pod axis, and of the moe family where the data axis is 1."""
    if kind != "train":
        return ("LM.prefill/decode take no mesh: serving over a (data, "
                "model) mesh is not ported (ROADMAP Queue 1 item 24)")
    if "pod" in mesh.axis_names:
        return ("the trainer has no pod axis (ROADMAP Queue 1 item 25)")
    if cfg.family not in ("dense", "moe"):
        return (f"training over a mesh covers the dense and moe families; "
                f"the {cfg.family} family's is not ported (ROADMAP Queue 1 "
                f"item 16)")
    if cfg.family == "moe" and mesh.data_size > 1:
        return ("MoE training over a data axis above 1 is not ported "
                "(ROADMAP Queue 1 item 23)")
    return None


def rank_args(cell: Cell, mesh) -> dict:
    """One rank's arguments of a ``train`` cell on ``mesh`` (meta): a
    fresh tensor of its shard's shape for every param, the AdamW state of
    those, and the global batch (the step takes each data rank's rows)."""
    params = OPT.tree_map(
        lambda t, s: _meta(SH.shard_shape(t.shape, s, mesh), t.dtype),
        cell.args["params"], cell.specs["params"])
    return {"params": params, "opt_state": OPT.adamw_init(params),
            "batch": cell.args["batch"]}


def depth_unit(cfg: ModelConfig) -> tuple[int, int]:
    """(layers of one repeating unit, units): a layer, or a group (the
    hybrid's shared attention block and its ``attn_period`` Mamba2
    layers; the VLM's self layers and their cross layer)."""
    period = {"hybrid": cfg.attn_period,
              "vlm": cfg.cross_attn_period}.get(cfg.family, 1)
    return period, cfg.num_layers // period


def with_depth(cfg: ModelConfig, units: int) -> ModelConfig:
    """``cfg`` cut to ``units`` of :func:`depth_unit`."""
    return dataclasses.replace(cfg, num_layers=depth_unit(cfg)[0] * units)
