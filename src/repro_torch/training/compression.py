"""int8 gradient compression with error feedback at the data-parallel
boundary (``repro/training/compression.py``).

Each gradient leaf plus its carried error is quantized symmetrically to
int8 with one f32 scale (absmax / 127): 4× fewer bytes on the wire than
f32. The quantization's residual is carried into the next step's
gradient (error feedback, as in 1-bit SGD / EF-SGD), so the long-run
mean of the decompressed stream follows the true gradient. The payload
and scale are byte for byte the reference's: ``g / scale`` by a true
division, half-to-even rounding, clip to ±127.

Over a ``(data, model)`` mesh the reference's pjit step compresses the
gradients GSPMD has already reduced over the data axis, one absmax per
whole leaf (its pod exchange ``_psum_pod`` is the identity). So does
the port: the backward has summed each leaf's gradient over the data
ranks (``sharding.gather_params``), and a leaf's scale is the max of its
shards' absmax over every rank (one all-gather; a max does not depend on
the order), so each shard's codes are the one-device codes of the same
gradient. The exchange over pods has no counterpart here: the port has
no pod axis.
"""

from __future__ import annotations

import torch

from repro_torch.parallel import mesh as PM
from repro_torch.training import optimizer as OPT
from repro_torch.training.train_loop import loss_and_grads, make_loss_fn

__all__ = ["compress_tensor", "decompress_tensor", "compress_grads",
           "init_error_feedback", "make_compressed_train_step"]


def compress_tensor(g: torch.Tensor, absmax: torch.Tensor | None = None):
    """f32 tensor → (int8 payload, f32 0-d scale). Symmetric absmax (of
    the whole leaf, given, where ``g`` is a shard of it)."""
    g = g.float()
    if absmax is None:
        absmax = torch.max(torch.abs(g))
    scale = torch.clamp_min(absmax, 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_tensor(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(params):
    return OPT.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)


def compress_grads(grads, ef_state, mesh=None):
    """Error-feedback int8 compression over a gradient tree → (a tree of
    (int8, scale) pairs, the new error tree). The error (g + e) −
    dequant(quant(g + e)) carries to the next step. On a ``mesh`` the
    leaves are shards, each scaled by its whole leaf's absmax."""
    corrected = OPT.tree_map(lambda g, e: g.float() + e, grads, ef_state)
    absmax = {}
    if mesh is not None:
        leaves = OPT.tree_leaves(corrected)
        got = torch.stack(PM.axis_gather(torch.stack(
            [torch.max(torch.abs(c)) for c in leaves]), mesh, "world"))
        absmax = {id(c): m for c, m in zip(leaves, got.amax(0).unbind())}

    def one(c):
        q, s = compress_tensor(c, absmax.get(id(c)))
        return (q, s), c - decompress_tensor(q, s)

    pairs = OPT.tree_map(one, corrected)
    return (_map_pairs(lambda qe: qe[0], pairs),
            _map_pairs(lambda qe: qe[1], pairs))


def _map_pairs(fn, tree):
    """``fn`` over a tree whose leaves are tuples (dicts and lists of
    them)."""
    if isinstance(tree, tuple):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_pairs(fn, v) for k, v in tree.items()}
    return [_map_pairs(fn, v) for v in tree]


def make_compressed_train_step(lm, opt_cfg: OPT.AdamWConfig, *,
                               loss_chunk: int = 512, mesh=None,
                               specs=None):
    """``step(params, opt_state, ef_state, batch) → (params, opt_state,
    ef_state, metrics)``: the train step with the gradients (on a
    ``mesh`` already summed over the data ranks) compressed and
    decompressed before AdamW. Params and optimizer state are updated in
    place and returned."""
    loss_fn = make_loss_fn(lm, loss_chunk=loss_chunk, mesh=mesh,
                           specs=specs)

    def step(params, opt_state, ef_state, batch):
        (loss, parts), grads = loss_and_grads(loss_fn, params, batch)
        compressed, ef_state = compress_grads(grads, ef_state, mesh)
        del grads
        grads = _map_pairs(lambda qs: decompress_tensor(*qs), compressed)
        params, opt_state, om = OPT.adamw_update(opt_cfg, params, grads,
                                                 opt_state, mesh, specs)
        return params, opt_state, ef_state, {"loss": loss, **parts, **om}

    return step
