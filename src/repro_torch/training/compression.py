"""int8 gradient compression with error feedback at the data-parallel
boundary (``repro/training/compression.py``).

Each gradient leaf plus its carried error is quantized symmetrically to
int8 with one f32 scale (absmax / 127): 4× fewer bytes on the wire than
f32. The quantization's residual is carried into the next step's
gradient (error feedback, as in 1-bit SGD / EF-SGD), so the long-run
mean of the decompressed stream follows the true gradient. The exchange
itself (a sum over data-parallel ranks of the compressed payloads) is
the identity on one process, as the reference's is without a ``pod``
mesh axis; the port has no trainer over ranks yet (ROADMAP Queue 1
item 19). The payload and scale are byte for byte the reference's:
``g / scale`` by a true division, half-to-even rounding, clip to ±127.
"""

from __future__ import annotations

import torch

from repro_torch.training import optimizer as OPT
from repro_torch.training.train_loop import loss_and_grads, make_loss_fn

__all__ = ["compress_tensor", "decompress_tensor", "compress_grads",
           "init_error_feedback", "make_compressed_train_step"]


def compress_tensor(g: torch.Tensor):
    """f32 tensor → (int8 payload, f32 0-d scale). Symmetric absmax."""
    g = g.float()
    scale = torch.clamp_min(torch.max(torch.abs(g)), 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_tensor(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(params):
    return OPT.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)


def compress_grads(grads, ef_state):
    """Error-feedback int8 compression over a gradient tree → (a tree of
    (int8, scale) pairs, the new error tree). The error (g + e) −
    dequant(quant(g + e)) carries to the next step."""
    def one(g, e):
        corrected = g.float() + e
        q, s = compress_tensor(corrected)
        return (q, s), corrected - decompress_tensor(q, s)

    pairs = OPT.tree_map(one, grads, ef_state)
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
                               loss_chunk: int = 512):
    """``step(params, opt_state, ef_state, batch) → (params, opt_state,
    ef_state, metrics)``: the train step with the gradients compressed,
    summed over the data-parallel ranks (one here: the identity) and
    decompressed before AdamW. Params and optimizer state are updated in
    place and returned."""
    loss_fn = make_loss_fn(lm, loss_chunk=loss_chunk)

    def step(params, opt_state, ef_state, batch):
        (loss, parts), grads = loss_and_grads(loss_fn, params, batch)
        compressed, ef_state = compress_grads(grads, ef_state)
        del grads
        grads = _map_pairs(lambda qs: decompress_tensor(*qs), compressed)
        params, opt_state, om = OPT.adamw_update(opt_cfg, params, grads,
                                                 opt_state)
        return params, opt_state, ef_state, {"loss": loss, **parts, **om}

    return step
