"""AdamW with global-norm clipping and a cosine schedule
(``repro/training/optimizer.py``), in the reference's f32 arithmetic.

The state mirrors the params: ``{"m": tree, "v": tree, "step": int32
0-d}``, the moments f32 like the params. :func:`adamw_update` runs leaf by
leaf and in place (the reference's launcher donates params and state to
its jitted step): the transient memory is a few of one leaf's
temporaries, not a second copy of the model. Its order is the
reference's: the global norm of the raw gradients, the clip scale min(1, clip / max(norm, 1e-9)), the moments
``b1·m + (1 − b1)·g`` and ``b2·v + ((1 − b2)·g)·g``, the bias corrections
``1 − b^step`` and ``p − lr·(m̂/(√v̂ + eps) + wd·p)``, every op a
separate f32 op (no fused multiply-add).

Where the port's numbers can differ from the reference's: the global
norm's f32 sums (each leaf summed in PyTorch's order, the leaves added
in the reference's leaf order: sorted keys, a stacked layer axis being
the port's list of layers), ``b ** step`` (XLA's f32 ``pow`` against
PyTorch's) and, for the schedule, XLA's f32 ``cos`` (it differs from
PyTorch's in the last bit on ~5 % of angles). Each is one or two f32
ulps of a scalar; the tests state the bound on the params that follows.

Over a ``(data, model)`` mesh the leaves are this rank's shards (their
specs from ``LM.train_specs``): :func:`global_norm` takes each leaf's
per-shard sums of squares from every rank (one all-gather), adds a
leaf's distinct shards in rank order (a leaf replicated over an axis
counted once) and the leaves in the reference's order; AdamW, elementwise,
then updates each shard as one device would.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.parallel import mesh as PM

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "tree_leaves", "tree_map", "spec_leaves",
           "shard_ranks", "state_specs"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    schedule: Callable | None = None   # step → lr multiplier


def tree_leaves(tree, is_leaf=lambda x: False) -> list:
    """The tensors of a tree of dicts, lists and tuples in the
    reference's leaf order: a dict's keys sorted, and a list of per-layer
    dicts walked path by path, each path over the layers in turn (the
    order of the reference's stacked ``[L, ...]`` leaves). ``is_leaf``:
    what else is a leaf (a spec tuple)."""
    if is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, list) and tree and isinstance(tree[0], dict):
        return [leaf for path in _paths(tree[0])
                for leaf in tree_leaves([_get(layer, path)
                                         for layer in tree], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tree_leaves(item, is_leaf)]
    return [tree]


def spec_leaves(specs) -> list:
    """A spec tree's specs in :func:`tree_leaves` order (its tuples are
    its specs; an entry may itself be a tuple of mesh axes)."""
    return tree_leaves(specs, lambda x: isinstance(x, tuple))


def shard_ranks(spec: tuple, mesh) -> list:
    """The mesh ranks that hold a leaf's distinct shards under ``spec``,
    in rank order (one rank per replicated axis)."""
    ds = range(mesh.data_size) if "data" in spec else (0,)
    ms = range(mesh.size) if "model" in spec else (0,)
    return [d * mesh.size + m for d in ds for m in ms]


def _paths(tree: dict, prefix=()) -> list:
    """The key paths of a dict tree's leaves, keys sorted."""
    return [p for k in sorted(tree)
            for p in (_paths(tree[k], prefix + (k,))
                      if isinstance(tree[k], dict) else [prefix + (k,)])]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of trees of its shape)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def state_specs(specs) -> dict:
    """The specs of :func:`adamw_init`'s state: the moments' as the
    params', the step count replicated."""
    return {"m": specs, "v": specs, "step": ()}


def adamw_init(params) -> dict:
    zeros = torch.zeros_like
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree, mesh=None, specs=None) -> torch.Tensor:
    """√(Σ over leaves of Σ g²) in f32: each leaf's squares summed by
    PyTorch, the leaves' sums added from 0 in the reference's leaf
    order (:func:`tree_leaves`). On a ``mesh`` each leaf's sum is its
    distinct shards' sums added in rank order (module docstring)."""
    sums = [torch.sum(torch.square(leaf.float()))
            for leaf in tree_leaves(tree)]
    if mesh is not None:
        parts = PM.axis_gather(torch.stack(sums), mesh, "world")
        sums = [PM.rank_sum([parts[r][i] for r in shard_ranks(spec, mesh)])
                for i, spec in enumerate(spec_leaves(specs))]
    total = None
    for s in sums:
        total = s if total is None else total + s
    return torch.sqrt(total)


def adamw_update(cfg: AdamWConfig, params, grads, state, mesh=None,
                 specs=None):
    """→ (params, state, metrics), params and state updated in place and
    returned. ``metrics``: ``grad_norm`` (before clipping) and ``lr``,
    f32 0-d tensors. ``mesh``/``specs``: the leaves are shards
    (:func:`global_norm`)."""
    step = state["step"] + 1
    gnorm = global_norm(grads, mesh, specs)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                            1.0)
    # 0-d f32 constants made on the device (a fill, where torch.tensor
    # would copy from the host and wait for the stream)
    f32 = dict(dtype=torch.float32, device=gnorm.device)
    lr = torch.full((), cfg.lr, **f32)
    if cfg.schedule is not None:
        lr = lr * cfg.schedule(step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(torch.full((), b1, **f32), step.float())
    bc2 = 1 - torch.pow(torch.full((), b2, **f32), step.float())
    with torch.no_grad():
        for p, m, v, g in zip(*map(tree_leaves, (params, state["m"],
                                                 state["v"], grads))):
            g = g.float() * scale
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(g.mul(1 - b2).mul_(g))
            del g
            delta = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
            p.sub_(delta.add_(cfg.weight_decay * p).mul_(lr))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


MIN_LR_FRAC = 0.1   # the schedule's floor, as a fraction of the peak lr


def cosine_schedule(warmup: int, total: int):
    """step (int 0-d tensor) → lr multiplier (f32): step/warmup during
    the warm-up, then f + (1 − f)·½(1 + cos(π·progress)) with f =
    ``MIN_LR_FRAC``, progress clipped to [0, 1]."""
    def fn(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = step / max(1.0, float(warmup))
        prog = torch.clamp((step - warmup) / max(1.0, float(total - warmup)),
                           0.0, 1.0)
        cos = (MIN_LR_FRAC
               + (1 - MIN_LR_FRAC) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return fn
