"""Logical-axis → mesh-axis resolution for tensor-parallel serving (the
serve path's part of ``repro/parallel/sharding.py``).

A parameter's logical axes (``LM.axes``: ``"embed"``, ``"qdim"``,
``"kvdim"``, ``"mlp"``, ``"vocab"``, …) map through a rule table onto the
mesh's axes. A spec is a tuple with one entry per dimension, a mesh axis
name or ``None`` (replicated), as JAX's ``PartitionSpec`` lists them:

``TRAIN_RULES``  "embed" over the data axis, the TP dims over "model".
``SERVE_RULES``  pure TP: fan-in dims replicated, the TP dims over
                 "model" (column-parallel wq/wk/wv/w_up/w_gate over their
                 N, row-parallel wo/w_down over their K).

A dimension that its mesh axis does not divide stays replicated, and an
axis already used by an earlier dimension is not used again.

:func:`shard` then takes one rank's slice of a tensor: along each
dimension its spec names "model", the rank's contiguous 1/M of it. A
packed W4 weight ``[K/2, N]`` splits along K at whole 128-channel blocks
when K/M is a multiple of 128 (each block is 64 packed rows), its scales
``[K/128, N]`` likewise.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["TRAIN_RULES", "SERVE_RULES", "spec_for_axes", "tree_pspecs",
           "cache_pspecs", "shard", "shard_tree"]

TRAIN_RULES = {
    "embed": "data",
    "vocab": "model",
    "heads": "model",
    "kv": "model",
    "qdim": "model",
    "kvdim": "model",
    "mlp": "model",
    "experts": "model",
    "layers": None,
    None: None,
}

SERVE_RULES = {
    **TRAIN_RULES,
    "embed": None,          # replicate fan-in dims: no gather on decode path
}


def spec_for_axes(axes: tuple, shape: tuple, mesh, rules: dict) -> tuple:
    """Logical axes tuple (+ concrete shape) → spec tuple."""
    out = []
    used = set()
    for dim, name in zip(shape, axes):
        mesh_axis = rules.get(name, None)
        if (mesh_axis is None or mesh_axis not in mesh.axis_names
                or mesh_axis in used or dim % mesh.shape[mesh_axis] != 0):
            out.append(None)
        else:
            out.append(mesh_axis)
            used.add(mesh_axis)
    return tuple(out)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def tree_pspecs(axes_tree, params_tree, mesh, rules: dict):
    """Axes tree + params tree (dicts and lists) → spec tree."""
    if _is_axes(axes_tree):
        return spec_for_axes(axes_tree, tuple(params_tree.shape), mesh,
                             rules)
    if isinstance(axes_tree, dict):
        return {k: tree_pspecs(axes_tree[k], params_tree[k], mesh, rules)
                for k in params_tree}
    return [tree_pspecs(a, p, mesh, rules)
            for a, p in zip(axes_tree, params_tree, strict=True)]


def _dim_axis(dim: int, mesh, axis: str) -> Optional[str]:
    if axis in mesh.axis_names and dim % mesh.shape[axis] == 0:
        return axis
    return None


def cache_pspecs(cache_tree: dict, mesh) -> dict:
    """Specs of the paged serving cache's tensors (by name): the pools
    ``k_pool``/``v_pool`` ``[L, P, ps, Hkv, D/2]`` shard ONLY over kv heads
    (pages are a host-global namespace: block tables and work-queue
    descriptors index the same physical pages on every shard), their
    static per-channel ``k_scale``/``k_zero``/``v_scale``/``v_zero``
    ``[Hkv, 1, D]`` to match; anything else is replicated."""
    def leaf_spec(name, leaf):
        shape = tuple(leaf.shape)
        if name in ("k_pool", "v_pool"):
            return (None, None, None, _dim_axis(shape[3], mesh, "model"),
                    None)
        if name in ("k_scale", "k_zero", "v_scale", "v_zero") \
                and len(shape) == 3:
            return (_dim_axis(shape[0], mesh, "model"), None, None)
        return (None,) * len(shape)
    return {k: leaf_spec(k, v) for k, v in cache_tree.items()}


def shard(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's contiguous slice of ``t`` along every dimension its
    spec shards over "model" (a copy; the full tensor can be freed)."""
    for dim, ax in enumerate(spec):
        if ax == "model":
            n = t.shape[dim] // mesh.shape["model"]
            t = t.narrow(dim, mesh.model_rank * n, n)
    return t.contiguous()


def shard_tree(params, specs, mesh):
    """:func:`shard` over a params tree and its spec tree."""
    if isinstance(params, dict):
        return {k: shard_tree(params[k], specs[k], mesh) for k in params}
    if isinstance(params, list):
        return [shard_tree(p, s, mesh) for p, s in zip(params, specs,
                                                         strict=True)]
    return shard(params, specs, mesh)
