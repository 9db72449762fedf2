"""Logical-axis → mesh-axis resolution (``repro/parallel/sharding.py``),
and the collectives of training over a ``(data, model)`` mesh.

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
dimension its spec names "model" (or "data"), the rank's contiguous 1/M
(1/D) of it; :func:`unshard` gathers it back, exactly. A packed W4 weight
``[K/2, N]`` splits along K at whole 128-channel blocks when K/M is a
multiple of 128 (each block is 64 packed rows), its scales ``[K/128, N]``
likewise. :func:`batch_rows` is ``batch_spec``: this data rank's
contiguous rows of the global batch.

Training's collectives are ``torch.autograd.Function``s, each the
identity on an axis of one rank (so a 1 × 1 mesh computes the one-device
step's ops), every sum over ranks an all-gather added in rank order
(``parallel/mesh.py``):

``gather_data``  FSDP: a param's "data" dimension all-gathered; backward:
                 the data ranks' gradients summed in rank order, this
                 rank's slice kept (an all-to-all of the slices).
``fanout``       identity forward; backward: the axis's gradients summed
                 in rank order (a column-parallel input over "model", a
                 leaf replicated over "data").
``reduce_sum``   forward: the axis's parts summed in rank order;
                 backward: identity (the row-parallel seam).
``gather_cols``  the model ranks' columns of an activation concatenated;
                 backward: this rank's slice (``"slice"``, where what
                 follows runs alike on every rank) or the ranks' gradients
                 summed in rank order, then sliced (``"sum"``).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.parallel import mesh as PM

__all__ = ["TRAIN_RULES", "SERVE_RULES", "spec_for_axes", "tree_pspecs",
           "cache_pspecs", "shard", "shard_tree", "shard_shape", "unshard",
           "batch_rows", "gather_data", "fanout", "reduce_sum",
           "gather_cols", "gather_params"]

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
    spec shards over "model" or "data" (a copy; the full tensor can be
    freed)."""
    for dim, ax in enumerate(spec):
        if ax in ("model", "data"):
            n = t.shape[dim] // mesh.axis_size(ax)
            t = t.narrow(dim, mesh.axis_rank(ax) * n, n)
    return t.contiguous()


def shard_shape(shape, spec: tuple, mesh) -> tuple:
    """The shape of one rank's shard of a tensor of ``shape``."""
    return tuple(n // mesh.axis_size(ax) if ax in ("model", "data") else n
                 for n, ax in zip(shape, spec))


def unshard(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The whole tensor of this rank's shard ``t`` (collective: every rank
    of the mesh calls it with its shard of the same tensor)."""
    for dim, ax in enumerate(spec):
        if ax in ("model", "data"):
            t = torch.cat(PM.axis_gather(t, mesh, ax), dim)
    return t


def batch_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """This data rank's contiguous rows of the global batch ``t`` (the
    reference's ``batch_spec``: the batch dimension over "data")."""
    d = mesh.data_size
    if t.shape[0] % d:
        raise ValueError(f"a global batch of {t.shape[0]} rows does not "
                         f"split over a data axis of {d}")
    n = t.shape[0] // d
    return t[mesh.data_rank * n:(mesh.data_rank + 1) * n]


# ------------------------------------------------ training collectives

def _sum_scatter(g: torch.Tensor, dim: int, mesh, axis: str):
    """Σ over the axis's ranks, in rank order, of their ``g``, sliced to
    this rank's 1/n along ``dim``: each rank's slices swapped by one
    all-to-all, then added in rank order."""
    n = mesh.axis_size(axis)
    parts = torch.stack(g.chunk(n, dim))
    got = PM.axis_all_to_all(parts, mesh, axis)
    return PM.rank_sum(list(got.unbind(0)))


class _GatherData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return torch.cat(PM.axis_gather(p, mesh, "data"), dim)

    @staticmethod
    def backward(ctx, g):
        return _sum_scatter(g, ctx.dim, ctx.mesh, "data"), None, None


class _Fanout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return PM.rank_sum(PM.axis_gather(g, ctx.mesh, ctx.axis)), None, None


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return PM.rank_sum(PM.axis_gather(x, mesh, axis))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, backward):
        ctx.mesh, ctx.how = mesh, backward
        return torch.cat(PM.axis_gather(x, mesh, "model"), -1)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        if ctx.how == "sum":
            return _sum_scatter(g, g.dim() - 1, mesh, "model"), None, None
        n = g.shape[-1] // mesh.size
        return (g.narrow(-1, mesh.model_rank * n, n).contiguous(), None,
                None)


def gather_data(p: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """FSDP: ``p``'s shards along ``dim`` over the data axis, whole."""
    return p if mesh.data_size == 1 else _GatherData.apply(p, dim, mesh)


def fanout(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """``x`` unchanged; its gradient the axis's gradients summed in rank
    order."""
    return x if mesh.axis_size(axis) == 1 else _Fanout.apply(x, mesh, axis)


def reduce_sum(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """The axis's ``x`` summed in rank order; gradient passed through."""
    return (x if mesh.axis_size(axis) == 1
            else _ReduceSum.apply(x, mesh, axis))


def gather_cols(x: torch.Tensor, mesh, backward: str) -> torch.Tensor:
    """The model ranks' last-dimension columns of ``x``, concatenated in
    rank order; backward ``"slice"`` or ``"sum"`` (module docstring)."""
    return x if mesh.size == 1 else _GatherCols.apply(x, mesh, backward)


def gather_params(tree, specs, mesh):
    """A params tree as the forward uses it on this rank: each leaf's
    "data" dimension gathered (:func:`gather_data`), a leaf without one
    through ``fanout(·, "data")`` (its gradient summed over the data
    ranks); the "model" dimensions stay sharded. Called inside
    ``models.lm.remat``, so the backward gathers again and no whole layer
    is kept for it."""
    if isinstance(tree, dict):
        return {k: gather_params(tree[k], specs[k], mesh) for k in tree}
    if isinstance(tree, list):
        return [gather_params(t, s, mesh) for t, s in zip(tree, specs)]
    if "data" in specs:
        return gather_data(tree, specs.index("data"), mesh)
    return fanout(tree, mesh, "data")


def shard_tree(params, specs, mesh):
    """:func:`shard` over a params tree and its spec tree."""
    if isinstance(params, dict):
        return {k: shard_tree(params[k], specs[k], mesh) for k in params}
    if isinstance(params, list):
        return [shard_tree(p, s, mesh) for p, s in zip(params, specs,
                                                         strict=True)]
    return shard(params, specs, mesh)
