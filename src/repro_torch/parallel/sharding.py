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
axis already used by an earlier dimension is not used again. The specs
that :func:`batch_spec` and :func:`cache_pspecs` build may also hold a
tuple of mesh axes, the dimension split over their product (the batch over
``("pod", "data")``; a long cache's time axis over ``("data", "model")``).

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

import math
from typing import Optional

import torch

from repro_torch.parallel import mesh as PM

__all__ = ["TRAIN_RULES", "SERVE_RULES", "spec_for_axes", "tree_pspecs",
           "axes_size", "batch_spec", "cache_pspecs", "shard", "shard_tree",
           "shard_shape", "unshard",
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


def _members(mesh_axis) -> tuple:
    return mesh_axis if isinstance(mesh_axis, tuple) else (mesh_axis,)


def axes_size(mesh, mesh_axis) -> int:
    """The ranks a spec entry splits a dimension over (1 for None)."""
    return math.prod(int(mesh.shape[a]) for a in _members(mesh_axis)
                     if a is not None)


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


def batch_spec(mesh) -> tuple:
    """The batch dimension's spec entry, one tuple: ``(("pod", "data"),)``
    when the mesh has a pod axis, else ``("data",)``."""
    return (("pod", "data"),) if "pod" in mesh.axis_names else ("data",)


def cache_pspecs(cache_tree: dict, mesh, *,
                 seq_parallel: bool = False) -> dict:
    """Specs of a cache's tensors, by the meaning of each leaf (the
    reference's ``cache_pspecs`` rules; the port's contiguous leaves have
    no leading layer axis, and its image K/V are head-major):

    * the paged serving pools ``k_pool``/``v_pool`` ``[L, P, ps, Hkv,
      D/2]`` shard ONLY over kv heads (pages are a host-global namespace:
      block tables and work-queue descriptors index the same physical
      pages on every shard), their static per-channel
      ``k_scale``/``k_zero``/``v_scale``/``v_zero`` ``[Hkv, 1, D]`` to
      match;
    * q4 ``k_packed``/``v_packed`` ``[B, Hkv, T, D/2]`` and their scales
      ``[B, Hkv, 1, D]``; bf16 ``k``/``v`` ``[B, T, Hkv, D]``; the VLM's
      ``cross_kv`` ``k``/``v`` ``[B, Hkv, T_img, D]``; RWKV's ``s`` ``[B,
      H, d, d]`` and shifts ``[B, 1, D]``; Mamba2's ``ssm`` ``[B, H, N,
      P]`` and ``conv`` ``[B, K − 1, Ch]``; ``length`` ``[B]``: the batch
      over :func:`batch_spec`'s axes where they divide it, heads (and
      the conv's channels) over "model";
    * the time axis of an attention cache: with ``seq_parallel`` (batch
      1, long context) over "data" instead of the batch, and, where the
      kv heads do not divide the model axis, over "model" too
      (flash-decode over a time-sharded cache);
    * anything else replicated.

    ``cache_tree``: a dict of such leaves, nested in dicts and lists
    (``LM.init_cache``'s tree, or the engine's flat dict of pools) →
    the same structure of spec tuples."""
    baxes = batch_spec(mesh)[0]

    def t_axis(dim, h_ax):
        axes = []
        if seq_parallel and dim % mesh.shape["data"] == 0:
            axes.append("data")
        if (h_ax is None and "model" in mesh.axis_names
                and dim % (mesh.shape["model"]
                           * (mesh.shape["data"] if axes else 1)) == 0):
            axes.append("model")
        if not axes:
            return None
        return axes[0] if len(axes) == 1 else tuple(axes)

    def leaf_spec(path, leaf):
        name, shape = path[-1], tuple(leaf.shape)

        def bdim(i=0):
            if shape[i] % axes_size(mesh, baxes) == 0 and not seq_parallel:
                return baxes
            return None

        def heads(i):
            return _dim_axis(shape[i], mesh, "model")

        if name in ("k_pool", "v_pool"):
            return (None, None, None, heads(3), None)
        if name in ("k_scale", "k_zero", "v_scale", "v_zero"):
            if len(shape) == 3:                 # the pools' [Hkv, 1, D]
                return (heads(0), None, None)
            return (bdim(), heads(1), None, None)
        if name in ("k_packed", "v_packed") or (
                name in ("k", "v") and "cross_kv" in path):
            h = heads(1)                        # [B, Hkv, T, ·]
            return (bdim(), h, t_axis(shape[2], h), None)
        if name in ("k", "v"):                  # [B, T, Hkv, D]
            h = heads(2)
            return (bdim(), t_axis(shape[1], h), h, None)
        if name in ("s", "ssm"):
            return (bdim(), heads(1), None, None)
        if name == "conv":
            return (bdim(), None, heads(2))
        if name in ("shift_tm", "shift_cm"):
            return (bdim(), None, None)
        if name == "length":
            return (bdim(),)
        return (None,) * len(shape)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, path) for v in tree]
        return leaf_spec(path, tree)

    return walk(cache_tree, ())


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
    """The shape of one rank's shard of a tensor of ``shape`` (an entry a
    mesh axis, a tuple of them, or None)."""
    return tuple(n // axes_size(mesh, ax) for n, ax in zip(shape, spec))


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
