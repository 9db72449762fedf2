"""Convert the reference's quantized parameter tree into the port's.

The input is ``LM.quantize`` output of the JAX package with every leaf
turned into a numpy array by the caller (``np.asarray``); this module never
sees a JAX type. Block leaves carry a leading layer axis there and become
a list of per-layer dicts here, so both packages compute the same thing
(a cache's the same way: :func:`cache_from_jax`; AdamW's moments, which
mirror the params, with :func:`opt_state_from_jax`).
Every leaf crosses as it is, an MoE block's included: the f32 router,
the packed expert stacks (``[L, E, K/2, N]`` → per layer ``[E, K/2,
N]``), the shared experts, QK-norm's ``attn.q_norm``/``k_norm`` and an
FMPQ-planned projection's ``perm`` (int32 ``[K]`` per layer; a
layer's equal permutations, compared on the host, become one tensor, so
the projections of one input share one act-quant).
The reference's logical axes (``LM.quantize``'s ``qaxes``) come across
the same way (:func:`axes_from_jax`): the blocks' leading ``"layers"``
axis is dropped and each layer gets its own copy.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import fmpq
from repro_torch.layers.common import resolve_device

__all__ = ["params_from_jax", "opt_state_from_jax", "cache_from_jax",
           "axes_from_jax", "plan_from_jax", "to_torch"]


def to_torch(a, device="cuda") -> torch.Tensor:
    """numpy array → tensor on ``device``; bfloat16 arrays (ml_dtypes)
    keep their bits."""
    device = resolve_device(device)
    a = np.asarray(a)
    c = np.ascontiguousarray(a).reshape(a.shape)     # 0-d stays 0-d
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(c.view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(c.copy()).to(device)


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    return fn(x)


STACKED = ("blocks", "cross_blocks")


def params_from_jax(tree: dict, device="cuda") -> dict:
    """Reference quantized params (numpy leaves, stacked ``blocks`` and,
    for the VLM, stacked ``cross_blocks`` with their 0-d ``gate``) → the
    port's params (tensors on ``device``, each stack a list). Every other
    top-level tree crosses as it is: the hybrid's one ``shared_attn``
    block, the audio ``conv_pos``. A CUDA device without a card raises;
    pass ``device="cpu"`` for the CPU."""
    device = resolve_device(device)
    out = {k: _tree(v, lambda a: to_torch(a, device))
           for k, v in tree.items() if k not in STACKED}
    for key in STACKED:
        if key in tree:
            out[key] = _unstack(tree[key], device)
    return out


def opt_state_from_jax(state: dict, device="cuda") -> dict:
    """The reference's AdamW state (numpy leaves: ``m`` and ``v`` mirror
    its params, ``step`` an int32 0-d) → the port's (``m``/``v`` in the
    port's params layout, :func:`params_from_jax`)."""
    return {"m": params_from_jax(state["m"], device),
            "v": params_from_jax(state["v"], device),
            "step": to_torch(np.asarray(state["step"], np.int32), device)}


def _unstack(stacked, device) -> list:
    n = len(next(iter(_leaves(stacked))))
    return [_layer(stacked, i, device, {}) for i in range(n)]


def cache_from_jax(cache: dict, device="cuda") -> dict:
    """A reference cache (numpy leaves; each kind stacked over its layers
    or groups: ``attn``, ``mamba``, ``shared_attn``, ``rwkv``,
    ``cross_kv``) → the port's (``{kind: [per-layer dict]}``; the image
    K/V from ``[B, T_img, Hkv, D]`` to the port's head-major ``[B, Hkv,
    T_img, D]``), so both packages can start from one state."""
    device = resolve_device(device)
    out = {k: _unstack(v, device) for k, v in cache.items()}
    for group in out.get("cross_kv", []):
        for n, t in group.items():
            group[n] = t.transpose(1, 2).contiguous()
    return out


def _layer(x, i, device, perms: dict):
    """Layer ``i`` of stacked block leaves; ``perms`` maps a
    permutation's host bytes to the one tensor the layer gives it."""
    out = {}
    for k, v in x.items():
        if isinstance(v, dict):
            out[k] = _layer(v, i, device, perms)
        elif k == "perm":
            a = np.ascontiguousarray(v[i])
            key = (a.dtype.str, a.tobytes())
            if key not in perms:
                perms[key] = to_torch(a, device)
            out[k] = perms[key]
        else:
            out[k] = to_torch(v[i], device)
    return out


def plan_from_jax(plan) -> fmpq.FMPQPlan:
    """The reference's ``FMPQPlan`` (numpy fields) → the port's, the
    arrays copied as they are."""
    return fmpq.FMPQPlan(
        perm=np.array(plan.perm, dtype=np.int32),
        inv_perm=np.array(plan.inv_perm, dtype=np.int32),
        block_bits=np.array(plan.block_bits, dtype=np.int8),
        num_int4_blocks=int(plan.num_int4_blocks),
        block_size=int(plan.block_size))


def axes_from_jax(qaxes: dict, num_layers: int) -> dict:
    """The reference's axes tree (tuples of axis names; ``blocks`` with a
    leading ``"layers"``) → the port's (``blocks`` a list of
    ``num_layers`` per-layer trees without it)."""
    def drop(ax):
        if isinstance(ax, dict):
            return {k: drop(v) for k, v in ax.items()}
        if tuple(ax[:1]) != ("layers",):
            raise ValueError(f"block axes {ax} lack the leading 'layers'")
        return tuple(ax[1:])
    out = {k: _tree(v, tuple) for k, v in qaxes.items() if k != "blocks"}
    out["blocks"] = [drop(qaxes["blocks"]) for _ in range(num_layers)]
    return out


def _leaves(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    else:
        yield x
