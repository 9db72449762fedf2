"""Atomic, resumable checkpoints of a tree of tensors
(``repro/training/checkpoint.py``'s layout and guarantees).

Layout::

  <dir>/step_<N:08d>/
      manifest.json        step, and per leaf its key path, dtype and
                           shape
      arr_<i:05d>.npy      one .npy per leaf (bf16 as its 16 bits, int16)
      _COMPLETE            commit marker, written last

* atomic commit: a save stages into ``step_<N>.tmp`` and ``rename``s it
  into place, so a crash mid-save never corrupts the newest complete
  checkpoint;
* :func:`latest_step` finds the newest step holding ``_COMPLETE`` (a
  directory without it is a crashed save and is ignored);
* :func:`save_async` copies every tensor to host memory first, then
  writes on a background thread; :func:`wait_async` joins it and raises
  what the write raised;
* :func:`restore` reads into the structure of a template, checks every
  key path and shape, and puts the tensors on an explicit device;
* :func:`cleanup` keeps the newest ``keep_last`` complete steps.

From a ``(data, model)`` mesh (``mesh=``, ``specs=``: a spec per leaf),
:func:`save` gathers every leaf whole on the caller's thread
(``sharding.unshard``, collective), rank 0 writes, and every rank waits
at the mesh's gloo barrier; :func:`save_async` gathers on the caller's
thread and only rank 0's file writes run in the background (a collective
from a second thread could interleave with the step's and deadlock
NCCL). ``restore(..., shardings=specs, mesh=mesh)`` is the reference's
elastic resharding: every rank reads each whole leaf (memory-mapped) and
keeps its shard, so a directory written at D × M resumes at any D′ × M′,
1 × 1 and one device included.

Leaves are taken with dict keys sorted and lists by index, and the
manifest names each by its key path in the port's own tree
(``1/m/blocks/3/attn/wq/w``), not by the reference's treedef: the two
packages do not read each other's checkpoints.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.layers.common import resolve_device
from repro_torch.parallel import mesh as PM
from repro_torch.parallel import sharding as SH

__all__ = ["save", "save_async", "wait_async", "restore", "latest_step",
           "cleanup", "flatten", "flatten_specs"]


def flatten(tree, prefix=""):
    """(key path, leaf) pairs: dict keys sorted, lists and tuples by
    index."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [(prefix, tree)]
    return [pair for k, v in items
            for pair in flatten(v, f"{prefix}/{k}" if prefix else str(k))]


def _unflatten(template, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(template)


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _whole(tree, mesh, specs):
    """``tree``'s leaves gathered whole from the mesh's shards, one at a
    time (every rank takes part), copied to the host on rank 0 → that
    host tree on rank 0, None elsewhere."""
    host = []
    for (_, leaf), spec in zip(flatten(tree), flatten_specs(tree, specs),
                               strict=True):
        whole = SH.unshard(leaf, spec, mesh)
        if mesh.rank == 0:
            host.append(whole.detach().to("cpu", copy=True))
        del whole
    return _unflatten(tree, host) if mesh.rank == 0 else None


def flatten_specs(tree, specs) -> list:
    """The specs of :func:`flatten`'s leaves, in its order."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree)
                for s in flatten_specs(tree[k], specs[k])]
    if isinstance(tree, (list, tuple)):
        return [s for t, sp in zip(tree, specs, strict=True)
                for s in flatten_specs(t, sp)]
    return [specs]


def save(ckpt_dir: str, step: int, tree, mesh=None, specs=None) -> str:
    """Blocking write with atomic commit → the step's directory. From a
    ``mesh``: the leaves gathered whole, rank 0 writes, all wait."""
    if mesh is not None:
        whole = _whole(tree, mesh, specs)
        if whole is not None:
            save(ckpt_dir, step, whole)
        PM.mesh_barrier(mesh)
        return os.path.join(ckpt_dir, f"step_{step:08d}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)            # a crashed save's leftovers
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": []}
    for i, (path, leaf) in enumerate(flatten(tree)):
        dtype = str(leaf.dtype).removeprefix("torch.")
        arr = _to_host(leaf)
        np.save(os.path.join(tmp, f"arr_{i:05d}.npy"), arr)
        manifest["leaves"].append({"path": path, "dtype": dtype,
                                   "shape": list(arr.shape)})
    manifest["num_leaves"] = len(manifest["leaves"])
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "_COMPLETE"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


class _Writer:
    """The one background save of this process, and what it raised."""
    thread: threading.Thread | None = None
    error: Exception | None = None


def save_async(ckpt_dir: str, step: int, tree, mesh=None,
               specs=None) -> threading.Thread | None:
    """Wait for the previous background save, copy every tensor of
    ``tree`` to host memory (from a ``mesh``: gathered whole, every rank
    taking part), then write the copy with :func:`save` on a background
    thread (rank 0's only)."""
    wait_async()
    if mesh is not None:
        host = _whole(tree, mesh, specs)
        if host is None:
            return None
    else:
        host = _unflatten(tree, [leaf.detach().to("cpu", copy=True)
                                 for _, leaf in flatten(tree)])

    def run():
        try:
            save(ckpt_dir, step, host)
        except Exception as e:  # noqa: BLE001 — the writer thread's
            _Writer.error = e   # boundary: wait_async re-raises it

    _Writer.thread = threading.Thread(target=run, daemon=True)
    _Writer.thread.start()
    return _Writer.thread


def wait_async() -> None:
    """Join this process's background save, if any; raise what it
    raised."""
    if _Writer.thread is not None:
        _Writer.thread.join()
        _Writer.thread = None
    if _Writer.error is not None:
        err, _Writer.error = _Writer.error, None
        raise err


def latest_step(ckpt_dir: str) -> int | None:
    steps = _complete_steps(ckpt_dir)
    return steps[-1] if steps else None


def _complete_steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(
        int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
        if n.startswith("step_") and not n.endswith(".tmp")
        and os.path.exists(os.path.join(ckpt_dir, n, "_COMPLETE")))


def restore(ckpt_dir: str, template, step: int | None = None,
            device="cuda", shardings=None, mesh=None):
    """Read a checkpoint into the structure of ``template`` (its key
    paths and shapes must match: a mismatch raises ``ValueError``) →
    (tree of tensors on ``device``, step). ``step`` None: the
    newest complete one. ``shardings``: a spec per leaf of ``template``
    (this rank's shards on ``mesh``): each whole leaf is read
    memory-mapped and this rank's shard kept; the shard's shape must be
    the template's."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = flatten(template)
    if len(flat) != manifest["num_leaves"]:
        raise ValueError(f"checkpoint has {manifest['num_leaves']} leaves, "
                         f"the template {len(flat)}")
    specs = (flatten_specs(template, shardings) if shardings is not None
             else [None] * len(flat))
    out = []
    for i, ((tpath, tmpl), meta, spec) in enumerate(
            zip(flat, manifest["leaves"], specs)):
        if tpath != meta["path"]:
            raise ValueError(f"leaf {i}: checkpoint {meta['path']!r}, "
                             f"template {tpath!r}")
        if spec is not None and len(spec) != len(meta["shape"]):
            raise ValueError(f"leaf {i} ({tpath}): spec {spec} for a "
                             f"checkpoint of shape {tuple(meta['shape'])}")
        want = (SH.shard_shape(meta["shape"], spec, mesh)
                if spec is not None else tuple(meta["shape"]))
        if tuple(tmpl.shape) != want:
            raise ValueError(f"leaf {i} ({tpath}): checkpoint "
                             f"{tuple(meta['shape'])}"
                             + (f" sharded {spec} to {want}"
                                if spec is not None else "")
                             + f", template {tuple(tmpl.shape)}")
        arr = np.load(os.path.join(path, f"arr_{i:05d}.npy"),
                      mmap_mode="r")
        if spec is not None and want != tuple(meta["shape"]):
            arr = arr[tuple(_shard_slice(n, ax, mesh)
                            for n, ax in zip(arr.shape, spec))]
        t = torch.from_numpy(np.array(arr, order="C"))
        if meta["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        out.append(t.to(dev))
    return _unflatten(template, out), step


def _shard_slice(n: int, ax, mesh) -> slice:
    if ax not in ("model", "data"):
        return slice(None)
    k = n // mesh.axis_size(ax)
    return slice(mesh.axis_rank(ax) * k, (mesh.axis_rank(ax) + 1) * k)


def cleanup(ckpt_dir: str, keep_last: int = 3) -> None:
    for s in _complete_steps(ckpt_dir)[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
