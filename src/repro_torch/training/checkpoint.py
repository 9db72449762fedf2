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

__all__ = ["save", "save_async", "wait_async", "restore", "latest_step",
           "cleanup", "flatten"]


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


def save(ckpt_dir: str, step: int, tree) -> str:
    """Blocking write with atomic commit → the step's directory."""
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


def save_async(ckpt_dir: str, step: int, tree) -> threading.Thread:
    """Wait for the previous background save, copy every tensor of
    ``tree`` to host memory, then write the copy with :func:`save` on a
    background thread."""
    wait_async()
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
    """Join the background save, if any; raise what it raised."""
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
            device="cuda"):
    """Read a checkpoint into the structure of ``template`` (its key
    paths and shapes must match: a mismatch raises ``ValueError``) →
    (tree of tensors on ``device``, step). ``step`` None: the
    newest complete one."""
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
    out = []
    for i, ((tpath, tmpl), meta) in enumerate(zip(flat, manifest["leaves"])):
        if tpath != meta["path"]:
            raise ValueError(f"leaf {i}: checkpoint {meta['path']!r}, "
                             f"template {tpath!r}")
        if list(tmpl.shape) != meta["shape"]:
            raise ValueError(f"leaf {i} ({tpath}): checkpoint "
                             f"{tuple(meta['shape'])}, template "
                             f"{tuple(tmpl.shape)}")
        t = torch.from_numpy(np.load(os.path.join(path, f"arr_{i:05d}.npy")))
        if meta["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        out.append(t.to(dev))
    return _unflatten(template, out), step


def cleanup(ckpt_dir: str, keep_last: int = 3) -> None:
    for s in _complete_steps(ckpt_dir)[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
