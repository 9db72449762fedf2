"""The dry run without XLA (``repro/launch/dryrun.py``): every (arch ×
shape) cell of ``all_cells()`` on the reference's production meshes (16 ×
16 and 2 × 16 × 16), sized per rank on the meta device. It needs no card,
starts no process group and compiles nothing.

For each cell it records:

* ``memory.argument_bytes`` and ``argument_bytes_by`` (``params``,
  ``opt_state``, ``cache``, ``batch``): one rank's bytes of what the
  step takes in, from the shapes and their specs (``launch/specs.py``);
* ``flops_global``: ``torch.utils.flop_counter.FlopCounterMode`` over one
  device's step at the cell's global shape (the matmuls, convolutions
  and attention it counts; the train step's backward and its remat
  recompute included), traced at one and at two repeating units of
  depth (``specs.depth_unit``: a layer, or a hybrid or VLM group) and
  extended linearly to the model's depth;
* where the port can run one rank's step (``specs.trace_refusal``):
  that rank's step on the meta device over a planning mesh whose
  collectives a ``CountingComm`` tallies, ``traced: true`` and
  ``flops`` (the rank's), ``memory.temp_bytes`` (the peak of live
  storage the step makes beyond its arguments, :class:`LiveBytes`),
  ``memory.output_bytes`` and ``collectives`` by the reference's five
  kinds. Where the port computes differently on the card and on the CPU
  the trace takes the card's form (``layers.common.on_card``): the dry
  run sizes the card. Elsewhere those four are null and ``traced`` is
  false, with the reason in ``trace_refused``.

Any exception in a cell records ``status: "fail"`` with its traceback,
and the run exits 1. There is no HLO, so the reference's ``--save-hlo``
has no counterpart.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2_72b --shape decode_32k
  python -m repro_torch.launch.dryrun --all --both-meshes \\
      [--out experiments/dryrun]
  python -m repro_torch.launch.dryrun --all --smoke --mesh 4x2   # small
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import (SHAPES, all_cells, applicable_shapes,
                                      get_config, get_smoke_config)
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_production_mesh, parse_mesh_arg
from repro_torch.models.lm import QuantConfig
from repro_torch.parallel import mesh as PM

__all__ = ["LiveBytes", "count_flops", "global_flops", "trace_rank",
           "run_cell", "main"]


class LiveBytes(TorchDispatchMode):
    """The bytes of storage that the ops run under it hold alive: each
    op's output storage is added when it first appears and dropped when
    it dies (a weak reference to the storage, whose Python object lives
    exactly as long as the storage). ``keep``: tensors whose storages
    are not counted (the step's arguments; an in-place op or a view on
    them adds nothing). ``peak``: the most held at once."""

    def __init__(self, keep=()):
        super().__init__()
        self.live = self.peak = 0
        self._held: dict = {}
        for t in keep:
            self._hold(t.untyped_storage(), 0)

    def _hold(self, st, n: int) -> None:
        key = id(st)
        self._held[key] = n
        weakref.finalize(st, self._drop, key)
        self.live += n
        self.peak = max(self.peak, self.live)

    def _drop(self, key) -> None:
        self.live -= self._held.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                if id(st) not in self._held:
                    self._hold(st, st.nbytes())
        return out


def _storage_bytes(tree) -> int:
    """The bytes of the distinct storages of a tree's tensors."""
    seen = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[id(st)] = st.nbytes()
    return sum(seen.values())


def _bmm_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    """2·B·M·K·N, also for ``bmm.dtype`` (``torch.bmm(..., out_dtype=)``,
    the card's form of ``common.bmm_f32``), whose positional dtype the
    stock formula takes for its ``out_shape``."""
    b, m, k = a_shape
    return 2 * b * m * k * b_shape[-1]


def flop_counter() -> FlopCounterMode:
    """``FlopCounterMode`` with the bmm formula above."""
    return FlopCounterMode(display=False,
                           custom_mapping={torch.ops.aten.bmm: _bmm_flop})


def count_flops(fn, args) -> int:
    """``fn(args)`` under :func:`flop_counter` → its FLOPs."""
    with flop_counter() as fc:
        fn(args)
    return int(fc.get_total_flops())


def global_flops(arch: str, shape, cfg, quant: QuantConfig,
                 fsdp: bool = True) -> int:
    """One device's FLOPs of the cell's whole step at its global shape:
    the step traced at one and two units of depth (``specs.depth_unit``)
    and the difference, one unit's, added for each unit past the first
    (the count is linear in the units; the whole depth where it is two
    units or fewer)."""
    units = SP.depth_unit(cfg)[1]
    one = PM.planning_mesh({})

    def at(k):
        cell = SP.build_cell(arch, shape.name, one, quant=quant, fsdp=fsdp,
                             cfg=SP.with_depth(cfg, k), shape=shape)
        return count_flops(cell.step(), cell.args)
    if units <= 2:
        return at(units)
    f1, f2 = at(1), at(2)
    return f1 + (units - 1) * (f2 - f1)


def trace_rank(cell: SP.Cell, mesh, loss_chunk: int = 512,
               opt=None) -> dict:
    """One rank's ``train`` step of ``cell`` on ``mesh`` (a planning
    mesh), on the meta device, its collectives counted → ``flops``,
    ``temp_bytes`` (:class:`LiveBytes`' peak beyond the arguments),
    ``output_bytes`` (the distinct storages of what the step returns,
    the params and state it updates in place included) and
    ``collectives``. ``loss_chunk``/``opt``: the step's (default
    ``make_train_step``'s)."""
    comm = PM.CountingComm(mesh.shape)
    rmesh = PM.planning_mesh({a: mesh.shape[a] for a in mesh.axis_names},
                             comm)
    args = SP.rank_args(cell, rmesh)
    fn = cell.step(rmesh, loss_chunk, opt)
    with flop_counter() as fc, LiveBytes(tree_leaves(args)) as live:
        out = fn(args)
    return {"flops": int(fc.get_total_flops()), "temp_bytes": live.peak,
            "output_bytes": _storage_bytes(out),
            "collectives": comm.totals()}


def mesh_name(mesh) -> str:
    return "x".join(str(mesh.shape[a]) for a in mesh.axis_names)


def run_cell(arch: str, shape_name: str, mesh, out_dir: str,
             schedule: str = "split", fsdp: bool = True,
             smoke: bool = False, flops_seen: dict | None = None) -> dict:
    """One cell on ``mesh``: its record (module docstring), also written
    to ``out_dir`` as ``{arch}_{shape}_{mesh}_{schedule}.json``.
    ``flops_seen``: ``flops_global`` by (arch, shape) of cells already
    run on another mesh (it does not depend on the mesh)."""
    flops_seen = {} if flops_seen is None else flops_seen
    os.makedirs(out_dir, exist_ok=True)
    name = mesh_name(mesh)
    shape = (SP.SMOKE_SHAPES if smoke else SHAPES)[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": name,
           "kind": shape.kind, "schedule": schedule, "status": "fail",
           "smoke": smoke}
    t0 = time.perf_counter()
    try:
        cfg = (get_smoke_config if smoke else get_config)(arch)
        quant = QuantConfig(impl="ref", schedule=schedule)
        cell = SP.build_cell(arch, shape_name, mesh, quant=quant, fsdp=fsdp,
                             cfg=cfg, shape=shape)
        by = cell.argument_bytes_by(mesh)
        refused = SP.trace_refusal(cfg, cell.kind, mesh)
        rank = None if refused else trace_rank(cell, mesh)
        if (arch, shape_name) not in flops_seen:
            flops_seen[arch, shape_name] = global_flops(arch, shape, cfg,
                                                        quant, fsdp)
        rec.update({
            "status": "ok",
            "traced": rank is not None, "trace_refused": refused,
            "flops": rank and rank["flops"],
            "flops_global": flops_seen[arch, shape_name],
            "memory": {"argument_bytes": sum(by.values()),
                       "output_bytes": rank and rank["output_bytes"],
                       "temp_bytes": rank and rank["temp_bytes"]},
            "argument_bytes_by": by,
            "collectives": rank and rank["collectives"],
        })
    except Exception as e:  # noqa: BLE001 — record and go on with the sweep
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["trace_s"] = round(time.perf_counter() - t0, 2)
    fname = f"{arch}_{shape_name}_{name}_{schedule}.json"
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def _line(rec: dict) -> str:
    gb = 1e9
    if rec["status"] != "ok":
        return (f"[fail] {rec['arch']} {rec['shape']} {rec['mesh']} "
                f"s={rec['trace_s']} :: {rec.get('error', '')[:200]}")
    mem = rec["memory"]
    traced = (f" temp={mem['temp_bytes'] / gb:.4f}GB rank_tflops="
              f"{rec['flops'] / 1e12:.2f} coll="
              f"{rec['collectives']['total_bytes'] / gb:.4f}GB"
              if rec["traced"] else " traced=false")
    return (f"[ok] {rec['arch']} {rec['shape']} {rec['mesh']} "
            f"args={mem['argument_bytes'] / gb:.4f}GB "
            f"tflops_global={rec['flops_global'] / 1e12:.1f}{traced} "
            f"s={rec['trace_s']}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--schedule", type=str, default="split",
                    choices=["split", "mixed"])
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--out", type=str, default="experiments/dryrun")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke configs at small shapes "
                         "(specs.SMOKE_SHAPES): a quick rehearsal")
    ap.add_argument("--mesh", type=str, default=None, metavar="DxM",
                    help="a (data, model) planning mesh in place of the "
                         "production ones")
    args = ap.parse_args(argv)

    if args.all:
        cells = all_cells()
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    elif args.arch:
        cells = [(args.arch, s)
                 for s in applicable_shapes(get_config(args.arch))]
    else:
        ap.error("need --all or --arch [--shape]")
    if args.mesh:
        d, m = parse_mesh_arg(args.mesh)
        meshes = [PM.planning_mesh({"data": d, "model": m})]
    else:
        meshes = [make_production_mesh(multi_pod=mp) for mp in
                  ([False, True] if args.both_meshes else [args.multi_pod])]
    failures = 0
    flops_seen: dict = {}
    t0 = time.perf_counter()
    for arch, shape in cells:
        for mesh in meshes:
            rec = run_cell(arch, shape, mesh, args.out,
                           schedule=args.schedule, fsdp=not args.no_fsdp,
                           smoke=args.smoke, flops_seen=flops_seen)
            print(_line(rec), flush=True)
            failures += rec["status"] != "ok"
    print(f"[dryrun] {len(cells) * len(meshes)} records, {failures} "
          f"failed, {time.perf_counter() - t0:.1f} s", flush=True)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
