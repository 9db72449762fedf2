"""The training-mesh tests' workloads, run by gloo ranks that
``launch.mesh.spawn`` starts and, for the same ``(data, model)`` mesh, by
``parallel.mesh.serial_train``'s threads in the test process. This module
imports only the port: a spawned rank imports it, and no ``repro`` or JAX
module.

:func:`run_steps` trains the seeded fp model on one rank's shards and
returns what the tests hold bit for bit: each step's metrics (their f32
bits) and the final params, AdamW moments and (compressed) carried error
as this rank's shards.
"""
import sys

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticLMData
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.lm import LM
from repro_torch.parallel import sharding as SH
from repro_torch.training import checkpoint as CKPT
from repro_torch.training import compression as GC
from repro_torch.training import optimizer as OPT
from repro_torch.training import train_loop as TL

B, S, CHUNK, LR = 4, 24, 16, 1e-3     # two loss chunks, the second padded
METRICS = ("loss", "ce", "aux", "grad_norm", "lr")


def batches(cfg, steps: int) -> list:
    """The launcher's stream for ``steps`` steps, a partial mask on the
    last row."""
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                      global_batch=B))
    out = []
    for step in range(steps):
        b = data.batch_for_step(step, "cpu")
        b["mask"][-1, S - 5:] = 0
        out.append(b)
    return out


def opt_config():
    return OPT.AdamWConfig(lr=LR, schedule=OPT.cosine_schedule(1, 4))


def run_steps(mesh, arch: str, steps: int, compressed: bool,
              params=None, seed: int = 0) -> dict:
    """``steps`` train steps of ``arch``'s smoke model from ``init_fp(seed)``
    (or from the whole ``params``, sharded here) on ``mesh`` (None: one
    device) → {"metrics": [[f32 bits of METRICS] a step], "state":
    (params, opt_state[, ef]) of this rank}."""
    cfg = get_smoke_config(arch)
    lm = LM(cfg)
    specs = lm.train_specs(mesh) if mesh is not None else None
    if params is None:
        params = lm.init_fp(seed=seed, device="cpu", mesh=mesh)
    elif mesh is not None:
        params = SH.shard_tree(params, specs, mesh)
    state = OPT.adamw_init(params)
    if compressed:
        step = GC.make_compressed_train_step(lm, opt_config(),
                                             loss_chunk=CHUNK, mesh=mesh,
                                             specs=specs)
        ef = GC.init_error_feedback(params)
    else:
        step = TL.make_train_step(lm, opt_config(), loss_chunk=CHUNK,
                                  mesh=mesh, specs=specs)
    metrics = []
    for b in batches(cfg, steps):
        if compressed:
            params, state, ef, m = step(params, state, ef, b)
        else:
            params, state, m = step(params, state, b)
        metrics.append(torch.stack([m[k].float() for k in METRICS])
                       .view(torch.int32).tolist())
    return {"metrics": metrics,
            "state": (params, state) + ((ef,) if compressed else ())}


def whole(leaves: list, arch: str, data: int, model: int,
          paths: list) -> dict:
    """Every rank's state leaves (rank order; in ``CKPT.flatten`` order,
    named by ``paths``) → {key path: the whole tensor}, each leaf's shards
    concatenated along its sharded dimensions."""
    from repro_torch.parallel.mesh import Mesh
    specs = LM(get_smoke_config(arch)).train_specs(
        Mesh(shape={"data": data, "model": model}))
    by_path = {}
    for part, sp in (("0", specs), ("1", OPT.state_specs(specs)),
                     ("2", specs)):
        cfg = LM(get_smoke_config(arch)).init_fp(device="meta")
        tree = cfg if part != "1" else OPT.adamw_init(cfg)
        for (p, _), s in zip(CKPT.flatten(tree), CKPT.flatten_specs(tree, sp)):
            by_path[f"{part}/{p}" if p else part] = s
    out = {}
    for i, path in enumerate(paths):
        spec = by_path[path]
        rows = []
        for d in range(data):
            row = [leaves[d * model + m][i] for m in range(model)]
            rows.append(torch.cat(row, spec.index("model"))
                        if "model" in spec else row[0])
        out[path] = (torch.cat(rows, spec.index("data")) if "data" in spec
                     else rows[0])
    return out


def rank_jobs(rank, world, device, data, model, jobs) -> list:
    """A spawned rank of a ``(data, model)`` mesh running ``jobs`` in
    order, each ``("steps", arch, steps, compressed, save_dir)`` (the
    final params and AdamW state saved from the mesh when ``save_dir``
    is given) or ``("restore", arch, ckpt_dir)`` → per job its result
    (metrics and :func:`host` state, or :func:`restore_whole`), then the
    reference's modules the rank loaded (none)."""
    mesh = make_local_mesh(data, model)
    out = []
    for job in jobs:
        if job[0] == "restore":
            out.append(restore_whole(mesh, job[1], job[2]))
            continue
        _, arch, steps, compressed, save_dir = job
        res = run_steps(mesh, arch, steps, compressed)
        if save_dir is not None:
            specs = LM(get_smoke_config(arch)).train_specs(mesh)
            CKPT.save(save_dir, steps, res["state"][:2], mesh,
                      (specs, OPT.state_specs(specs)))
        out.append({"metrics": res["metrics"], "state": host(res["state"])})
    return out + [foreign_modules()]


def host(state) -> list:
    """(key path, numpy copy) of every leaf of a state tree: what a rank
    returns through the process queue."""
    return [(p, t.detach().numpy().copy()) for p, t in CKPT.flatten(state)]


def restore_whole(mesh, arch: str, ckpt: str) -> list:
    """The newest checkpoint in ``ckpt`` restored onto ``mesh``, each leaf
    gathered whole again → [(key path, tensor)]."""
    lm = LM(get_smoke_config(arch))
    specs = lm.train_specs(mesh)
    params = lm.init_fp(seed=1, device="cpu", mesh=mesh)
    tree_specs = (specs, OPT.state_specs(specs))
    tree, _ = CKPT.restore(ckpt, (params, OPT.adamw_init(params)),
                           device="cpu", shardings=tree_specs, mesh=mesh)
    flat = CKPT.flatten(tree)
    specs_flat = CKPT.flatten_specs(tree, tree_specs)
    return [(path, SH.unshard(t, s, mesh).numpy().copy())
            for (path, t), s in zip(flat, specs_flat)]


def foreign_modules() -> list:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("repro", "jax", "jaxlib"))


