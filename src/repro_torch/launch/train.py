"""Training launcher of the port (``repro/launch/train.py``): seeded fp
params (``LM.init_fp``), AdamW under a cosine schedule, the synthetic
stream of ``data/pipeline.py``, on one device or over a ``(data, model)``
mesh.

Fault tolerance, as the reference's:

* auto-resume from the newest complete checkpoint in ``--ckpt-dir``;
* a background checkpoint every ``--ckpt-every`` steps (keeping the
  last 3) and a final one at ``--steps``;
* the data stream is a pure function of the step, so a restarted run
  replays exactly the remaining stream (the audio frames and image
  embeddings too: ``np.random.default_rng(step)``);
* a per-step wall-clock watchdog prints ``[straggler]`` for a step
  slower than the mean + 4σ of the steps before it (after 10 steps).

It prints ``step N: loss=… ce=… gnorm=… (…s)`` every ``--log-every``
steps and at the last, then ``done``. Without ``--device cpu`` it needs a
card.

``--data D --model M`` (D·M > 1; dense and moe, the latter at D = 1)
trains over a ``(data, model)`` mesh under the reference's
``TRAIN_RULES``: it prints ``[mesh] (data=D, model=M) over N <device>
rank(s)`` and spawns D·M ranks (``launch/mesh.spawn``: one process a
card, NCCL, or gloo processes on the CPU), each running the loop above
on its shards, rank 0 printing and writing the checkpoints, which
restore on any mesh. On the card a mesh larger than the visible cards
shrinks before the ranks start (``launch/mesh.fit_mesh``), as the
reference's ``make_local_mesh(..., allow_shrink=True)`` does, with a
warning.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_8b \\
      --smoke --steps 20 --batch 8 --seq 128 --device cpu \\
      --ckpt-dir /tmp/ckpt --ckpt-every 10 [--data 2 --model 2]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticLMData
from repro_torch.launch.mesh import fit_mesh, make_local_mesh, spawn
from repro_torch.layers.common import resolve_device
from repro_torch.models.lm import LM
from repro_torch.training import checkpoint as CKPT
from repro_torch.training import optimizer as OPT
from repro_torch.training.train_loop import make_train_step


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", type=str, default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--data", type=int, default=1, help="data mesh axis")
    ap.add_argument("--model", type=int, default=1, help="model mesh axis")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; a machine without a "
                         "card needs --device cpu)")
    return ap.parse_args(argv)


def step_batch(data: SyntheticLMData, cfg, step: int, batch: int,
               seq: int, device) -> dict:
    """The step's tokens and labels, and the audio frames or image
    embeddings the reference's launcher draws from
    ``np.random.default_rng(step)``."""
    out = data.batch_for_step(step, device)
    if cfg.family in ("audio", "vlm"):
        rng = np.random.default_rng(step)
        key, shape = (("frames", (batch, seq, cfg.d_model))
                      if cfg.family == "audio" else
                      ("image_embeds", (batch, cfg.num_image_tokens,
                                        cfg.d_model)))
        out[key] = torch.from_numpy(
            rng.normal(size=shape).astype(np.float32)).to(device)
    return out


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    data, model = fit_mesh(args.data, args.model, device.type,
                           allow_shrink=True)
    if data * model == 1:
        return train(args, cfg, device)
    world = data * model
    print(f"[mesh] (data={data}, model={model}) over {world} "
          f"{device.type} rank(s)", flush=True)
    spawn(_train_rank, world, (args, cfg, data, model),
          device_type=device.type, timeout_s=24 * 3600.0,
          collective_timeout_s=600.0,
          threads=(max(1, torch.get_num_threads() // world)
                   if device.type == "cpu" else 0))
    return None


def _train_rank(rank: int, world: int, device, args, cfg, data: int,
                model: int) -> None:
    """One rank of ``--data D --model M``: :func:`train` on its mesh."""
    train(args, cfg, device, make_local_mesh(data, model))


def train(args, cfg, device, mesh=None) -> None:
    """The reference's loop on one device or on this rank of ``mesh``
    (printing on rank 0 only)."""
    log = (print if mesh is None or mesh.rank == 0
           else (lambda *a, **k: None))
    lm = LM(cfg)
    specs = lm.train_specs(mesh) if mesh is not None else None
    tree_specs = (specs, OPT.state_specs(specs)) if mesh is not None \
        else None
    params = lm.init_fp(seed=args.seed, device=device, mesh=mesh)
    opt_cfg = OPT.AdamWConfig(
        lr=args.lr, schedule=OPT.cosine_schedule(args.warmup, args.steps))
    opt_state = OPT.adamw_init(params)
    step_fn = make_train_step(lm, opt_cfg, mesh=mesh, specs=specs)

    start_step = 0
    if args.ckpt_dir and CKPT.latest_step(args.ckpt_dir) is not None:
        (params, opt_state), start_step = CKPT.restore(
            args.ckpt_dir, (params, opt_state), device=device,
            shardings=tree_specs, mesh=mesh)
        log(f"[resume] restored step {start_step}", flush=True)

    data = SyntheticLMData(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=args.seed))
    durations = []
    for step in range(start_step, args.steps):
        t0 = time.time()
        batch = step_batch(data, cfg, step, args.batch, args.seq, device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.time() - t0
        durations.append(dt)
        if len(durations) > 10:
            mu = float(np.mean(durations[:-1]))
            sd = float(np.std(durations[:-1])) + 1e-6
            if dt > mu + 4 * sd:
                log(f"[straggler] step {step} took {dt:.2f}s "
                    f"(mean {mu:.2f}s)", flush=True)
        if step % args.log_every == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            log(f"step {step}: loss={m['loss']:.4f} ce={m['ce']:.4f} "
                f"gnorm={m['grad_norm']:.3f} ({dt:.2f}s)", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            CKPT.save_async(args.ckpt_dir, step + 1, (params, opt_state),
                            mesh, tree_specs)
            if mesh is None or mesh.rank == 0:
                CKPT.cleanup(args.ckpt_dir, keep_last=3)
    if args.ckpt_dir:
        CKPT.wait_async()
        CKPT.save(args.ckpt_dir, args.steps, (params, opt_state), mesh,
                  tree_specs)
    log("done", flush=True)


if __name__ == "__main__":
    main()
