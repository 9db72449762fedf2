"""Serving launcher of the port: random seeded W4 weights and the
request-lifecycle engine over a synthetic request trace (the single-engine
path of ``repro/launch/serve.py``).

Requests go through ``Engine.submit`` with per-request
:class:`SamplingParams`: greedy unless ``--temperature`` > 0 (then from
the ``--top-k`` best, keyed by request and position), and with
``--speculation K`` each decode row drafts K tokens by prompt lookup and
verifies them in one forward. ``--schedule`` picks the W4Ax GEMM
schedule (``split``: the W4A4 and W4A8 kernels per projection; ``mixed``:
the paper's single kernel), ``--impl`` the kernels or their plain versions,
``--stream`` prints tokens as ``step()`` emits them, ``--prefix-cache``
toggles shared-prompt page reuse (``--shared-prefix`` sets how many prompt
tokens the trace shares, ``--prefix-cache-max-bytes`` caps the reclaimable
LRU), ``--abort-every N`` cancels every Nth request after its first token,
``--arrival-every N`` submits one request every N steps. Robustness:
``--deadline-ms``/``--ttft-ms`` set per-request deadlines (expired requests
end ``TIMED_OUT``) and ``--max-waiting`` bounds the waiting queue (submits
past it end ``FAILED("queue_full")``, preemption victims are shed),
``--inject-faults SPEC`` arms a fault schedule (``serving/faults.py``
grammar, e.g. ``"forward:step=3,action=nan;sample:nth=2"``) and
``--sanitize`` runs the step-boundary sanitizers after every step.
``--snapshot-every N`` rides a journaled :class:`~repro_torch.serving.
recovery.RecoveryLog` along with the run (a full engine snapshot every N
steps and a per-token event journal; the ``[recovery]`` line), on one
device or over ``--mesh 1xM`` (every rank's log in lockstep).

Replicated serving (``serving/replication.py``): ``--replicas N`` runs N
engine replicas behind a :class:`ReplicaGroup` (least-loaded routing, a
health check every step, the RecoveryLog artifacts shipped after every
healthy step), on the one device sharing one set of weights, or with
``--mesh 1xM`` (M > 1) each replica over its own M ranks (N·M processes,
one card each: ``launch/mesh.py:make_replica_meshes``; the reference's
``[mesh]`` line first). ``--failover standby|migrate`` picks the death
policy and ``--kill-replica-at STEP`` (``--kill-replica IDX``) arms the
``crash`` fault on one replica; the summary prints the reference's
``[done]``, ``[group]`` (failovers, migrations, health), ``[robust]``,
``[faults]`` and ``[death]`` lines, then ``[states]``.

The summary prints the reference's ``[done]``, ``[cache]``, ``[robust]``,
``[slo]`` (TTFT and TPOT mean and p95 from the lifecycle stamps) and
``[sched]`` lines without the fields of features the port lacks (the
reference's ``traces=`` counts jit compiles; the port runs eagerly, so
``forwards=`` stands alone), ``[faults]`` (armed, fired, pending) when a
schedule is armed, ``[sched] speculation:`` (drafted, accepted,
acceptance, rolled back, no-ops, draft errors) when drafting is on, then
a ``[states]`` line: requests by
terminal state, stop reasons, and the tokens of each finished request.
Prompts come from ``np.random.default_rng(seed)`` in the reference's order,
so both launchers serve the same prompts.

Tensor-parallel serving: ``--mesh 1xM`` (M > 1) starts M ranks, one
process each (``launch/mesh.py``: one card each and NCCL on the card,
gloo under ``--device cpu``), every one making its shard of the seeded
weights block by block and running the same trace on its
:class:`Engine` shard; rank 0 alone prints. A rank that fails stops
them all, and so does a collective left waiting 600 s for the other
ranks (the run's own limit is a day). ``--head-dim`` overrides the
config's head_dim (the smoke configs' q_dim of 128 is one quant block,
too narrow for row-parallel shards: ``--smoke --mesh 1x2 --head-dim
64``). A data axis above 1 raises: not ported (ROADMAP Queue 1, item
11).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch llama3_8b --smoke --requests 4 --max-new 6 \\
      --int4-fraction 0.5 --schedule mixed
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_8b \\
      --schedule mixed --requests 8 --prompt-len 512 --max-new 32 \\
      --prefill-chunk 256 --shared-prefix 128 --abort-every 4 \\
      --max-waiting 6
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_8b \\
      --requests 8 --prompt-len 512 --max-new 32 --prefill-chunk 256 \\
      --temperature 0.8 --top-k 40 --speculation 3 --sanitize
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch llama3_8b --smoke --requests 4 --max-new 8 --replicas 2 \
      --failover standby --kill-replica-at 3 --snapshot-every 2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_70b \\
      --requests 8 --prompt-len 512 --max-new 32 --prefill-chunk 256
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_8b \\
      --mesh 1x4 --requests 8 --prompt-len 512 --max-new 32
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch llama3_8b --smoke --mesh 1x2 --head-dim 64 --int4-fraction 1.0
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch llama3_8b --smoke --mesh 1x2 --head-dim 64 --int4-fraction 1.0 \\
      --replicas 2 --failover migrate --kill-replica-at 4 --snapshot-every 2
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import io
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ARCH_IDS
from repro_torch.kernels import _build
from repro_torch.launch.mesh import (make_local_mesh, make_replica_meshes,
                                     parse_mesh_arg, spawn)
from repro_torch.models.lm import LM, QuantConfig
from repro_torch.serving.engine import Engine, EngineConfig, SamplingParams
from repro_torch.serving.faults import Fault, FaultInjector
from repro_torch.serving.recovery import RecoveryLog
from repro_torch.serving.replication import ReplicaGroup

__all__ = ["main", "build_parser"]


def _ms_stats(xs: list) -> str:
    """Mean and p95 of a latency sample in ms (or 'n/a')."""
    if not xs:
        return "n/a"
    arr = np.asarray(xs) * 1000.0
    return f"mean {arr.mean():.1f}ms p95 {np.percentile(arr, 95):.1f}ms"


def _print_states(ends: list):
    """The ``[states]`` line from (state, stop reason, tokens) per
    request: requests by terminal state, stop reasons, and the tokens of
    each finished request."""
    states = collections.Counter(st for st, _, _ in ends)
    reasons = collections.Counter(why for _, why, _ in ends if why)
    done_tokens = [n for st, _, n in ends if st == "finished"]
    print("[states] " + " ".join(f"{k}={v}" for k, v in sorted(
              states.items()))
          + " | stop reasons: " + (" ".join(
              f"{k}={v}" for k, v in sorted(reasons.items())) or "none")
          + " | tokens of finished requests: "
          + (",".join(map(str, done_tokens)) or "none"), flush=True)


def _engine_config(args) -> EngineConfig:
    """The engine's configuration from the flags. A replica group arms
    fault schedules through one injector per replica (so
    ``--kill-replica-at`` targets one replica), never ``inject_faults``."""
    return EngineConfig(
        max_batch=args.max_batch, num_pages=args.pages,
        page_size=args.page_size, temperature=args.temperature,
        top_k=args.top_k, prefill_mode=args.prefill_mode,
        prefill_chunk_tokens=args.prefill_chunk, kv_range=args.kv_range,
        unified_step=(args.step_mode == "unified"),
        prefix_cache=(args.prefix_cache == "on"),
        attention_schedule=args.attention_schedule,
        prefix_cache_max_bytes=(args.prefix_cache_max_bytes or None),
        max_waiting=(args.max_waiting or None),
        inject_faults=(args.inject_faults or None
                       if args.replicas <= 1 else None),
        sanitize=args.sanitize)


def _trace(args, cfg):
    """The per-request sampling parameters and the arrival trace: the
    synthetic prompts, drawn from ``--seed`` in the reference's order,
    request i submitted at step i·``--arrival-every``."""
    rng = np.random.default_rng(args.seed)
    shared = rng.integers(0, cfg.vocab_size,
                          size=args.shared_prefix).tolist()
    if 0 < args.shared_prefix < args.page_size:
        print(f"[warn] --shared-prefix {args.shared_prefix} < --page-size "
              f"{args.page_size}: prefix matching is full-page-granular, "
              "so the shared prefix can never hit", flush=True)
    sp = SamplingParams(max_new_tokens=args.max_new,
                        temperature=args.temperature, top_k=args.top_k,
                        speculation=args.speculation,
                        deadline_ms=(args.deadline_ms or None),
                        ttft_ms=(args.ttft_ms or None))
    prompts = []
    for _ in range(args.requests):
        plen = int(rng.integers(args.prompt_len // 2, args.prompt_len + 1))
        prompts.append(shared
                       + rng.integers(0, cfg.vocab_size, size=plen).tolist())
    return sp, [(i * args.arrival_every, p) for i, p in enumerate(prompts)]


def _run_group(args, cfg, params, quant, ecfg, sp, pending, meshes=None,
               param_axes=None) -> ReplicaGroup:
    """Serve the trace through a ReplicaGroup (``--replicas N``; over
    ``meshes`` on every rank of ``--mesh 1xM``) and print the reference's
    group summary → the group."""
    faults = []
    for i in range(args.replicas):
        inj = (FaultInjector.from_spec(args.inject_faults)
               if args.inject_faults else FaultInjector())
        if args.kill_replica_at and i == args.kill_replica:
            inj.faults.append(Fault("crash", step=args.kill_replica_at))
        faults.append(inj)
    group = ReplicaGroup(
        cfg, params, quant, ecfg, replicas=args.replicas,
        failover=args.failover, snapshot_every=(args.snapshot_every or 4),
        faults=faults, device=args.device, meshes=meshes,
        param_axes=param_axes)

    def stream_cb(ev):
        # the ordinal from the group's record: a migrated request's
        # engine-local count restarts after the fold
        if ev.token is not None:
            n = len(group.delivered.get(ev.request_id, []))
            print(f"  [stream] req {ev.request_id} +tok {ev.token} "
                  f"(#{n})", flush=True)
        elif ev.finished:
            print(f"  [stream] req {ev.request_id} {ev.state.value}"
                  + (f" ({ev.stop_reason})" if ev.stop_reason else ""),
                  flush=True)

    t0 = time.time()
    gsteps = 0
    while (pending or group.has_work) and gsteps < 10_000:
        while pending and pending[0][0] <= gsteps:
            _, prompt = pending.pop(0)
            group.submit(prompt, sp,
                         on_event=stream_cb if args.stream else None)
        group.step()
        gsteps += 1
    device = params["embed"]["table"].device
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0

    total_tokens = sum(len(v) for v in group.delivered.values())
    print(f"[done] {len(group.terminals)} requests, {total_tokens} "
          f"tokens in {dt:.1f}s → {total_tokens / max(dt, 1e-9):.1f} tok/s "
          f"(group_steps={gsteps}, replica_steps={group.replica_steps})",
          flush=True)
    c = group.counters()
    health = " ".join(f"r{i}={h}" for i, h in sorted(c["health"].items()))
    print(f"[group] replicas={args.replicas} failover={args.failover} "
          f"failovers={c['failovers']} "
          f"migrated={c['migrated_requests']} "
          f"replica_steps={c['replica_steps']} "
          f"dup_suppressed={c['duplicates_suppressed']} "
          f"internal_errors={c['internal_errors']} {health}", flush=True)
    stats = group.replica_stats()
    live = [stats[r.idx] for r in group.replicas if r.alive]

    def total(key):
        return sum(st[key] for st in live)

    print(f"[robust] failed={total('failed')} timed_out="
          f"{total('timed_out')} shed={total('shed')} rejected="
          f"{total('rejected')} internal_errors={c['internal_errors']} "
          f"sanitize_checks={total('sanitize_checks')}", flush=True)
    for idx, st in enumerate(stats):
        if st["fired"]:
            fired = [f"{p}:{a}@step{s}" for p, a, s in st["fired"]]
            print(f"[faults] replica {idx}: fired {', '.join(fired)}",
                  flush=True)
    for idx, why, step in group.deaths:
        print(f"[death] replica {idx} at engine step {step} ({why})",
              flush=True)
    _print_states([(ev.state.value, ev.stop_reason,
                    len(group.delivered.get(rid, [])))
                   for rid, ev in sorted(group.terminals.items())])
    return group


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True,
                    help=f"one of {', '.join(ARCH_IDS)}")
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's reduced smoke configuration")
    ap.add_argument("--device", default="cuda",
                    help="where the weights, pools and kernels live; a "
                         "machine without a card needs --device cpu")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--pages", type=int, default=256)
    ap.add_argument("--page-size", type=int, default=32)
    ap.add_argument("--int4-fraction", type=float, default=0.875)
    ap.add_argument("--schedule", default="split", choices=["split", "mixed"],
                    help="W4Ax GEMM schedule: the W4A4 + W4A8 kernel pair "
                         "(split) or the single mixed kernel")
    ap.add_argument("--impl", default="auto", choices=["auto", "cuda", "ref"],
                    help="kernels (cuda; auto = on a CUDA tensor) or their "
                         "plain versions (ref)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="per-request SamplingParams.temperature (0 = "
                         "greedy)")
    ap.add_argument("--top-k", type=int, default=40,
                    help="per-request SamplingParams.top_k")
    ap.add_argument("--speculation", type=int, default=0,
                    help="per-request SamplingParams.speculation: draft K "
                         "tokens per decode row by prompt lookup and "
                         "verify them in one forward (0 = off)")
    ap.add_argument("--prefill-mode", default="chunked",
                    choices=["chunked", "whole"])
    ap.add_argument("--prefill-chunk", type=int, default=64,
                    help="per-step token budget (prompt chunks + decode)")
    ap.add_argument("--kv-range", type=float, default=16.0,
                    help="calibrated |k|,|v| range of the int4 KV scales")
    ap.add_argument("--step-mode", default="unified",
                    choices=["unified", "split"],
                    help="unified: ONE forward per step; split: separate "
                         "prefill and decode forwards (baseline)")
    ap.add_argument("--attention-schedule", default="work_queue",
                    choices=["work_queue", "dense"])
    ap.add_argument("--prefix-cache", default="on", choices=["on", "off"])
    ap.add_argument("--prefix-cache-max-bytes", type=int, default=0,
                    help="byte cap on the reclaimable prefix-page LRU "
                         "(0 = unlimited)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prompt tokens shared by every request")
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as they are emitted")
    ap.add_argument("--abort-every", type=int, default=0,
                    help="abort every Nth request after its first token "
                         "(0 = never)")
    ap.add_argument("--arrival-every", type=int, default=0,
                    help="submit one request every N engine steps "
                         "(0 = all up front)")
    ap.add_argument("--deadline-ms", type=float, default=0,
                    help="per-request deadline from submit (0 = none)")
    ap.add_argument("--ttft-ms", type=float, default=0,
                    help="per-request first-token budget (0 = none)")
    ap.add_argument("--max-waiting", type=int, default=0,
                    help="bound on the waiting queue (0 = unbounded)")
    ap.add_argument("--inject-faults", default="",
                    help="fault schedule (serving/faults.py grammar), e.g. "
                         "'forward:step=3,action=nan;alloc_page:nth=20'")
    ap.add_argument("--sanitize", action="store_true",
                    help="run the step-boundary sanitizers after every "
                         "step; a broken invariant aborts the run")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="journaled crash recovery: a full engine snapshot "
                         "every N steps and a per-token event journal (0 = "
                         "off); with --replicas the group's interval "
                         "(default 4)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="run N engine replicas behind a ReplicaGroup "
                         "(pools and scheduler per replica; least-loaded "
                         "routing, health checks, failover): on the one "
                         "device with the weights shared, or with --mesh "
                         "1xM each over its own M ranks")
    ap.add_argument("--failover", default="migrate",
                    choices=["standby", "migrate"],
                    help="replica-death policy: promote an engine resumed "
                         "from the shipped RecoveryLog artifacts into the "
                         "dead slot, or migrate the dead replica's "
                         "in-flight requests to the survivors")
    ap.add_argument("--kill-replica-at", type=int, default=0,
                    help="kill one replica before its Nth engine step (the "
                         "'crash' fault point; 0 = never)")
    ap.add_argument("--kill-replica", type=int, default=0,
                    help="which replica --kill-replica-at kills")
    ap.add_argument("--mesh", default="1x1", metavar="DxM",
                    help="(data, model) mesh for tensor-parallel serving: "
                         "1xM shards heads, the MLP and the KV pools over "
                         "M ranks, one process and one card each (gloo "
                         "ranks under --device cpu). 1x1 = one device "
                         "(default). More ranks than visible cards is an "
                         "error, never clamped")
    ap.add_argument("--head-dim", type=int, default=0,
                    help="override cfg.head_dim (0 = keep). The smoke "
                         "configs use head_dim=32 → q_dim=128, too small "
                         "for row-parallel TP (shards must hold whole "
                         "128-channel quant blocks) — pass 64 with "
                         "--smoke --mesh 1x2")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def _model(args):
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.head_dim:
        cfg = dataclasses.replace(cfg, head_dim=args.head_dim)
    quant = QuantConfig(int4_fraction=args.int4_fraction,
                        schedule=args.schedule, impl=args.impl)
    return cfg, quant


def _init_line(args, cfg, t0: float, where: str) -> None:
    print(f"[init] {cfg.name} ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}) random W4 weights from seed {args.seed} on "
          f"{where} in {time.time() - t0:.1f}s; schedule={args.schedule} "
          f"impl={args.impl}", flush=True)


def main(argv=None):
    """Serve the synthetic trace and print the summary → the engine (the
    replica group with ``--replicas`` > 1; under ``--mesh 1xM``, M > 1,
    every rank's ``Engine.counters()``, or with ``--replicas`` every
    rank's ``ReplicaGroup.counters()``)."""
    args = build_parser().parse_args(argv)
    data, model = parse_mesh_arg(args.mesh)
    if data != 1:
        raise NotImplementedError(
            f"--mesh {args.mesh}: a data axis above 1 is not ported "
            f"(ROADMAP Queue 1 item 11: the data axis); use --mesh 1xM")
    cfg, quant = _model(args)
    if model > 1:
        device = torch.device(args.device)
        if device.type == "cuda":
            _build.build()          # once, before the ranks start
        world = model * max(args.replicas, 1)
        if args.replicas > 1:
            print(f"[mesh] {args.replicas} replica(s) x (data=1, "
                  f"model={model}) over {world} {device.type} rank(s)",
                  flush=True)
        else:
            print(f"[mesh] (data=1, model={model}) over {model} "
                  f"{device.type} rank(s)", flush=True)
        return spawn(_serve_rank, world, (args, model),
                     device_type=device.type, timeout_s=24 * 3600.0,
                     collective_timeout_s=600.0,
                     threads=(max(1, torch.get_num_threads() // world)
                              if device.type == "cpu" else 0))
    t0 = time.time()
    params = LM(cfg).init(seed=args.seed, device=args.device)
    where = (torch.cuda.get_device_name(torch.device(args.device))
             if torch.device(args.device).type == "cuda" else args.device)
    _init_line(args, cfg, t0, where)
    ecfg = _engine_config(args)
    sp, pending = _trace(args, cfg)
    if args.replicas > 1:
        return _run_group(args, cfg, params, quant, ecfg, sp, pending)
    return _serve(args, Engine(cfg, params, quant, ecfg, device=args.device),
                  sp, pending)


def _serve_rank(rank: int, world: int, device, args, model: int) -> dict:
    """One rank of ``--mesh 1xM`` (with ``--replicas N``, of N meshes of
    M ranks): its shard of the seeded weights, the same trace as every
    rank, the summary printed on rank 0 only → ``Engine.counters()`` (the
    group's ``counters()``)."""
    cfg, quant = _model(args)
    if args.replicas > 1:
        meshes = make_replica_meshes(args.replicas, model)
        mesh = meshes[rank // model]
    else:
        mesh = make_local_mesh(1, world)
    quiet = contextlib.redirect_stdout(io.StringIO()) if rank else \
        contextlib.nullcontext()
    with quiet:
        t0 = time.time()
        lm = LM(cfg)
        params = lm.init(seed=args.seed, device=device, mesh=mesh)
        where = (torch.cuda.get_device_name(device) if device.type == "cuda"
                 else str(device))
        _init_line(args, cfg, t0, f"{where} (rank {rank} of {world})")
        sp, pending = _trace(args, cfg)
        if args.replicas > 1:
            return _run_group(args, cfg, params, quant, _engine_config(args),
                              sp, pending, meshes=meshes,
                              param_axes=lm.axes(params)).counters()
        eng = Engine(cfg, params, quant, _engine_config(args), device=device,
                     mesh=mesh, param_axes=lm.axes(params))
        _serve(args, eng, sp, pending)
    return eng.counters()


def _serve(args, eng: Engine, sp, pending) -> Engine:
    """Step one engine through the trace and print its summary → it."""
    log = None
    if args.snapshot_every:
        log = RecoveryLog(eng, snapshot_every=args.snapshot_every)
    abort_ids: set = set()
    submitted = 0

    t0 = time.time()
    while (pending or eng.sched.has_work) and eng.steps < 10_000:
        while pending and pending[0][0] <= eng.steps:
            _, prompt = pending.pop(0)
            h = eng.submit(prompt, sp)
            submitted += 1
            if args.abort_every and submitted % args.abort_every == 0:
                abort_ids.add(h.request_id)
        if log is not None:
            evs = log.step()
        else:
            eng.step()
            evs = eng.events()
        for ev in evs:
            if ev.token is not None and ev.request_id in abort_ids:
                eng.abort(ev.request_id)       # cancel after first token
                abort_ids.discard(ev.request_id)
            if args.stream:
                if ev.token is not None:
                    print(f"  [stream] req {ev.request_id} +tok {ev.token} "
                          f"(#{ev.num_generated})", flush=True)
                elif ev.finished:
                    print(f"  [stream] req {ev.request_id} "
                          f"{ev.state.value}"
                          + (f" ({ev.stop_reason})" if ev.stop_reason
                             else ""), flush=True)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.time() - t0

    finished = eng.sched.finished
    total_tokens = sum(len(r.generated) for r in finished)
    prompt_tokens = eng.prefill_tokens + eng.prefix_hit_tokens
    hit_rate = eng.prefix_hit_tokens / prompt_tokens if prompt_tokens else 0.0
    print(f"[done] {len(finished)} requests, {total_tokens} tokens in "
          f"{dt:.1f}s → {total_tokens / max(dt, 1e-9):.1f} tok/s "
          f"(steps={eng.steps}, forwards={eng.forward_calls}, "
          f"preemptions={eng.sched.preemptions})", flush=True)
    print(f"[cache] prefix hit rate {hit_rate:.0%} "
          f"({eng.prefix_hit_tokens}/{prompt_tokens} prompt tokens served "
          f"from published pages); evicted={eng.cache.prefix_evicted_pages} "
          f"pages; reclaimable={eng.cache.prefix_reclaimable_bytes}B; "
          f"aborted={eng.aborted_count}", flush=True)
    print(f"[robust] failed={eng.failed_count} timed_out={eng.timeout_count} "
          f"shed={eng.shed_count} rejected={eng.rejected_count} "
          f"callback_errors={eng.callback_errors} "
          f"internal_errors={eng.internal_errors} "
          f"sanitize_checks={eng.sanitize_checks} "
          f"released={eng.sched.released_count}", flush=True)
    # latency from the lifecycle stamps: TTFT from arrival to the first
    # token, TPOT over the decode window
    ttft = [r.first_token_at - r.arrived_at
            for r in finished if r.first_token_at]
    tpot = [(r.finished_at - r.first_token_at) / (len(r.generated) - 1)
            for r in finished
            if r.finished_at and r.first_token_at and len(r.generated) > 1]
    print(f"[slo] ttft {_ms_stats(ttft)} | tpot {_ms_stats(tpot)} "
          f"(over {len(ttft)} first tokens / {len(tpot)} decode windows)",
          flush=True)
    if eng.faults.faults:
        fired = [f"{p}:{a}@step{s}" for p, a, s in eng.faults.fired]
        print(f"[faults] armed: {eng.faults.describe()}; "
              f"fired: {', '.join(fired) or '(none)'}; "
              f"pending: {len(eng.faults.pending)}", flush=True)
    if log is not None:
        print(f"[recovery] journal={len(log.journal)} events, "
              f"snapshot@step{log.snapshot_step} "
              f"(every {log.snapshot_every}), replayed={log.replayed}",
              flush=True)
    if eng.attn_forwards:
        waste = eng.attn_grid_items - eng.attn_work_items
        dense_waste = eng.attn_dense_grid_items - eng.attn_work_items
        print(f"[sched] {args.attention_schedule}: "
              f"{eng.attn_work_items} attention work items over "
              f"{eng.attn_forwards} forwards; grid={eng.attn_grid_items} "
              f"(waste {waste}; dense rectangle would waste "
              f"{dense_waste})", flush=True)
    if args.speculation or eng.spec_draft_tokens:
        acc = eng.spec_accepted_tokens / max(1, eng.spec_draft_tokens)
        print(f"[sched] speculation: drafted={eng.spec_draft_tokens} "
              f"accepted={eng.spec_accepted_tokens} (acceptance {acc:.0%}) "
              f"rollback={eng.spec_rollback_tokens} "
              f"noop={eng.spec_noop_count} "
              f"draft_errors={eng.draft_errors} "
              f"[{eng.draft_source.describe()}]", flush=True)
    _print_states([(r.state.value, r.stop_reason, len(r.generated))
                   for r in finished])
    for r in finished[:4]:
        print(f"  req {r.request_id}: {r.state.value:9s} "
              f"{r.generated[:12]}…", flush=True)
    return eng




if __name__ == "__main__":
    main()
