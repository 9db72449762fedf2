"""Durable serving under a mesh: the workloads of the tensor-parallel
recovery and replica-mesh tests, run by one device in the test process
and by the ranks ``launch.mesh.spawn`` starts (gloo on the CPU). Like
``_torch_tp_ranks``, this module imports only the port.

* :func:`run_recovery`: a directory-backed ``RecoveryLog`` served
  uninterrupted, crashed two steps past a checkpoint and resumed with
  ``RecoveryLog.open_dir``, and torn at a checkpoint (``snapshot_write``)
  and resumed from the last good snapshot; the crash's directory is
  copied at the crash, for the other kind of engine to resume
  (:func:`resume_dir`).
* :func:`run_replica_cases`: a two-replica ``ReplicaGroup`` without a
  crash, then with replica 0 killed mid-prefill, mid-decode and between a
  checkpoint and the crash, under both failover policies.
"""
import json
import os
import shutil

import numpy as np

from repro_torch.launch.mesh import make_local_mesh, make_replica_meshes
from repro_torch.serving.api import SamplingParams
from repro_torch.serving.engine import EngineConfig
from repro_torch.serving.faults import Fault, FaultInjector, InjectedFault
from repro_torch.serving.recovery import RecoveryLog
from repro_torch.serving.replication import ReplicaGroup
from _torch_tp_ranks import ENGINE, _engine, foreign_modules, prompts

SNAP_EVERY = 3
CRASH_AT = 8        # the process dies after engine step 8: two past step 6's
#                     checkpoint, mid-decode
TORN_NTH = 3        # the third snapshot write (construction, steps 3, 6)
MAX_NEW = 8


def _submit(eng, vocab: int):
    for i, p in enumerate(prompts(vocab, (10, 15, 7), seed=19)):
        eng.add_request(i, p, MAX_NEW)


def _streams(events) -> dict:
    """Each request's delivered tokens and its terminal states."""
    toks, ends = {}, {}
    for ev in events:
        if ev.token is not None:
            toks.setdefault(ev.request_id, []).append(int(ev.token))
        else:
            ends.setdefault(ev.request_id, []).append(ev.state.value)
    return {"tokens": toks, "terminals": ends}


def _finish(log, events) -> dict:
    eng = log.engine
    return {**_streams(events), "replayed": log.replayed,
            "generated": {r.request_id: list(r.generated)
                          for r in eng.sched.finished},
            "pages_free": eng.cache.pages_free,
            "refs_zero": bool((eng.cache.ref == 0).all()),
            "internal_errors": eng.internal_errors,
            "sanitize_checks": eng.sanitize_checks, "steps": eng.steps,
            "snapshot": log.snapshot_blob}


def _open(model, mesh, d: str, faults=None) -> RecoveryLog:
    cfg, params, axes, quant = model
    return RecoveryLog.open_dir(d, cfg, params, quant, EngineConfig(**ENGINE),
                                snapshot_every=SNAP_EVERY, device="cpu",
                                mesh=mesh, param_axes=axes, faults=faults)


def _writes(mesh) -> bool:
    return mesh is None or mesh.model_rank == 0


def _barrier(mesh):
    if mesh is not None:
        import torch.distributed as dist
        dist.barrier(group=mesh.host_group)


def run_recovery(model, mesh, root: str, foreign=None) -> dict:
    """The recovery workloads on ``model`` (cfg, params, axes, quant) in
    directories under ``root``; ``mesh`` None is one device. ``foreign``:
    a crash directory the other kind of engine wrote, resumed here too."""
    vocab = model[0].vocab_size
    out = {}
    # uninterrupted
    eng = _engine(model, mesh)
    log = RecoveryLog(eng, snapshot_every=SNAP_EVERY,
                      dir=os.path.join(root, "plain"))
    _submit(eng, vocab)
    out["plain"] = _finish(log, log.run())
    # a crash two steps past a checkpoint, resumed from the directory
    d = os.path.join(root, "crash")
    eng = _engine(model, mesh)
    log = RecoveryLog(eng, snapshot_every=SNAP_EVERY, dir=d)
    _submit(eng, vocab)
    events = []
    while eng.steps < CRASH_AT:
        events.extend(log.step())
    out["crash_copy"] = d + "_at_crash"
    if _writes(mesh):
        shutil.copytree(d, out["crash_copy"])
    _barrier(mesh)
    with open(os.path.join(d, "snapshot.json")) as f:
        out["crashed_past"] = json.loads(f.read())["steps"]
    del log, eng
    log = _open(model, mesh, d)
    out["resumed_at"] = log.engine.steps
    out["crash"] = _finish(log, events + log.run())
    with open(os.path.join(d, "journal.jsonl")) as f:
        out["journal_file"] = [json.loads(ln) for ln in f if ln.strip()]
    out["journal"] = log.journal
    # a torn snapshot write, then a resume from the last good snapshot
    d = os.path.join(root, "torn")
    eng = _engine(model, mesh, faults=FaultInjector(
        [Fault("snapshot_write", nth=TORN_NTH, action="torn")]))
    log = RecoveryLog(eng, snapshot_every=SNAP_EVERY, dir=d)
    _submit(eng, vocab)
    try:
        log.run()
        out["torn"] = None
    except InjectedFault as e:
        with open(os.path.join(d, "snapshot.json")) as f:
            good = json.loads(f.read())["steps"]
        out["torn"] = {"error": str(e), "at": eng.steps, "good": good,
                       "tmp": os.path.exists(os.path.join(
                           d, "snapshot.json.tmp"))}
        _barrier(mesh)          # every rank has read the good snapshot
        del log, eng
        log = _open(model, mesh, d)
        out["torn"]["resumed_at"] = log.engine.steps
        out["torn"].update(_finish(log, log.run()))
    if foreign is not None:
        out["foreign"] = resume_dir(model, mesh, foreign,
                                    os.path.join(root, "foreign"))
    return out


def resume_dir(model, mesh, src: str, d: str) -> dict:
    """Resume a copy (at ``d``) of the crash directory ``src`` → the
    finished run."""
    if _writes(mesh):
        shutil.copytree(src, d)
    _barrier(mesh)
    log = _open(model, mesh, d)
    return {"resumed_at": log.engine.steps, **_finish(log, log.run())}


def recovery_rank(rank, world, device, model, root, foreign):
    """A spawned rank: the recovery workloads on its mesh's shard, the
    one device's crash directory ``foreign`` resumed, and the JAX and
    ``repro`` modules it loaded (none)."""
    mesh = make_local_mesh(1, world)
    out = run_recovery(model, mesh, root, foreign)
    out["foreign_modules"] = foreign_modules()
    return out


# ------------------------------------------------------- replica meshes

REPLICA_ENGINE = dict(max_batch=4, num_pages=64, page_size=8,
                      max_pages_per_seq=16, prefill_chunk_tokens=8,
                      kv_range=4.0, sanitize=True)
REPLICA_SNAP = 4
REPLICA_MAX_NEW = 6
# (failover, kill step of replica 0): none, then mid-prefill, mid-decode
# and between a checkpoint and the crash under each policy
REPLICA_CASES = (("standby", 0), ("standby", 2), ("standby", 6),
                 ("standby", 7), ("migrate", 2), ("migrate", 6),
                 ("migrate", 7))


def replica_prompts() -> list:
    rng = np.random.default_rng(41)
    return [rng.integers(1, 100, int(rng.integers(12, 18))).tolist()
            for _ in range(3)]


def run_replica_cases(model, meshes, cases=REPLICA_CASES) -> dict:
    """Each case's group run on ``model``; ``meshes`` None is one device
    (one engine per replica on it) → case → streams, terminals, owners
    before and after, counters, deaths and the held replicas' free
    pages."""
    cfg, params, axes, quant = model
    out = {}
    for failover, kill in cases:
        faults = [FaultInjector([Fault("crash", step=kill)] if kill else []),
                  FaultInjector()]
        group = ReplicaGroup(
            cfg, params, quant, EngineConfig(**REPLICA_ENGINE), replicas=2,
            failover=failover, snapshot_every=REPLICA_SNAP, faults=faults,
            device="cpu", meshes=meshes,
            param_axes=axes if meshes is not None else None)
        rids = [group.submit(p, SamplingParams(max_new_tokens=REPLICA_MAX_NEW))
                for p in replica_prompts()]
        owner = dict(group.owner)
        group.run()
        out[(failover, kill)] = {
            "tokens": {r: group.tokens_for(r) for r in rids},
            "terminals": {r: group.terminal_for(r).state.value
                          for r in rids},
            "owner_before": owner, "owner": dict(group.owner),
            "counters": group.counters(), "deaths": list(group.deaths),
            "stats": group.replica_stats(),
            "pages_free": {r.idx: r.engine.cache.pages_free
                           for r in group.replicas
                           if r.alive and r.engine is not None}}
    return out


def replica_rank(rank, world, device, model, replicas, m):
    """A spawned rank of ``replicas`` meshes of ``m`` ranks: every case
    of :func:`run_replica_cases`, and the foreign modules it loaded."""
    meshes = make_replica_meshes(replicas, m)
    out = run_replica_cases(model, meshes)
    out["foreign_modules"] = foreign_modules()
    out["mesh"] = [(mm.ranks, mm.model_rank) for mm in meshes]
    return out


def out_of_slice_calls(rank, world, device, model):
    """A RecoveryLog over a tensor-parallel engine and a ReplicaGroup over
    per-replica meshes (two of one rank each), built and run → their
    tokens."""
    cfg, params, axes, quant = model
    meshes = make_replica_meshes(world, 1)
    eng = _engine(model, meshes[rank])
    log = RecoveryLog(eng, snapshot_every=2)
    _submit(eng, cfg.vocab_size)
    log_tokens = _streams(log.run())["tokens"]
    group = ReplicaGroup(cfg, params, quant, EngineConfig(**ENGINE),
                         replicas=world, device="cpu", meshes=meshes,
                         param_axes=axes)
    rids = [group.submit(p, SamplingParams(max_new_tokens=MAX_NEW))
            for p in prompts(cfg.vocab_size, (10, 15, 7), seed=19)]
    group.run()
    return {"log": log_tokens, "group": {r: group.tokens_for(r)
                                         for r in rids}}
