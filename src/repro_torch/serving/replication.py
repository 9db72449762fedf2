"""Replica groups with health-checked failover and exactly-once request
migration (``repro/serving/replication.py``, ported over the port's
engine).

The :class:`ReplicaGroup` controller runs N engine replicas behind one
submit/step surface and turns a replica's death into lost throughput
instead of lost or repeated tokens.

**Per replica:** the engine, its page pools, scheduler, prefix index,
fault injector and a private :class:`~repro_torch.serving.recovery.
RecoveryLog` driving its steps. **Group-global:** the request-id
namespace (the group assigns ids, so sampling keyed ``(request_id,
position)`` draws the same on whichever replica serves a request), the
routing table and the delivered-event record. On one card every replica
is an engine on the same device, and all share the one set of device
weights (``params`` is handed to each engine, never copied).

**Replica meshes** (``meshes=``, ``param_axes=``: one tensor-parallel
mesh per replica, ``launch/mesh.py:make_replica_meshes``; the world is
replicas × model ranks, one process each). Every rank of the world runs
this controller, in lockstep: the routing table, the submission and
delivered records, the health and the counters are the same on every
rank. Replica i's engine, its RecoveryLog and its shipped view exist only
on replica i's ranks (the engine built on ``meshes[i]``, sharding the
params by ``param_axes``). What the other ranks need of a replica comes
over a gloo group of the whole world: its step's outcome (the fresh
events, its step count, a death and its reason, the step's duration on
its rank 0's clock), broadcast from its rank 0 after it steps, and every
replica's load, queue room and counters (:meth:`ReplicaGroup.
replica_stats`, one all-gather) where routing or a summary reads them.
The replicas step one after another, as on one card, so a migrate
failover's resubmissions reach a survivor before it steps in the same
group step, and a mesh group's streams and counts are one device's
group's. A failover resumes the engine on the dead replica's own ranks
from the view shipped there; no snapshot moves between replicas.

**Routing.** ``submit`` places a request on the least-loaded live replica
(waiting + running) whose bounded waiting queue has room, else on the
least-loaded one, whose queue then rejects it (``FAILED("queue_full")``).

**Health.** Before each replica step the ``crash`` fault point is
consulted (action ``kill`` marks the replica dead before the step runs;
``--kill-replica-at``), and a step slower than ``heartbeat_s`` marks it
dead with its events discarded. A dead engine's memory is never trusted
again.

**Shipping and failover.** After every healthy step a replica ships
``(snapshot_blob, journal, steps)`` and only then are the step's events
delivered, so the shipped view covers every delivered event. On a death
the group resumes the engine from that view (``RecoveryLog.resume``) and
re-runs the gap, verified bitwise and suppressed, then by policy:
``failover="standby"`` promotes the resumed engine into the dead slot;
``failover="migrate"`` folds every in-flight request from the group's
record (prompt + delivered tokens, ``max_new_tokens`` less what was
delivered) and resubmits it to the survivors under its original id, or,
with no survivor, synthesizes one ``FAILED("replica_lost")`` terminal per
request. A request routed after the last shipped checkpoint is in
neither artifact; the group's own submission record resubmits it under
both policies. The delivered record suppresses tokens after a delivered
terminal and second terminals (``duplicates_suppressed``).

Counters: ``failovers``, ``migrated_requests``, ``replica_steps``,
``duplicates_suppressed``, per-replica ``health`` (the serve launcher's
``[group]`` line).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch.distributed as dist

from repro_torch.parallel.mesh import world_host_group
from repro_torch.serving.api import (RequestOutput, RequestState,
                                     SamplingParams)
from repro_torch.serving.engine import Engine
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.recovery import RecoveryLog

__all__ = ["Replica", "ReplicaGroup"]


@dataclasses.dataclass
class Replica:
    """One slot in the group: a live engine + its RecoveryLog (under
    replica meshes, on this replica's ranks only; ``None`` elsewhere),
    the health state, its engine's step count, and the last shipped
    artifact tuple ``(snapshot_blob, journal, steps)``."""
    idx: int
    engine: Optional[Engine]
    log: Optional[RecoveryLog]
    health: str = "live"        # live | promoted | dead:crash |
    #                             dead:heartbeat
    shipped: Optional[tuple] = None
    last_step_s: float = 0.0
    steps: int = 0

    @property
    def alive(self) -> bool:
        return not self.health.startswith("dead")


class ReplicaGroup:
    """N engine replicas behind one submit/step surface (see module
    docstring for the full contract).

    ``params``: the model's parameters on ``device``, shared by every
    replica (no copy per replica); under ``meshes`` this rank's, whole or
    its replica's shard. ``faults``: optional per-replica list of
    :class:`~repro_torch.serving.faults.FaultInjector` (``None`` entries
    get a fresh empty injector) — the seam chaos tests and
    ``--kill-replica-at`` arm ``crash`` faults through.
    ``heartbeat_s``: per-step completion deadline (``None`` disables
    the heartbeat check). ``meshes``: one mesh per replica
    (``launch/mesh.py:make_replica_meshes``, every rank of the world
    building the group), ``param_axes`` the params' logical axes; the
    engines then live on the meshes' devices, not ``device``.
    """

    def __init__(self, cfg, params, quant, ecfg, *, replicas: int = 2,
                 failover: str = "migrate", snapshot_every: int = 4,
                 heartbeat_s: Optional[float] = None, faults=None,
                 device="cuda", clock=time.time, meshes=None,
                 param_axes=None):
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        if failover not in ("standby", "migrate"):
            raise ValueError(
                f"failover must be 'standby' or 'migrate', got "
                f"{failover!r}")
        if faults is not None and len(faults) != replicas:
            raise ValueError(
                f"faults must list one injector per replica "
                f"({replicas}), got {len(faults)}")
        if meshes is not None and len(meshes) != replicas:
            raise ValueError(
                f"meshes must list one mesh per replica ({replicas}), "
                f"got {len(meshes)}")
        self.cfg, self.params, self.quant, self.ecfg = (cfg, params,
                                                        quant, ecfg)
        self.device = device
        self.failover = failover
        self.snapshot_every = snapshot_every
        self.heartbeat_s = heartbeat_s
        self.clock = clock
        self._meshes = meshes
        self._param_axes = param_axes
        # the controllers' exchanges (gloo over the whole world)
        self._world = world_host_group() if meshes is not None else None
        self._rank = dist.get_rank() if meshes is not None else 0
        self.replicas: list[Replica] = []
        for i in range(replicas):
            inj = faults[i] if faults is not None and faults[i] is not None \
                else FaultInjector()
            rep = Replica(idx=i, engine=None, log=None)
            if self._holds(i):
                rep.engine = Engine(cfg, params, quant, ecfg, faults=inj,
                                    clock=clock, **self._placement(i))
                rep.log = RecoveryLog(rep.engine,
                                      snapshot_every=snapshot_every)
                self._ship(rep)
            self.replicas.append(rep)
        self._next_rid = 0
        self.owner: dict[int, int] = {}         # rid → replica idx
        # durable submission record: a request routed to a replica AFTER
        # its last shipped checkpoint is in neither the shipped snapshot
        # nor (necessarily) the journal — the group itself is the
        # client-facing durable record, so failover re-submits such
        # "lost" requests from here, continuing from delivered tokens
        self._requests: dict[int, tuple] = {}   # rid → (prompt, params)
        self.delivered: dict[int, list[int]] = {}   # rid → token stream
        self.terminals: dict[int, RequestOutput] = {}
        self._callbacks: dict[int, object] = {}
        self.failovers = 0
        self.migrated_requests = 0
        self.replica_steps = 0
        self.duplicates_suppressed = 0
        self.callback_errors = 0
        self.deaths: list[tuple] = []           # (idx, why, engine_step)

    # ------------------------------------------------------ replica meshes

    def _holds(self, idx: int) -> bool:
        """Whether this process holds replica ``idx``'s engine."""
        return self._meshes is None or self._rank in self._meshes[idx].ranks

    def _placement(self, idx: int) -> dict:
        """Where replica ``idx``'s engines live: ``device``, or its mesh."""
        if self._meshes is None:
            return {"device": self.device}
        mesh = self._meshes[idx]
        return {"device": mesh.device, "mesh": mesh,
                "param_axes": self._param_axes}

    def _from(self, idx: int, value):
        """``value`` as replica ``idx``'s first rank computed it, on every
        rank (under replica meshes a broadcast; else ``value``)."""
        if self._meshes is None:
            return value
        box = [value]
        dist.broadcast_object_list(box, src=self._meshes[idx].ranks[0],
                                   group=self._world)
        return box[0]

    def replica_stats(self) -> list[dict]:
        """Each replica's load (waiting + running), queue room, pending
        work and engine counters, on every rank (under replica meshes one
        all-gather of each replica's first rank's)."""
        def stats(rep: Replica) -> dict:
            eng = rep.engine
            s = eng.sched
            return {"load": len(s.waiting) + len(s.running),
                    "waiting_full": s.waiting_full, "has_work": s.has_work,
                    "internal_errors": eng.internal_errors,
                    "failed": eng.failed_count,
                    "timed_out": eng.timeout_count,
                    "shed": eng.shed_count, "rejected": eng.rejected_count,
                    "sanitize_checks": eng.sanitize_checks,
                    "fired": list(eng.faults.fired)}

        if self._meshes is None:
            return [stats(r) for r in self.replicas]
        mine = next((stats(r) for r, m in zip(self.replicas, self._meshes)
                     if m.ranks[0] == self._rank), None)
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine, group=self._world)
        return [every[m.ranks[0]] for m in self._meshes]

    # ------------------------------------------------------------- routing

    def _route(self) -> Replica:
        """Least-loaded live replica with waiting-queue headroom; when
        all are full, the least-loaded one outright (its bounded queue
        rejects at submit — the existing backpressure path)."""
        live = [r for r in self.replicas if r.alive]
        if not live:
            raise RuntimeError("no live replicas")
        stats = self.replica_stats()
        open_ = [r for r in live if not stats[r.idx]["waiting_full"]]
        return min(open_ or live, key=lambda r: (stats[r.idx]["load"],
                                                 r.idx))

    def submit(self, prompt, params: Optional[SamplingParams] = None,
               on_event=None) -> int:
        """Enqueue on the least-loaded live replica; returns the
        group-global request id. Events are delivered through the
        group's record (``tokens_for``/``terminal_for``) and the
        optional ``on_event`` callback as the group steps."""
        rid = self._next_rid
        self._next_rid += 1
        rep = self._route()
        self._requests[rid] = (list(prompt), params)
        if self._holds(rep.idx):
            rep.engine.submit(list(prompt), params, request_id=rid)
        self.owner[rid] = rep.idx
        if on_event is not None:
            self._callbacks[rid] = on_event
        return rid

    # ------------------------------------------------------------ stepping

    def step(self):
        """One group step: every live replica advances one engine step
        (crash-fault check → step → heartbeat check → ship → deliver).
        A death detected here fails over immediately, within the same
        group step."""
        for rep in list(self.replicas):
            self._step_replica(rep)

    def run(self, max_steps: int = 10_000):
        while self.has_work and max_steps > 0:
            self.step()
            max_steps -= 1

    @property
    def has_work(self) -> bool:
        stats = self.replica_stats()
        return any(r.alive and stats[r.idx]["has_work"]
                   for r in self.replicas)

    def _step_replica(self, rep: Replica):
        if not rep.alive:
            return
        out = self._from(rep.idx, self._local_step(rep)
                         if self._holds(rep.idx) else None)
        rep.steps = out["steps"]
        if out["dead"] == "crash":
            self._on_death(rep, "crash")
            return
        rep.last_step_s = out["step_s"]
        self.replica_steps += 1
        if out["dead"] == "heartbeat":
            # missed heartbeat: the step's events are DISCARDED — never
            # shipped, never delivered — so the failover regenerates
            # them on a survivor and the client still sees each exactly
            # once
            self._on_death(rep, "heartbeat")
            return
        if self._holds(rep.idx):
            self._ship(rep)
        for ev in out["events"]:
            self._deliver(ev)

    def _local_step(self, rep: Replica) -> dict:
        """The replica's step where its engine lives → its outcome: the
        fresh events, the engine's step count, the step's seconds, and a
        death (``"crash"``, ``"heartbeat"``) or None."""
        eng = rep.engine
        # process-level crash check BEFORE the step: the injector's step
        # counter is advanced to the step about to run, so crash:step=K
        # kills the replica with its journal consistent to step K-1 —
        # exactly the shipped view
        eng.faults.begin_step(eng.steps + 1)
        if eng.faults.check("crash") is not None:
            return {"dead": "crash", "steps": eng.steps, "step_s": 0.0,
                    "events": []}
        t0 = self.clock()
        fresh = rep.log.step()
        step_s = self.clock() - t0
        slow = self.heartbeat_s is not None and step_s > self.heartbeat_s
        return {"dead": "heartbeat" if slow else None, "steps": eng.steps,
                "step_s": step_s, "events": [] if slow else fresh}

    def _ship(self, rep: Replica):
        """Publish the replica's RecoveryLog artifacts to the standby
        store (on the replica's own ranks). Runs BEFORE the step's events
        are delivered, so the shipped view always covers every delivered
        event."""
        rep.shipped = (rep.log.snapshot_blob,
                       [dict(e) for e in rep.log.journal],
                       rep.engine.steps)

    # ------------------------------------------------------------ delivery

    def _deliver(self, ev: RequestOutput):
        """Group-level exactly-once choke point: record the event under
        its request id, suppressing anything after a delivered terminal
        (and second terminals outright)."""
        rid = ev.request_id
        if rid in self.terminals:
            self.duplicates_suppressed += 1
            return
        if ev.token is not None:
            self.delivered.setdefault(rid, []).append(int(ev.token))
        else:
            self.terminals[rid] = ev
        cb = self._callbacks.get(rid)
        if cb is not None:
            try:
                cb(ev)
            except Exception:  # noqa: BLE001 — client-callback boundary:
                # group-level mirror of Engine._emit's guard — client
                # code may raise anything; detach + count, never fatal
                self.callback_errors += 1
                self._callbacks.pop(rid, None)

    def tokens_for(self, rid: int) -> list[int]:
        """The full delivered token stream for a request — the group
        keeps lifetime history (the per-replica journals compact)."""
        return list(self.delivered.get(rid, []))

    def terminal_for(self, rid: int) -> Optional[RequestOutput]:
        return self.terminals.get(rid)

    # ------------------------------------------------------------ failover

    def _on_death(self, rep: Replica, why: str):
        rep.health = f"dead:{why}"
        self.deaths.append((rep.idx, why, rep.steps))
        self.failovers += 1
        if self.failover == "standby":
            self._promote(rep)
        else:
            self._migrate(rep)

    def _owned_inflight(self, idx: int) -> list[int]:
        """The dead replica's requests the group still owes a terminal
        for, in submission order (rids are monotonic)."""
        return sorted(rid for rid, owner in self.owner.items()
                      if owner == idx and rid not in self.terminals)

    def _recover_log(self, shipped: tuple, idx: int):
        """Resume an engine from a shipped artifact tuple (on replica
        ``idx``'s own device or mesh) and replay the gap up to the shipped
        step count → (the log, the replay's fresh events). Every
        regenerated event in the gap is in the shipped journal
        (ship-then-deliver), so the RecoveryLog verifies it bitwise
        (``ReplayMismatch`` otherwise) and suppresses its redelivery; a
        staging replay (migrate) drops the fresh events, which the
        survivor fold regenerates."""
        blob, journal, steps = shipped
        log = RecoveryLog.resume(
            blob, [dict(e) for e in journal], self.cfg, self.params,
            self.quant, self.ecfg, snapshot_every=self.snapshot_every,
            clock=self.clock, **self._placement(idx))
        fresh = []
        while log.engine.steps < steps:
            fresh.extend(log.step())
        return log, fresh

    def _resubmit(self, rid: int, target: Replica):
        """Continue a request on ``target`` from the stream the client
        already saw: the group's durable record folds the delivered
        tokens into the prompt (the engine's preemption fold) and the
        budget shrinks to the undelivered remainder — under the ORIGINAL
        request id, so the sampling stream is unchanged."""
        prompt, params = self._requests[rid]
        done = self.delivered.get(rid, [])
        base = params if params is not None else SamplingParams(
            temperature=self.ecfg.temperature, top_k=self.ecfg.top_k)
        params = dataclasses.replace(
            base, max_new_tokens=max(base.max_new_tokens - len(done), 0))
        if self._holds(target.idx):
            target.engine.submit(list(prompt) + list(done), params,
                                 request_id=rid)
        self.owner[rid] = target.idx

    def _promote(self, rep: Replica):
        """Standby failover: install the resumed engine in the dead slot
        — same replica index, same routing, streams continue bitwise
        from the shipped view. Requests routed here after the shipped
        checkpoint are in neither the snapshot nor the journal — the
        group re-submits them from its own record."""
        new = Replica(idx=rep.idx, engine=None, log=None, health="promoted")
        done = None
        if self._holds(rep.idx):
            new.log, fresh = self._recover_log(rep.shipped, rep.idx)
            new.engine = new.log.engine
            done = {"events": fresh, "steps": new.engine.steps,
                    "rids": sorted(new.engine._by_id)}
        done = self._from(rep.idx, done)
        for ev in done["events"]:
            self._deliver(ev)
        new.steps = done["steps"]
        self.replicas[rep.idx] = new
        for rid in self._owned_inflight(rep.idx):
            if rid not in done["rids"]:
                self._resubmit(rid, new)
        if self._holds(rep.idx):
            self._ship(new)

    def _migrate(self, rep: Replica):
        """Migrate failover: resume a STAGING engine from the shipped
        artifacts purely to verify the replayed gap bitwise against the
        journal, then fold every in-flight request from the group's
        delivered record and resubmit to the survivors (least-loaded,
        original ids). The staging engine is discarded — the group
        record and the staging state agree by construction (everything
        in the staging engine's ``generated`` was delivered)."""
        survivors = [r for r in self.replicas if r.alive]
        if not survivors:
            # total loss: exactly one synthesized terminal per request
            # the group still owes one
            for rid in self._owned_inflight(rep.idx):
                self._deliver(RequestOutput(
                    request_id=rid, state=RequestState.FAILED,
                    token=None,
                    num_generated=len(self.delivered.get(rid, [])),
                    stop_reason="replica_lost", finished=True))
            return
        if self._holds(rep.idx):
            self._recover_log(rep.shipped, rep.idx)
        for rid in self._owned_inflight(rep.idx):
            self._resubmit(rid, self._route())
            self.migrated_requests += 1

    # --------------------------------------------------------- observability

    @property
    def health(self) -> dict[int, str]:
        return {r.idx: r.health for r in self.replicas}

    @property
    def internal_errors(self) -> int:
        stats = self.replica_stats()
        return sum(stats[r.idx]["internal_errors"] for r in self.replicas
                   if r.alive)

    def counters(self) -> dict:
        return {
            "failovers": self.failovers,
            "migrated_requests": self.migrated_requests,
            "replica_steps": self.replica_steps,
            "duplicates_suppressed": self.duplicates_suppressed,
            "callback_errors": self.callback_errors,
            "internal_errors": self.internal_errors,
            "health": self.health,
        }
