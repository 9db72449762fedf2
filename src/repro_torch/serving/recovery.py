"""Journaled crash recovery: full snapshots and a per-token event journal
(``repro/serving/recovery.py``, ported: the same artifacts, keys and
files, so a journal or snapshot of either package resumes in the other).

Exactly-once event delivery across a crash, with the continued output
bit for bit the uninterrupted run's, from two artifacts:

* **Full snapshots** (``Engine.snapshot(full=True)``, every
  ``snapshot_every`` steps): the int4 pool bytes, block tables, free-list
  and prefix-LRU order, the exact waiting/running split, slots, prefill
  cursors and each request's lifetime event count (``Request.emitted``).
  A restore resumes the very next step: nothing re-prefills.
* **An event journal** covering the steps since the last snapshot: every
  event the engine emits, keyed ``(uid, lifetime ordinal)``. ``uid`` is
  the request's incarnation (``Request.uid``; request ids are reusable
  after ``Engine.release()``), the ordinal its ``emitted`` cursor (not
  ``len(generated)``, which a preemption fold resets); a terminal event
  has ordinal -1.

**Compaction.** Each checkpoint drops the journal entries the new
snapshot makes unreplayable (in dir mode ``journal.jsonl`` is rewritten
atomically, write-temp + rename), so both artifacts stay bounded by one
snapshot interval. ``journaled_total``/``compacted_total`` count
lifetime entries.

**Replay.** After a resume the restored engine re-runs the steps between
the snapshot and the crash; every re-emitted event already journaled is
verified bitwise (a different token raises :class:`ReplayMismatch`) and
suppressed (``step()`` returns only fresh events). On the card this is
also the check that the device computes the same step twice to the same
bits: every kernel of the path is deterministic (the work-queue
attention combines in descriptor order, the GEMMs are exact).

Two modes: in memory (``RecoveryLog.resume`` with the old log's
``snapshot_blob`` and ``journal``) and directory-backed (``dir=``: an
atomic ``snapshot.json``, ``journal.jsonl`` appended each step;
``RecoveryLog.open_dir`` rebuilds after a process kill). The
``snapshot_write`` fault point tears the snapshot's temp file mid-write
to show that the rename keeps the last good snapshot.

Over a tensor-parallel engine (``Engine(mesh=)``, one process per rank,
every rank running the same host program) every rank builds its log over
its own engine and steps it in lockstep: ``Engine.snapshot(full=True)`` is
a collective that gathers every rank's kv heads, so every rank holds the
same snapshot and the same journal. Only model rank 0 writes the
directory (the atomic rename kept); every rank then passes a barrier on
the mesh's host group, so none goes on before the checkpoint exists. A
torn ``snapshot_write`` fires on every rank at the same point: rank 0
tears its temp file, and every rank raises the same ``InjectedFault``
after the barrier, so the controllers never diverge. ``resume`` and
``open_dir`` take ``mesh=``/``param_axes=`` for ``Engine.restore``: every
rank restores the same blob and keeps its kv heads, and a blob of a mesh
restores into one device, one device's into a mesh.

``serving/replication.py`` builds replica groups on exactly this pair:
each replica ships ``(snapshot_blob, journal, steps)`` after every
healthy step, and a death is recovered only from that shipped view.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from repro_torch.parallel.mesh import host_barrier
from repro_torch.serving.faults import InjectedFault

__all__ = ["RecoveryLog", "ReplayMismatch"]

_TERMINAL = -1      # journal ordinal sentinel for a terminal event


class ReplayMismatch(RuntimeError):
    """A replayed event disagreed with the journal — the restored engine
    is NOT continuing the crashed run's output."""


class RecoveryLog:
    """Rides along with an :class:`~repro_torch.serving.engine.Engine`: drive
    steps through :meth:`step` (instead of ``engine.step()`` +
    ``engine.events()``) and the log journals every event, checkpoints a
    full snapshot every ``snapshot_every`` steps (compacting the journal
    down to the new gap), and — after a resume — verifies and
    deduplicates the replayed gap.

    ``journal`` entries: ``{"rid", "uid", "ord", "token", "state",
    "stop"}`` (``ord`` = lifetime token ordinal, -1 for the terminal
    event; ``uid`` = the incarnation-qualified id entries are keyed by).
    """

    def __init__(self, engine, snapshot_every: int = 8,
                 dir: Optional[str] = None, _journal=None,
                 _snapshot: Optional[str] = None):
        if snapshot_every < 1:
            raise ValueError("snapshot_every must be >= 1")
        self.engine = engine
        # under a mesh only model rank 0 writes the directory
        self._mesh = getattr(engine, "mesh", None)
        self._writes = self._mesh is None or self._mesh.model_rank == 0
        self.snapshot_every = snapshot_every
        self.dir = dir
        self.journal: list[dict] = list(_journal or [])
        self._by_key = {(e["uid"], e["ord"]): e for e in self.journal}
        # per-request delivery cursor: the next token event's lifetime
        # ordinal, keyed by uid. Seeded from the (restored) requests'
        # emitted counts so replayed tokens key to the SAME ordinals the
        # crashed run journaled them under.
        self._cursor = {r.uid: r.emitted for r in engine._by_id.values()}
        self._uid_of = {r.request_id: r.uid
                        for r in engine._by_id.values()}
        self.replayed = 0           # journaled events re-emitted + verified
        self.steps_logged = 0
        self.journaled_total = len(self.journal)   # lifetime entries seen
        self.compacted_total = 0    # entries dropped as unreplayable
        self._snapshot = _snapshot if _snapshot is not None \
            else engine.snapshot(full=True)
        self._snapshot_step = engine.steps
        if self.dir is not None:
            os.makedirs(self.dir, exist_ok=True)
            self._write_snapshot()

    # --------------------------------------------------------------- logging

    @property
    def snapshot_blob(self) -> str:
        """The latest checkpointed full snapshot (NOT live state)."""
        return self._snapshot

    @property
    def snapshot_step(self) -> int:
        """Engine step the latest checkpoint was taken at."""
        return self._snapshot_step

    def checkpoint(self):
        """Take a full snapshot now (normally automatic via
        ``snapshot_every``) and compact the journal: entries at or
        before the new snapshot's per-request ``emitted`` cursors can
        never replay — a resume from this snapshot starts every
        delivery cursor at the snapshot — so they are dropped in memory
        and ``journal.jsonl`` is atomically rewritten to match."""
        self._snapshot = self.engine.snapshot(full=True)
        self._snapshot_step = self.engine.steps
        self._compact()
        if self.dir is not None:
            self._write_snapshot()
            self._rewrite_journal()

    def _compact(self):
        """Drop journal entries the latest snapshot makes unreplayable.

        Keep an entry only if its request is live in the snapshot
        (released requests can never re-emit), non-terminal there (a
        terminal request restores with ``terminal_emitted`` set), and —
        for token entries — its ordinal is at or past the snapshot's
        ``emitted`` cursor. Taken at checkpoint time this retains
        nothing (the snapshot IS the present), but the predicate is the
        contract, not "clear()": a journal handed in by ``resume`` may
        already trail the snapshot it rides with."""
        live = {r.uid: r for r in self.engine._by_id.values()}

        def replayable(e):
            r = live.get(e["uid"])
            if r is None or r.state.terminal:
                return False
            return e["ord"] != _TERMINAL and e["ord"] >= r.emitted

        kept = [e for e in self.journal if replayable(e)]
        self.compacted_total += len(self.journal) - len(kept)
        self.journal = kept
        self._by_key = {(e["uid"], e["ord"]): e for e in kept}

    def step(self):
        """One engine step → the step's FRESH events (replayed
        duplicates verified against the journal and suppressed)."""
        self.engine.step()
        fresh = []
        new_entries = []
        for ev in self.engine.events():
            req = self.engine._by_id.get(ev.request_id)
            if req is not None:
                self._uid_of[ev.request_id] = req.uid
            uid = self._uid_of.get(ev.request_id, ev.request_id)
            if ev.token is not None:
                ordn = self._cursor.get(uid, 0)
                self._cursor[uid] = ordn + 1
            else:
                ordn = _TERMINAL
            entry = {"rid": ev.request_id, "uid": uid, "ord": ordn,
                     "token": ev.token, "state": ev.state.value,
                     "stop": ev.stop_reason}
            prior = self._by_key.get((uid, ordn))
            if prior is not None:
                # the crashed run already delivered this event: verify
                # the replay is bitwise identical, deliver nothing
                if prior["token"] != entry["token"]:
                    raise ReplayMismatch(
                        f"request {ev.request_id} (uid {uid}) token "
                        f"ordinal {ordn}: replay produced "
                        f"{entry['token']}, journal has "
                        f"{prior['token']} — continuation is not "
                        "bit-identical")
                self.replayed += 1
                continue
            self.journal.append(entry)
            self._by_key[(uid, ordn)] = entry
            new_entries.append(entry)
            fresh.append(ev)
        self.journaled_total += len(new_entries)
        if self.dir is not None and new_entries and self._writes:
            with open(os.path.join(self.dir, "journal.jsonl"), "a") as f:
                for e in new_entries:
                    f.write(json.dumps(e) + "\n")
        self.steps_logged += 1
        if self.engine.steps % self.snapshot_every == 0:
            self.checkpoint()
        return fresh

    def run(self, max_steps: int = 10_000):
        """Drive steps until the engine drains; → all fresh events."""
        out = []
        while self.engine.sched.has_work and max_steps > 0:
            out.extend(self.step())
            max_steps -= 1
        return out

    def tokens_for(self, rid: int) -> list[int]:
        """The journaled token stream for one request SINCE THE LAST
        CHECKPOINT (compaction drops older entries), in order. The full
        delivered history is the caller's to keep — e.g.
        ``ReplicaGroup`` records every delivered token per request."""
        return [e["token"] for e in self.journal
                if e["rid"] == rid and e["ord"] != _TERMINAL]

    def terminal_for(self, rid: int) -> Optional[dict]:
        uid = self._uid_of.get(rid, rid)
        return self._by_key.get((uid, _TERMINAL))

    # -------------------------------------------------------------- recovery

    @classmethod
    def resume(cls, snapshot_blob: str, journal: list, cfg, params,
               quant, ecfg, snapshot_every: int = 8,
               dir: Optional[str] = None, **engine_kw) -> "RecoveryLog":
        """Rebuild after a crash: restore the engine from the last full
        snapshot and seed the log with the crashed run's journal. Steps
        between the snapshot and the crash re-run — their events are
        verified against the journal and NOT redelivered. ``engine_kw``
        goes to ``Engine.restore`` (``device``, ``clock``, ``faults``,
        ``draft_source``; ``mesh`` and ``param_axes`` on every rank of a
        tensor-parallel engine)."""
        from repro_torch.serving.engine import Engine
        eng = Engine.restore(snapshot_blob, cfg, params, quant, ecfg,
                             **engine_kw)
        return cls(eng, snapshot_every=snapshot_every, dir=dir,
                   _journal=journal, _snapshot=snapshot_blob)

    @classmethod
    def open_dir(cls, dir: str, cfg, params, quant, ecfg,
                 snapshot_every: int = 8, **engine_kw) -> "RecoveryLog":
        """Resume from a directory-backed log after a process kill."""
        with open(os.path.join(dir, "snapshot.json")) as f:
            snapshot_blob = f.read()
        journal = []
        jpath = os.path.join(dir, "journal.jsonl")
        if os.path.exists(jpath):
            with open(jpath) as f:
                journal = [json.loads(line) for line in f if line.strip()]
        return cls.resume(snapshot_blob, journal, cfg, params, quant,
                          ecfg, snapshot_every=snapshot_every, dir=dir,
                          **engine_kw)

    def _write_snapshot(self):
        # atomic: a kill mid-write must not corrupt the last good
        # snapshot (rename is atomic on POSIX). The snapshot_write fault
        # point simulates exactly that kill: a torn temp file, the
        # rename never reached — open_dir must still restore from the
        # previous good snapshot.json. Under a mesh every rank checks the
        # fault (the same schedule fires at the same point), rank 0
        # writes, and every rank waits for the write before it goes on
        # or raises.
        tmp = os.path.join(self.dir, "snapshot.json.tmp")
        fault = self.engine.faults.check("snapshot_write")
        if self._writes:
            with open(tmp, "w") as f:
                f.write(self._snapshot if fault is None else
                        self._snapshot[: max(1, len(self._snapshot) // 2)])
            if fault is None:
                os.replace(tmp, os.path.join(self.dir, "snapshot.json"))
        self._written()
        if fault is not None:
            raise InjectedFault(
                "snapshot_write: killed mid-write (torn temp file)")

    def _rewrite_journal(self):
        # same atomicity contract as the snapshot: the compacted journal
        # replaces journal.jsonl via write-temp + rename, so a kill
        # mid-rewrite leaves the previous (superset) journal — replaying
        # against a superset only suppresses more, never redelivers
        if self._writes:
            tmp = os.path.join(self.dir, "journal.jsonl.tmp")
            with open(tmp, "w") as f:
                for e in self.journal:
                    f.write(json.dumps(e) + "\n")
            os.replace(tmp, os.path.join(self.dir, "journal.jsonl"))
        self._written()

    def _written(self):
        """Under a mesh, no rank goes on before rank 0's write is done."""
        if self._mesh is not None:
            host_barrier(self._mesh)
