"""Deterministic fault injection for the serving stack
(``repro/serving/faults.py``, copied: the same points, actions and
schedule builders, so a seeded schedule fires the same faults in both
engines). The process-level points are consulted as in the reference:
``crash`` by the port's replica groups (``serving/replication.py``) and
``snapshot_write`` by its recovery log (``serving/recovery.py``).

A production engine's failure modes — allocator exhaustion mid-loop, an
exception inside the jitted forward, NaN logits, a sampler blow-up, a
client callback that throws — are rare enough in normal operation that
the isolation code handling them would otherwise ship untested. This
module makes those faults *schedulable*: a :class:`FaultInjector` armed
with :class:`Fault` entries rides along with the engine, and the
instrumented choke points in ``engine.py`` / ``kv_cache.py`` consult it
on every hit. Schedules are fully deterministic ("fail the Nth
allocation", "NaN the logits at step K"), so a chaos test that trips an
invariant replays bit-for-bit from its seed.

Fault points (the names the engine/cache fire):

* ``alloc_page``  — every ``PagedKV4Cache._acquire_page`` call. The only
  legal action is ``exhaust`` (the call returns ``None``, exactly what a
  dry pool returns): allocator exhaustion is a *condition*, not an
  exception — the engine's admission / preemption / load-shed machinery
  is the handler under test, and a raise inside the allocator's
  multi-page loop would corrupt block-table state no real exhaustion
  can produce.
* ``forward``     — one hit per model forward. ``raise`` aborts the
  forward before launch (the engine quarantines every request in the
  batch); ``nan`` lets the forward run and then corrupts one logits row
  (``row``), tripping the engine's per-row non-finite guard.
* ``sample``      — one hit per batched sampler call; ``raise`` fails
  every row being sampled (rows mid-prefill are untouched).
* ``append_kv``   — every KV write-destination resolution
  (``PagedKV4Cache.token_dests_np``); ``raise`` aborts the step's
  forward before any pool write.
* ``emit_event``  — every delivery to a request's ``on_event`` callback;
  ``raise`` simulates a throwing client callback (the engine detaches
  the callback and keeps the request alive — the event log is intact).

Two points cover the speculative-decode path (grouped in
``SPEC_FAULT_POINTS``, kept OUT of ``ENGINE_FAULT_POINTS`` so seeded
schedules built before they existed replay unchanged):

* ``draft``       — every draft-source invocation in
  ``Engine._plan_speculation``. ``raise`` simulates a blowing-up draft
  oracle (the engine counts ``draft_errors`` and degrades to plain
  one-token decode — drafting is best-effort, never fatal); ``empty``
  makes the source politely propose nothing (pure degradation, no
  error).
* ``verify``      — once per speculating row's verification in
  ``Engine._verify_row``; ``raise`` quarantines exactly that request
  (pages released to baseline, drafted KV retracted with them) while
  the rest of the batch keeps decoding.

Two points model *process-level* failures (consulted by the layers
wrapping the engine, never by ``Engine.step`` itself):

* ``crash``       — consulted by ``serving/replication.py``'s
  :class:`ReplicaGroup` at the top of each replica step; action
  ``kill`` marks the WHOLE replica dead before the step runs (its
  in-memory engine state is considered lost with the process — the
  controller recovers only from the shipped RecoveryLog artifacts).
* ``snapshot_write`` — consulted by ``RecoveryLog._write_snapshot``;
  action ``torn`` writes a partial temp file and then raises (a kill
  mid-write), proving the atomic-rename contract: the last good
  ``snapshot.json`` must survive untouched.

Schedules come from three constructors: explicit :class:`Fault` lists,
the CLI spec grammar (:meth:`FaultInjector.from_spec`, e.g.
``"forward:step=3,action=nan;alloc_page:nth=20"``), and seeded random
mixes for chaos sweeps (:meth:`FaultInjector.random_schedule` — drawn
from the five in-engine points only, so pre-existing seeded schedules
are stable; pass ``points=`` to include the speculative-decode and/or
process-level ones, e.g. ``ENGINE_FAULT_POINTS + SPEC_FAULT_POINTS``
for the chaos sweeps covering speculation).

Each armed fault fires exactly once. ``hits`` counts every consultation
per point and ``fired`` records what actually tripped (point, action,
engine step) — chaos tests assert against these to prove a schedule
actually exercised the path it meant to.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["Fault", "FaultInjector", "InjectedFault", "FAULT_POINTS",
           "ENGINE_FAULT_POINTS", "SPEC_FAULT_POINTS"]

# the five points Engine.step/PagedKV4Cache consult directly
ENGINE_FAULT_POINTS = ("alloc_page", "forward", "sample", "append_kv",
                       "emit_event")
# the speculative-decode points (Engine._plan_speculation /
# Engine._verify_row) — a separate group, NOT folded into
# ENGINE_FAULT_POINTS, so seeded random_schedule draws from before
# speculation existed still replay bit-for-bit
SPEC_FAULT_POINTS = ("draft", "verify")
# plus the process-level points consulted by the wrapping layers
# (ReplicaGroup / RecoveryLog)
FAULT_POINTS = ENGINE_FAULT_POINTS + SPEC_FAULT_POINTS + (
    "crash", "snapshot_write")

# legal actions per point (first entry = the default)
_ACTIONS = {
    "alloc_page": ("exhaust",),
    "forward": ("raise", "nan"),
    "sample": ("raise",),
    "append_kv": ("raise",),
    "emit_event": ("raise",),
    "draft": ("raise", "empty"),
    "verify": ("raise",),
    "crash": ("kill",),
    "snapshot_write": ("torn",),
}


class InjectedFault(RuntimeError):
    """Raised by an armed ``raise``-action fault at its point."""


@dataclasses.dataclass
class Fault:
    """One scheduled fault. Exactly one trigger must be set:

    ``nth``  — fire on the Nth consultation of ``point`` (1-based,
    counted over the engine's lifetime);
    ``step`` — fire on the first consultation of ``point`` during that
    engine step.

    ``action`` defaults to the point's canonical failure mode (see
    module docstring); ``row`` picks the logits row a ``nan`` fault
    corrupts (clamped to the batch by the engine).
    """

    point: str
    nth: Optional[int] = None
    step: Optional[int] = None
    action: Optional[str] = None
    row: int = 0
    fired: bool = dataclasses.field(default=False, compare=False)

    def __post_init__(self):
        if self.point not in FAULT_POINTS:
            raise ValueError(f"unknown fault point {self.point!r}; "
                             f"expected one of {FAULT_POINTS}")
        if (self.nth is None) == (self.step is None):
            raise ValueError(
                f"fault {self.point!r} needs exactly one trigger: "
                f"nth= or step= (got nth={self.nth}, step={self.step})")
        if self.action is None:
            self.action = _ACTIONS[self.point][0]
        if self.action not in _ACTIONS[self.point]:
            raise ValueError(
                f"action {self.action!r} not valid for point "
                f"{self.point!r}; legal: {_ACTIONS[self.point]}")

    def describe(self) -> str:
        trig = (f"nth={self.nth}" if self.nth is not None
                else f"step={self.step}")
        return f"{self.point}[{trig},action={self.action}]"


class FaultInjector:
    """Armed fault schedule + hit accounting shared by engine and cache.

    The engine calls :meth:`begin_step` once per ``Engine.step``; the
    instrumented points call :meth:`check(point)` on every hit. ``check``
    returns the :class:`Fault` that just tripped (or ``None``) — raising
    is the *caller's* job, so each point keeps its own failure semantics
    (the allocator returns ``None``, the forward raises, the NaN fault
    mutates logits after the forward ran).
    """

    def __init__(self, faults: Optional[list] = None):
        self.faults: list[Fault] = list(faults or [])
        self.hits = {p: 0 for p in FAULT_POINTS}
        self.fired: list[tuple] = []    # (point, action, engine_step)
        self.step = 0

    def begin_step(self, step: int):
        self.step = step

    def check(self, point: str) -> Optional[Fault]:
        """Count a hit at ``point``; return the fault that trips, if any.

        At most one fault fires per hit (schedules listing two faults on
        the same trigger fire them on consecutive hits)."""
        self.hits[point] += 1
        for f in self.faults:
            if f.fired or f.point != point:
                continue
            if f.nth is not None:
                if self.hits[point] != f.nth:
                    continue
            elif self.step != f.step:
                continue
            f.fired = True
            self.fired.append((point, f.action, self.step))
            return f
        return None

    @property
    def pending(self) -> list[Fault]:
        return [f for f in self.faults if not f.fired]

    # ------------------------------------------------------------ builders

    @classmethod
    def from_spec(cls, spec: str) -> "FaultInjector":
        """Parse the CLI grammar: ``;``-separated faults, each
        ``point:key=val,key=val`` — e.g.
        ``"forward:step=3,action=nan;alloc_page:nth=20;sample:nth=2"``.
        """
        faults = []
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            point, _, argstr = part.partition(":")
            kw: dict = {}
            for kv in filter(None, (a.strip() for a in argstr.split(","))):
                key, _, val = kv.partition("=")
                if key in ("nth", "step", "row"):
                    kw[key] = int(val)
                elif key == "action":
                    kw[key] = val
                else:
                    raise ValueError(f"unknown fault key {key!r} in "
                                     f"{part!r}")
            faults.append(Fault(point.strip(), **kw))
        return cls(faults)

    @classmethod
    def random_schedule(cls, seed: int, n_faults: int = 3,
                        max_step: int = 30,
                        points=ENGINE_FAULT_POINTS) -> "FaultInjector":
        """A seeded random mix of faults for chaos sweeps — the same
        seed always builds the same schedule, so a failing sweep replays
        exactly from its seed."""
        rng = np.random.default_rng(seed)
        faults = []
        for _ in range(n_faults):
            point = str(rng.choice(list(points)))
            if point == "alloc_page":
                faults.append(Fault(point, nth=int(rng.integers(1, 60))))
            elif point == "forward":
                action = str(rng.choice(["raise", "nan"]))
                faults.append(Fault(point, step=int(rng.integers(2, max_step)),
                                    action=action,
                                    row=int(rng.integers(0, 4))))
            else:
                faults.append(Fault(point, nth=int(rng.integers(1, 20))))
        return cls(faults)

    def describe(self) -> str:
        return "; ".join(f.describe() for f in self.faults) or "(none)"
