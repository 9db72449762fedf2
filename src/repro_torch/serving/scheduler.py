"""Continuous-batching request scheduler (``repro/serving/scheduler.py``).

Pure host code. FCFS admission when the paged pool holds a request's
first prefill chunk; chunked prefill planned round-robin under a
per-step token budget; youngest-first preemption on pool exhaustion;
abort/fail with refcount-exact page release; whole-prompt admission for
the ``prefill_mode="whole"`` baseline. With ``max_waiting`` the waiting
queue is bounded: the engine rejects at submit when it is full
(``FAILED("queue_full")``) and a preemption victim that cannot re-queue
is shed (``FAILED("shed")``). ``expire_deadlines`` moves requests past
their ``deadline_ms``/``ttft_ms`` to ``TIMED_OUT`` at each step boundary.
``snapshot``/``restore`` serialize the scheduler in the reference's JSON:
the legacy mode demotes running requests to waiting (generated text
folded into the prompt); ``full=True`` keeps the exact waiting/running
split, slots, prefill cursors, free-slot order and plan cursor, which
with the cache's ``snapshot_state`` resumes the next step bit for bit
(``serving/recovery.py``).
"""

from __future__ import annotations

import dataclasses
import json
from collections import deque
from typing import Callable, Optional

from repro_torch.serving.api import RequestState, SamplingParams

__all__ = ["Request", "Scheduler"]


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: list                   # token ids
    max_new_tokens: int
    arrived_at: float = 0.0
    generated: list = dataclasses.field(default_factory=list)
    seq_slot: int = -1             # cache slot when running
    prefill_pos: int = 0           # prompt tokens already through the model
    stop_reason: Optional[str] = None   # None = ran to max_new_tokens
    first_token_at: float = 0.0    # clock of the first generated token
    finished_at: float = 0.0       # clock of the terminal event; with
    #                                first_token_at it brackets the decode
    #                                window (TTFT/TPOT in the serve CLI)
    params: Optional[SamplingParams] = None
    state: RequestState = RequestState.QUEUED
    cached_tokens: int = 0         # prefix-cache hit tokens, last admission
    uid: int = -1                  # incarnation-qualified id: request ids
    #                                are reusable after release(); this
    #                                engine-lifetime counter is not
    emitted: int = 0               # lifetime token events (survives the
    #                                preemption fold, unlike generated)
    terminal_emitted: bool = dataclasses.field(
        default=False, repr=False, compare=False)
    events: list = dataclasses.field(
        default_factory=list, repr=False, compare=False)
    on_event: Optional[Callable] = dataclasses.field(
        default=None, repr=False, compare=False)

    def deadline_status(self, now: float) -> Optional[str]:
        """The stop reason this request owes at clock ``now``
        (``"deadline"`` or ``"ttft_budget"``), or None within budget.
        Measured from ``arrived_at``, which preemption keeps."""
        p = self.params
        if p is None:
            return None
        waited_ms = (now - self.arrived_at) * 1000.0
        if p.deadline_ms is not None and waited_ms > p.deadline_ms:
            return "deadline"
        if (p.ttft_ms is not None and not self.first_token_at
                and waited_ms > p.ttft_ms):
            return "ttft_budget"
        return None

    @property
    def prefilled(self) -> bool:
        return self.prefill_pos >= len(self.prompt)

    @property
    def total_len(self) -> int:
        return len(self.prompt) + len(self.generated)

    @property
    def done(self) -> bool:
        return (self.stop_reason is not None
                or len(self.generated) >= self.max_new_tokens)


class Scheduler:
    def __init__(self, max_batch: int, max_seqs: int,
                 max_waiting: Optional[int] = None):
        self.max_batch = max_batch
        self.max_seqs = max_seqs
        self.max_waiting = max_waiting   # None = unbounded waiting queue
        self.waiting: deque[Request] = deque()
        self.running: list[Request] = []
        self.finished: list[Request] = []
        self._free_slots = list(range(max_seqs - 1, -1, -1))
        self.preemptions = 0
        self.released_count = 0     # terminal requests dropped via release
        self._plan_cursor = 0       # round-robin start for prefill plans

    def counters(self) -> dict:
        return {"preemptions": self.preemptions,
                "released_count": self.released_count}

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    @property
    def waiting_full(self) -> bool:
        """The bounded waiting queue cannot take another request."""
        return (self.max_waiting is not None
                and len(self.waiting) >= self.max_waiting)

    def submit(self, req: Request):
        self.waiting.append(req)

    def admit(self, cache, first_chunk_tokens: Optional[int] = None,
              prefix_cache: bool = False) -> list[Request]:
        """Admit waiting requests while pages and slots are available.
        With chunked prefill admission needs pages for the first chunk
        only; ``first_chunk_tokens=None`` reserves the whole prompt (the
        whole-prompt baseline). With ``prefix_cache`` the published prefix
        pages are adopted and the request starts prefill at the end of
        the shared prefix."""
        admitted = []
        while (self.waiting and self._free_slots
               and len(self.running) < self.max_batch):
            req = self.waiting[0]
            if (cache.pages_needed(len(req.prompt))
                    > cache.pcfg.max_pages_per_seq
                    or cache.pages_needed(len(req.prompt) + 1)
                    > cache.pcfg.num_pages):
                # can never fit: fail fast instead of livelocking
                self.waiting.popleft()
                req.stop_reason = "prompt_too_long"
                req.state = RequestState.FINISHED
                self.finished.append(req)
                continue
            pages, matched = (cache.match_prefix(req.prompt)
                              if prefix_cache else ([], 0))
            reserve = (len(req.prompt) if first_chunk_tokens is None
                       else min(len(req.prompt),
                                matched + first_chunk_tokens))
            # one decode token of headroom once the whole prompt is resident
            headroom = reserve + 1 if reserve == len(req.prompt) else reserve
            if (cache.pages_needed(headroom) - len(pages)
                    > cache.pages_available_for(pages)):
                break
            slot = self._free_slots.pop()
            if not cache.allocate_seq(slot, reserve, prefix_pages=pages,
                                      prefix_tokens=matched):
                self._free_slots.append(slot)
                break
            req.seq_slot = slot
            req.prefill_pos = matched
            req.cached_tokens = matched
            req.state = RequestState.PREFILLING
            self.waiting.popleft()
            self.running.append(req)
            admitted.append(req)
        return admitted

    def plan_prefill(self, cache,
                     token_budget: int) -> list[tuple[Request, int, int]]:
        """This step's prefill chunks ``[(req, start, take), ...]``: up to
        ``token_budget`` prompt tokens, scan start round-robined across
        the candidates, pages acquired chunk by chunk."""
        cands = [r for r in self.running if r.prefill_pos < len(r.prompt)]
        if not cands or token_budget <= 0:
            return []
        rot = self._plan_cursor % len(cands)
        self._plan_cursor += 1
        budget = token_budget
        plan: list[tuple[Request, int, int]] = []
        for req in cands[rot:] + cands[:rot]:
            if budget <= 0:
                break
            rem = len(req.prompt) - req.prefill_pos
            want = req.prefill_pos + min(rem, budget)
            cap = cache.grow_to(req.seq_slot, want)
            take = min(rem, budget, cap - req.prefill_pos)
            if take <= 0:
                continue
            plan.append((req, req.prefill_pos, take))
            budget -= take
        return plan

    def preempt_one(self, cache) -> Optional[Request]:
        """Evict the youngest unfinished running sequence back to the
        front of the waiting queue, its generated text folded into the
        prompt (re-admission prefills prompt + generated). When the
        bounded waiting queue is full the victim is shed instead:
        terminal ``FAILED("shed")``, partial output kept, pages freed."""
        candidates = [r for r in self.running if not r.done]
        if not candidates:
            return None
        req = max(candidates, key=lambda r: r.arrived_at)
        self.running.remove(req)
        cache.free_seq(req.seq_slot)
        self._free_slots.append(req.seq_slot)
        req.seq_slot = -1
        self.preemptions += 1
        if self.waiting_full:
            req.stop_reason = "shed"
            req.state = RequestState.FAILED
            self.finished.append(req)
            return req
        req.prompt = req.prompt + req.generated
        req.max_new_tokens -= len(req.generated)
        req.generated = []
        req.prefill_pos = 0
        req.state = RequestState.QUEUED
        self.waiting.appendleft(req)
        return req

    def complete(self, req: Request, cache):
        self.running.remove(req)
        cache.free_seq(req.seq_slot)
        self._free_slots.append(req.seq_slot)
        req.seq_slot = -1
        req.state = RequestState.FINISHED
        self.finished.append(req)

    def _end(self, req: Request, cache, state: RequestState,
             reason: str) -> bool:
        """Detach a non-terminal request wherever it is (running: pages
        freed refcount-exactly, slot returned) and make it terminal."""
        if req.state.terminal:
            return False
        if req in self.running:
            self.running.remove(req)
            cache.free_seq(req.seq_slot)
            self._free_slots.append(req.seq_slot)
            req.seq_slot = -1
        elif req in self.waiting:
            self.waiting.remove(req)
        req.stop_reason = reason
        req.state = state
        self.finished.append(req)
        return True

    def abort(self, req: Request, cache) -> bool:
        return self._end(req, cache, RequestState.ABORTED, "aborted")

    def fail(self, req: Request, cache, reason: str) -> bool:
        return self._end(req, cache, RequestState.FAILED, reason)

    def reject(self, req: Request, reason: str = "queue_full"):
        """Refuse a request at submit: straight to ``FAILED(reason)``,
        never queued, holding no pages or slots."""
        req.stop_reason = reason
        req.state = RequestState.FAILED
        self.finished.append(req)

    def expire_deadlines(self, cache, now: float) -> list[Request]:
        """Move every running or waiting request past its deadline or
        TTFT budget at clock ``now`` to ``TIMED_OUT`` (pages freed
        refcount-exactly, partial output kept) → the expired requests."""
        expired = []
        for req in list(self.running) + list(self.waiting):
            why = req.deadline_status(now)
            if why is not None and self._end(req, cache,
                                             RequestState.TIMED_OUT, why):
                expired.append(req)
        return expired

    def release(self, req: Request) -> bool:
        if req not in self.finished:
            return False
        self.finished.remove(req)
        self.released_count += 1
        return True

    # ------------------------------------------------------ fault tolerance

    @staticmethod
    def _req_entry(r: Request) -> dict:
        """A request's full record for the ``full=True`` snapshot: nothing
        folded or demoted (slot, prefill cursor, state, lifetime event
        count)."""
        entry = {
            "request_id": r.request_id,
            "prompt": list(r.prompt),
            "generated": list(r.generated),
            "max_new_tokens": r.max_new_tokens,
            "arrived_at": r.arrived_at,
            "first_token_at": r.first_token_at,
            "finished_at": r.finished_at,
            "cached_tokens": r.cached_tokens,
            "emitted": r.emitted,
            "uid": r.uid,
            "seq_slot": r.seq_slot,
            "prefill_pos": r.prefill_pos,
            "state": r.state.value,
            "stop_reason": r.stop_reason,
        }
        if r.params is not None:
            entry["params"] = dataclasses.asdict(r.params)
        return entry

    @staticmethod
    def _req_from_entry(e: dict) -> Request:
        params = e.get("params")
        req = Request(
            request_id=e["request_id"], prompt=list(e["prompt"]),
            max_new_tokens=e["max_new_tokens"],
            arrived_at=e.get("arrived_at", 0.0),
            first_token_at=e.get("first_token_at", 0.0),
            finished_at=e.get("finished_at", 0.0),
            cached_tokens=e.get("cached_tokens", 0),
            emitted=e.get("emitted", 0),
            uid=e.get("uid", -1),
            params=SamplingParams(**params) if params else None)
        req.generated = list(e.get("generated", []))
        req.seq_slot = e.get("seq_slot", -1)
        req.prefill_pos = e.get("prefill_pos", 0)
        req.state = RequestState(e.get("state", "queued"))
        req.stop_reason = e.get("stop_reason")
        req.terminal_emitted = req.state.terminal
        return req

    def snapshot(self, full: bool = False) -> str:
        """Serialize the scheduler. Legacy (default): running requests are
        demoted to waiting, their generated text folded into the prompt
        (their KV is recomputed on restore). ``full=True``: the exact
        split, slots, prefill cursors, free-slot order and plan cursor."""
        if full:
            return json.dumps({
                "format": "full",
                "waiting": [self._req_entry(r) for r in self.waiting],
                "running": [self._req_entry(r) for r in self.running],
                "finished": [self._req_entry(r) for r in self.finished],
                "free_slots": list(self._free_slots),
                "plan_cursor": self._plan_cursor,
                "preemptions": self.preemptions,
                "released_count": self.released_count,
            })
        reqs = []
        for r in list(self.waiting) + self.running:
            entry = {
                "request_id": r.request_id,
                "prompt": list(r.prompt) + list(r.generated),
                "max_new_tokens": r.max_new_tokens - len(r.generated),
                "arrived_at": r.arrived_at,
                # TTFT and prefix-hit accounting survive the restart
                "first_token_at": r.first_token_at,
                "cached_tokens": r.cached_tokens,
                "emitted": r.emitted,
            }
            if r.params is not None:
                entry["params"] = dataclasses.asdict(r.params)
            reqs.append(entry)
        done = [{
            "request_id": r.request_id,
            "prompt": list(r.prompt),
            "generated": list(r.generated),
            "stop_reason": r.stop_reason,
            "state": r.state.value,
            "arrived_at": r.arrived_at,
            "first_token_at": r.first_token_at,
            "cached_tokens": r.cached_tokens,
            "emitted": r.emitted,
        } for r in self.finished]
        return json.dumps({"pending": reqs, "finished": done})

    @classmethod
    def restore(cls, blob: str, max_batch: int, max_seqs: int,
                max_waiting: Optional[int] = None) -> "Scheduler":
        state = json.loads(blob)
        sched = cls(max_batch, max_seqs, max_waiting)
        if state.get("format") == "full":
            for key, dst in (("waiting", sched.waiting),
                             ("running", sched.running),
                             ("finished", sched.finished)):
                dst.extend(cls._req_from_entry(e) for e in state[key])
            sched._free_slots = list(state["free_slots"])
            sched._plan_cursor = state.get("plan_cursor", 0)
            sched.preemptions = state.get("preemptions", 0)
            sched.released_count = state.get("released_count", 0)
            return sched
        for r in state["pending"]:
            params = r.get("params")
            sched.submit(Request(
                request_id=r["request_id"], prompt=r["prompt"],
                max_new_tokens=r["max_new_tokens"],
                arrived_at=r["arrived_at"],
                first_token_at=r.get("first_token_at", 0.0),
                cached_tokens=r.get("cached_tokens", 0),
                emitted=r.get("emitted", 0),
                params=SamplingParams(**params) if params else None))
        for r in state["finished"]:
            req = Request(request_id=r["request_id"], prompt=r["prompt"],
                          max_new_tokens=0,
                          arrived_at=r.get("arrived_at", 0.0))
            req.generated = r["generated"]
            req.stop_reason = r.get("stop_reason")
            req.state = RequestState(r.get("state", "finished"))
            req.first_token_at = r.get("first_token_at", 0.0)
            req.cached_tokens = r.get("cached_tokens", 0)
            req.emitted = r.get("emitted", 0)
            req.terminal_emitted = req.state.terminal
            sched.finished.append(req)
        return sched
