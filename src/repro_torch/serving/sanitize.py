"""Step-boundary runtime sanitizers for the serving engine
(``repro/serving/sanitize.py``, over the port's host tables).

With ``EngineConfig(sanitize=True)`` the engine re-derives its core
invariants from first principles after every ``Engine.step()`` and
raises :class:`SanitizerError` naming the violated invariant the moment
one breaks — instead of letting a corrupted refcount or a duplicated
terminal surface requests later as a wrong answer. Checks are pure host
code (numpy over the cache's ``block_table``, ``ref``, ``free_pages``,
``_reclaimable``, ``prefix_index``, ``page_key`` and ``seq_len``), so
they read no device memory.

Invariants checked (the reference's ``docs/invariants.md``):

- **page-refcount conservation** — per-page refs recomputed from the
  active sequences' block tables must equal ``cache.ref`` exactly, the
  free list and the reclaimable LRU must be duplicate-free, disjoint,
  and unmapped, reclaimable pages must be published (key'd both ways in
  the prefix index), and ``free + reclaimable + mapped`` must tile the
  pool: Σ refs>0 pages + len(free) + len(reclaimable) == num_pages.
- **exactly-one-terminal** — at most one ``finished`` event per request,
  and ``terminal_emitted`` agrees with the event log.
- **no-token-after-terminal** — a terminal event is the LAST event; no
  token event may carry ``finished=True``; a request's token-event count
  never exceeds its lifetime ``emitted`` cursor.
- **emitted-position-monotonic** — a request's token events advance
  ``num_generated`` by exactly one per event (restarting at 1 only
  after a preemption fold): multi-token speculative commits must emit
  in order, never duplicating or skipping a position.
- **kv-length-consistency** — after every step, each running request's
  resident KV length equals its committed tokens: mid-prefill,
  ``seq_len == prefill_pos``; decoding, ``seq_len == total_len - 1``
  (every committed token except the newest has resident KV — the
  newest is written by its next forward). Speculative rollback
  (``truncate_seq``) must land sequences exactly here; a leaked or
  over-retracted draft token trips this immediately.
- **ranks-agree** (tensor-parallel engines) — every rank runs the same
  host program on the same logits, so after every step each rank's
  sampled tokens and scheduler state must be rank 0's: the ranks
  all-gather a digest of them (the steps, every request's state and
  tokens, the waiting and running order, resident lengths and the free
  list) and the first difference raises.
"""

from __future__ import annotations

import numpy as np

from repro_torch.parallel.mesh import differing_ranks

__all__ = ["SanitizerError", "check_engine", "check_cache",
           "check_events", "check_positions", "check_ranks"]


class SanitizerError(AssertionError):
    """A serving-core invariant failed a step-boundary sanitizer check.

    Deliberately NOT swallowed by the engine's step backstop: the check
    runs outside the isolation boundary, because a broken invariant
    means state is already corrupt and continuing would serve wrong
    answers."""


def check_cache(cache) -> list:
    """Page-refcount conservation over the paged KV4 cache."""
    problems = []
    num_pages = cache.pcfg.num_pages
    expected = np.zeros(num_pages, np.int64)
    for sid in cache.active:
        npg = int(cache.page_count[sid])
        for p in cache.block_table[sid, :npg]:
            p = int(p)
            if p < 0 or p >= num_pages:
                problems.append(
                    f"page-refcount conservation: active seq {sid} maps "
                    f"out-of-pool page {p} (pool has {num_pages})")
            else:
                expected[p] += 1
    ref = np.asarray(cache.ref, np.int64)
    if not np.array_equal(expected, ref):
        bad = np.nonzero(expected != ref)[0][:8]
        detail = ", ".join(
            f"page {int(p)}: ref={int(ref[p])} but {int(expected[p])} "
            f"active mapping(s)" for p in bad)
        problems.append(f"page-refcount conservation: ref table diverges "
                        f"from block tables ({detail})")
    free = [int(p) for p in cache.free_pages]
    if len(free) != len(set(free)):
        problems.append("page-refcount conservation: duplicate page in "
                        "free list")
    reclaimable = {int(p) for p in cache._reclaimable}
    overlap = set(free) & reclaimable
    if overlap:
        problems.append(f"page-refcount conservation: page(s) "
                        f"{sorted(overlap)[:8]} on both the free list "
                        f"and the reclaimable LRU")
    for p in free:
        if 0 <= p < num_pages and ref[p] != 0:
            problems.append(f"page-refcount conservation: free page {p} "
                            f"has ref={int(ref[p])}")
            break
    for p, key in cache._reclaimable.items():
        p = int(p)
        if ref[p] != 0:
            problems.append(f"page-refcount conservation: reclaimable "
                            f"page {p} has ref={int(ref[p])}")
        if cache.prefix_index.get(key) != p or \
                cache.page_key.get(p) != key:
            problems.append(f"page-refcount conservation: reclaimable "
                            f"page {p} lost its prefix-index pairing")
    mapped = int(np.count_nonzero(ref > 0))
    if mapped + len(free) + len(reclaimable) != num_pages:
        problems.append(
            f"page-refcount conservation: mapped({mapped}) + "
            f"free({len(free)}) + reclaimable({len(reclaimable)}) != "
            f"pool({num_pages})")
    return problems


def check_events(engine) -> list:
    """Exactly-one-terminal + no-token-after-terminal per request.

    Tolerates restored requests whose event log was not carried across
    the snapshot (empty ``events`` with ``terminal_emitted=True``)."""
    problems = []
    for req in engine._by_id.values():
        rid = req.request_id
        terminals = [i for i, ev in enumerate(req.events) if ev.finished]
        if len(terminals) > 1:
            problems.append(f"exactly-one-terminal: request {rid} has "
                            f"{len(terminals)} terminal events")
        if terminals and terminals[0] != len(req.events) - 1:
            extra = len(req.events) - 1 - terminals[0]
            problems.append(f"no-token-after-terminal: request {rid} has "
                            f"{extra} event(s) after its terminal")
        if terminals and not req.terminal_emitted:
            problems.append(f"exactly-one-terminal: request {rid} logged "
                            f"a terminal event but terminal_emitted is "
                            f"False (a second terminal could slip "
                            f"through _emit)")
        tokens = sum(1 for ev in req.events if ev.token is not None)
        if any(ev.token is not None and ev.finished for ev in req.events):
            problems.append(f"no-token-after-terminal: request {rid} has "
                            f"a token event marked finished")
        if tokens > req.emitted:
            problems.append(f"no-token-after-terminal: request {rid} "
                            f"logged {tokens} token events but its "
                            f"lifetime emitted cursor is {req.emitted}")
        nums = [ev.num_generated for ev in req.events
                if ev.token is not None]
        for a, b in zip(nums, nums[1:]):
            if b != a + 1 and b != 1:
                problems.append(
                    f"emitted-position-monotonic: request {rid} token "
                    f"events jump num_generated {a} -> {b} (must advance "
                    f"by exactly one, or restart at 1 after a preemption "
                    f"fold)")
                break
    return problems


def check_positions(engine) -> list:
    """KV-length ↔ committed-token agreement for every running request.

    The invariant speculative rollback must restore: a decoding
    request's newest committed token has NO resident KV yet (its next
    forward writes it), every older one does — so ``seq_len`` is
    exactly ``total_len - 1``. Mid-prefill, ``seq_len`` tracks the
    chunk cursor ``prefill_pos``. Checked over ``sched.running`` only:
    waiting/preempted requests hold no slot, terminal ones no pages."""
    problems = []
    cache = engine.cache
    for req in engine.sched.running:
        rid, slot = req.request_id, req.seq_slot
        if slot < 0:
            problems.append(f"kv-length-consistency: running request "
                            f"{rid} holds no seq slot")
            continue
        ln = int(cache.seq_len[slot])
        if not req.prefilled:
            if ln != req.prefill_pos:
                problems.append(
                    f"kv-length-consistency: request {rid} mid-prefill "
                    f"has kv len {ln} but prefill_pos {req.prefill_pos}")
            continue
        want = req.total_len - 1 if req.generated else len(req.prompt)
        if ln != want:
            problems.append(
                f"kv-length-consistency: request {rid} has kv len {ln} "
                f"but {req.total_len} committed tokens (expected {want}: "
                f"every committed token except the newest has resident "
                f"KV)")
    return problems


def _host_state(engine) -> str:
    """The host state every rank of a mesh must hold alike, as text."""
    sched, cache = engine.sched, engine.cache
    reqs = sorted(engine._by_id.items())
    return repr((
        engine.steps, engine.tokens_generated,
        [(rid, r.state.value, r.generated) for rid, r in reqs],
        [r.request_id for r in sched.waiting],
        [r.request_id for r in sched.running],
        cache.seq_len.tolist(), list(cache.free_pages)))


def check_ranks(engine) -> list:
    """ranks-agree: a tensor-parallel engine's ranks hold the same tokens
    and scheduler state (a collective: every rank calls it)."""
    if engine.mesh is None:
        return []
    bad = differing_ranks(_host_state(engine), engine.mesh)
    return ([f"ranks-agree: rank(s) {bad} hold other tokens or scheduler "
             f"state than rank 0"] if bad else [])


def check_engine(engine) -> None:
    """Assert every step-boundary invariant; raise on the first batch of
    violations. Called by ``Engine.step()`` when ``ecfg.sanitize``."""
    problems = (check_cache(engine.cache) + check_events(engine)
                + check_positions(engine) + check_ranks(engine))
    if problems:
        raise SanitizerError(
            f"step {engine.steps}: {len(problems)} sanitizer "
            f"violation(s):\n  - " + "\n  - ".join(problems))
