"""The port's speculative decode against the JAX reference (CPU, plain
kernel versions).

- The prompt-lookup draft source is a copy of the reference's: the same
  drafts on the reference's own cases.
- ``truncate_seq`` (the rollback) leaves the port's cache in the
  reference cache's state after the same operations: block tables,
  refcounts, free list, reclaimable LRU, lengths — shared and published
  pages included.
- The engine pair: ``test_torch_engine.py``'s model, engine settings
  and pinned requests, ``speculation=4`` on both engines with the same
  draft source. Each forward's logits (every position of every verify
  chunk) are held as that file holds the unified step (2e-2·max|logit|),
  with greedy agreement and equal speculation counters.
- The port alone (the llama3 smoke model): speculation on gives the
  tokens of speculation off in fewer forwards; submit validation, the
  single-token no-op and the budget debit.
"""
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as j_smoke_config
from repro.serving import kv_cache as JKVC
from repro.serving.api import SamplingParams as JSamplingParams
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.speculation import PromptLookupDraft as JPromptLookupDraft
from repro_torch.configs import get_smoke_config
from repro_torch.models.lm import LM, QuantConfig
from repro_torch.serving import kv_cache as KVC
from repro_torch.serving.api import RequestState, SamplingParams
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.speculation import PromptLookupDraft
from test_torch_engine import (ENGINE, PROMPT_LENS, _prompts,  # noqa: F401
                               _rel_err, model)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's side runs tiny shapes: PyTorch's intra-op threads would
    only contend with the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# ------------------------------------------------ prompt-lookup drafting

PLD_CASES = {   # (max_ngram, min_ngram), prompt, generated, k → draft
    "full_continuation": ((3, 1), [1, 3, 4, 5, 6], [3], 3, [4, 5, 6]),
    "full_over_recent_clip": ((3, 1), [7] * 10, [], 4, [7, 7, 7, 7]),
    "longest_partial": ((3, 1), [1, 2, 8, 9], [2], 4, [8, 9, 2]),
    "no_match": ((3, 1), [1, 2, 3, 4], [5], 3, []),
    "k0": ((3, 1), [1, 2, 1, 2], [1], 0, []),
    "ngram_backoff": ((3, 1), [9, 4, 1, 2, 3], [9], 2, [4, 1]),
    "bigram_only": ((2, 2), [5, 6, 7, 5, 6], [], 3, [7, 5, 6]),
    "bigram_needs_two": ((2, 2), [5, 6, 7, 9, 6], [], 3, []),
}


@pytest.mark.parametrize("case", list(PLD_CASES))
def test_prompt_lookup_cases(case):
    (mx, mn), prompt, generated, k, want = PLD_CASES[case]
    got = PromptLookupDraft(mx, mn).draft(prompt, generated, k)
    assert got == want
    assert got == JPromptLookupDraft(mx, mn).draft(prompt, generated, k)


def test_prompt_lookup_validation():
    with pytest.raises(ValueError, match="min_ngram"):
        PromptLookupDraft(max_ngram=1, min_ngram=2)
    assert PromptLookupDraft().describe() == JPromptLookupDraft().describe()


# ---------------------------------------------------------- truncate_seq

PS = 4
TOKENS = list(range(1, 9))          # two full pages
TRUNCATE_CASES = {
    # a verify chunk grew the row; the tail pages go back to the pool
    "tail": [("allocate_seq", 0, 16), ("len", 0, 16), ("truncate_seq", 0, 6),
             ("truncate_seq", 0, 5), ("grow_to", 0, 16),
             ("truncate_seq", 0, 11), ("free_seq", 0)],
    # new_len past seq_len, within the page-backed capacity
    "advance": [("allocate_seq", 0, 10), ("len", 0, 7),
                ("truncate_seq", 0, 11), ("truncate_seq", 0, 12)],
    # an adopter's rollback drops its own references only; the
    # publisher's pages stay mapped and matchable
    "shared": [("allocate_seq", 0, 8), ("len", 0, 8), ("publish", 0),
               ("adopt", 1, 12), ("truncate_seq", 1, 4),
               ("truncate_seq", 1, 0), ("free_seq", 1), ("free_seq", 0)],
    # a published page reaching ref 0 parks on the reclaimable LRU
    "published": [("allocate_seq", 0, 12), ("len", 0, 12), ("publish", 0),
                  ("truncate_seq", 0, 5), ("truncate_seq", 0, 0),
                  ("allocate_seq", 1, 28), ("free_seq", 0)],
    # refused calls leave the state as it was
    "errors": [("truncate_seq", 0, 0), ("allocate_seq", 0, 8),
               ("truncate_seq", 0, -1), ("truncate_seq", 0, 9)],
}


def _apply(cache, op):
    name, sid = op[0], op[1]
    if name == "len":
        cache.seq_len[sid] = op[2]
        return None
    if name == "publish":
        cache.publish_prefix(sid, TOKENS)
        return None
    if name == "adopt":
        pages, matched = cache.match_prefix(TOKENS + [99])
        return cache.allocate_seq(sid, op[2], prefix_pages=pages,
                                  prefix_tokens=matched)
    try:
        return getattr(cache, name)(*op[1:])
    except ValueError as e:
        return f"ValueError: {e}"


def _state(cache):
    return dict(table=np.asarray(cache.block_table).tolist(),
                ref=np.asarray(cache.ref).tolist(),
                seq_len=np.asarray(cache.seq_len).tolist(),
                page_count=np.asarray(cache.page_count).tolist(),
                free=[int(p) for p in cache.free_pages],
                lru=[int(p) for p in cache._reclaimable],
                index=sorted(int(p) for p in cache.prefix_index.values()),
                active=sorted(cache.active), pages_free=cache.pages_free)


@pytest.mark.parametrize("case", list(TRUNCATE_CASES))
def test_truncate_seq_matches_reference(case):
    jc = JKVC.PagedKV4Cache(
        j_smoke_config("llama3_8b"),
        JKVC.PagedKV4Config(num_pages=8, page_size=PS, max_seqs=4,
                            max_pages_per_seq=8), num_layer_slots=1)
    tc = KVC.PagedKV4Cache(
        get_smoke_config("llama3_8b"),
        KVC.PagedKV4Config(num_pages=8, page_size=PS, max_seqs=4,
                           max_pages_per_seq=8), num_layer_slots=1,
        device="cpu")
    for op in TRUNCATE_CASES[case]:
        got, want = _apply(tc, op), _apply(jc, op)
        assert got == want, (op, got, want)
        assert _state(tc) == _state(jc), op
    if case == "published":
        assert _state(tc)["lru"], "a published page must reach the LRU"


# ------------------------------------------ the engine pair, speculation=4

class ReplayDraft:
    """Drafts from a recorded greedy run (a pure function of the
    context): the next k recorded tokens while the request's output still
    follows the record, with the last token of every draft for the
    prompts in ``wrong`` changed so that verification rolls back there.
    Both engines take it (``draft_source=``). Prompt lookup on a random
    model drafts only once its output has begun to repeat, many forwards
    in; by then f32 summation-order differences (the attention oracles'
    last bits, turned into whole codes by int4 act-quant) have moved the
    two engines' logits apart with or without speculation, so the verify
    forwards would not be the ones held."""

    def __init__(self, runs: dict, wrong=()):
        self.runs, self.wrong = runs, set(wrong)

    def draft(self, prompt, generated, k):
        seq = self.runs.get(tuple(prompt), [])
        if list(generated) != seq[:len(generated)]:
            return []
        d = list(seq[len(generated):len(generated) + k])
        if tuple(prompt) in self.wrong and len(d) > 1:
            d[-1] = (d[-1] + 1) % 512
        return d

    def describe(self):
        return "ReplayDraft"


SPEC_MAX_NEW = 5     # prefill, one verify forward, one plain decode of
#                      the row whose last draft is rejected: three
#                      forwards, each an eager compile of the reference


def _log_forwards(eng, logs, get):
    inner = eng._guarded_forward

    def wrapped(*a, **k):
        out = inner(*a, **k)
        logs.append(np.array(get(out)))
        return out

    eng._guarded_forward = wrapped


@pytest.fixture(scope="module")
def spec_pair(model):
    """``test_torch_engine.py``'s pinned requests (every prompt prefills
    in step 1) served with speculation 4 by both engines (the JAX one
    eager), each forward's logits logged. The drafts replay the port's
    own speculation-off greedy run; one prompt's drafts end in a wrong
    token."""
    jcfg, cfg, jqc, qparams, tparams = model
    prompts = _prompts(PROMPT_LENS)
    plain = Engine(cfg, tparams, QuantConfig(impl="ref"),
                   EngineConfig(**ENGINE), device="cpu")
    for i, p in enumerate(prompts):
        plain.add_request(i, p, SPEC_MAX_NEW)
    runs = {tuple(prompts[r.request_id]): list(r.generated)
            for r in plain.run()}
    draft = ReplayDraft(runs, wrong=[tuple(prompts[1])])
    je = JEngine(jcfg, qparams, jqc, JEngineConfig(**ENGINE),
                 draft_source=draft)
    je._fwd = je._unified_forward
    te = Engine(cfg, tparams, QuantConfig(impl="ref"), EngineConfig(**ENGINE),
                device="cpu", draft_source=draft)
    logs = {"j": [], "t": []}
    _log_forwards(je, logs["j"], lambda o: o[0])
    _log_forwards(te, logs["t"], lambda o: o)
    for i, p in enumerate(prompts):
        je.submit(p, JSamplingParams(max_new_tokens=SPEC_MAX_NEW,
                                     speculation=4), request_id=i)
        te.submit(p, SamplingParams(max_new_tokens=SPEC_MAX_NEW,
                                    speculation=4), request_id=i)
    je.run()
    te.run()
    return je, te, logs, runs


def test_spec_pair_forward_logits_match(spec_pair):
    """Every forward, the verify forwards' every chunk position included,
    within 2e-2·max|logit| (``test_torch_engine.py``'s bound)."""
    je, te, logs, _ = spec_pair
    assert len(logs["t"]) == len(logs["j"]) == te.forward_calls
    nb = len(PROMPT_LENS)
    assert max(t.shape[0] for t in logs["t"]) > nb    # verify chunks ran
    for step, (t, j) in enumerate(zip(logs["t"], logs["j"])):
        assert t.shape == j.shape, step
        assert _rel_err(t, j) <= 2e-2, step


def plain_forwards(runs: dict) -> int:
    """Forwards a speculation-off run of these requests takes: every
    prompt prefills in the first, then one token a forward."""
    return max(len(t) for t in runs.values())


def test_spec_pair_greedy_agreement_and_counters(spec_pair):
    je, te, _, runs = spec_pair
    jt = {r.request_id: r.generated for r in je.sched.finished}
    tt = {r.request_id: r.generated for r in te.sched.finished}
    assert sorted(tt) == sorted(jt) == list(range(len(PROMPT_LENS)))
    total = sum(len(v) for v in jt.values())
    agree = sum(a == b for i in jt for a, b in zip(jt[i], tt[i])) / total
    assert agree >= 0.9, (jt, tt)
    # the port's speculating run gives its plain run's tokens
    prompts = _prompts(PROMPT_LENS)
    assert all(tt[i] == runs[tuple(prompts[i])] for i in tt)
    assert te.spec_accepted_tokens > 0 and te.spec_rollback_tokens > 0
    assert te.forward_calls == 3 < plain_forwards(runs)
    for name in ("spec_draft_tokens", "spec_accepted_tokens",
                 "spec_rollback_tokens", "spec_noop_count", "draft_errors",
                 "forward_calls", "attn_work_items", "attn_grid_items"):
        assert getattr(te, name) == getattr(je, name), name
    c = te.counters()
    assert c["spec_draft_tokens"] == (c["spec_accepted_tokens"]
                                      + c["spec_rollback_tokens"])
    assert c["internal_errors"] == c["failed_count"] == 0


# ------------------------------------------------------ the port alone

SMOKE_ENGINE = dict(max_batch=6, num_pages=128, page_size=8,
                    max_pages_per_seq=32, prefill_chunk_tokens=24,
                    kv_range=4.0, sanitize=True)


@pytest.fixture(scope="module")
def smoke():
    cfg = get_smoke_config("llama3_8b")
    return cfg, LM(cfg).init(seed=0, device="cpu")


def _smoke_engine(smoke, **kw):
    cfg, params = smoke
    return Engine(cfg, params, QuantConfig(impl="ref"),
                  EngineConfig(**{**SMOKE_ENGINE, **kw}), device="cpu")


def _run_spec(smoke, prompts, max_new, k, temperature=0.0, **kw):
    eng = _smoke_engine(smoke, **kw)
    for i, p in enumerate(prompts):
        eng.submit(p, SamplingParams(max_new_tokens=max_new, speculation=k,
                                     temperature=temperature, top_k=8),
                   request_id=i)
    done = eng.run(max_steps=500)
    return eng, {r.request_id: [e.token for e in r.events
                                if e.token is not None] for r in done}


# the smoke model's greedy decode falls into cycles on these prompts, so
# prompt lookup drafts tokens that verification accepts
CYCLING = [[188] * 8, [139, 133, 188, 188] * 2]


@pytest.mark.parametrize("schedule", ["work_queue", "dense"])
def test_spec_on_matches_off(smoke, schedule):
    free0 = _smoke_engine(smoke).cache.pages_free
    e0, o0 = _run_spec(smoke, CYCLING, 32, 0, attention_schedule=schedule)
    e4, o4 = _run_spec(smoke, CYCLING, 32, 4, attention_schedule=schedule)
    assert o4 == o0
    assert all(len(t) == 32 for t in o4.values())
    assert e4.forward_calls < e0.forward_calls
    assert e4.spec_accepted_tokens > 0
    assert e4.spec_draft_tokens == (e4.spec_accepted_tokens
                                    + e4.spec_rollback_tokens)
    assert e4.sanitize_checks == e4.steps
    for e in (e0, e4):
        assert e.internal_errors == e.failed_count == 0
        assert e.cache.pages_free == free0


def test_spec_stochastic_replays(smoke):
    """Rejection sampling: full-length outputs, conserved counters, and
    the same tokens on a second run (keyed by request and position)."""
    runs = [_run_spec(smoke, CYCLING, 16, 3, temperature=0.8)
            for _ in range(2)]
    (e1, o1), (_, o2) = runs
    assert o1 == o2 and all(len(t) == 16 for t in o1.values())
    assert e1.spec_draft_tokens == (e1.spec_accepted_tokens
                                    + e1.spec_rollback_tokens) > 0
    assert e1.internal_errors == 0


def test_spec_emits_tokens_in_order(smoke):
    evs = []
    eng = _smoke_engine(smoke)
    eng.submit(CYCLING[0], SamplingParams(max_new_tokens=16, speculation=4),
               on_event=evs.append)
    eng.run(max_steps=200)
    nums = [e.num_generated for e in evs if e.token is not None]
    assert nums == list(range(1, 17))
    assert eng.spec_accepted_tokens > 0


def test_submit_validation(smoke):
    with pytest.raises(ValueError, match="speculation"):
        SamplingParams(speculation=-1)
    eng = _smoke_engine(smoke, prefill_chunk_tokens=4)
    with pytest.raises(ValueError, match="speculation"):
        eng.submit([1, 2, 3], SamplingParams(speculation=4))
    eng.submit([1, 2, 3], SamplingParams(speculation=3))    # k + 1 fits
    # a single-token request never decodes: counted, never drafted
    eng2, out = _run_spec(smoke, [CYCLING[0]], 1, 4)
    assert len(out[0]) == 1
    assert eng2.spec_draft_tokens == 0 and eng2.spec_noop_count >= 1
    # the engine-wide defaults reach submit() without params
    eng3 = _smoke_engine(smoke, temperature=0.5, top_k=3)
    h = eng3.submit([1, 2, 3])
    p = eng3.result(h).params
    assert (p.temperature, p.top_k, p.speculation) == (0.5, 3, 0)


def test_drafts_debit_prefill_budget(smoke):
    """With a prompt mid-prefill, drafts shrink the prefill chunk: the
    tokens of each forward stay within ``prefill_chunk_tokens``."""
    cfg = smoke[0]
    budget = 24
    eng = _smoke_engine(smoke, prefill_chunk_tokens=budget)
    seen = []
    orig = eng._forward_step

    def spy(plan, decode):
        seen.append(sum(t for _, _, t in plan)
                    + sum(1 + len(d) for _, d in decode))
        return orig(plan, decode)

    eng._forward_step = spy
    eng.submit(CYCLING[0], SamplingParams(max_new_tokens=16, speculation=8),
               request_id=0)
    eng.step()
    long_prompt = np.random.default_rng(0).integers(
        1, cfg.vocab_size, 60).tolist()
    eng.submit(long_prompt, SamplingParams(max_new_tokens=2), request_id=1)
    eng.run(max_steps=200)
    assert eng.spec_draft_tokens > 0
    assert max(seen) <= budget
    assert eng.internal_errors == 0
    assert all(r.state == RequestState.FINISHED for r in eng.sched.finished)
