"""Deadlines, the bounded waiting queue and the lifecycle stamps of the
port against the reference (CPU, plain kernel versions).

The scheduler and cache cases port the reference's own tests
(``tests/serving/test_scheduler.py``, ``tests/serving/test_paged_cache.py``)
onto the port's classes. The engine cases drive the JAX engine (its
unified forward un-jitted, as ``tests/test_torch_engine.py`` explains) and
the port's engine with the same converted weights, the same request
stream and the same injected clock, a counter that advances 1 ms on every
read: both engines must read it at the same points for every stamp to
agree. Each case asserts equal events (tokens, terminal states and stop
reasons), partial outputs, counters, pages and arrival / first-token /
terminal stamps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import get_smoke_config as j_smoke_config
from repro.models.lm import LM as JLM
from repro.models.lm import QuantConfig as JQuantConfig
from repro.serving import api as JAPI
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models.lm import QuantConfig
from repro_torch.serving import api as API
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.kv_cache import PagedKV4Cache, PagedKV4Config
from repro_torch.serving.scheduler import Request, Scheduler

RequestState = API.RequestState
SamplingParams = API.SamplingParams


# ------------------------------------------------ scheduler (reference's)

def make_cache(num_pages=16, page_size=8, max_seqs=8):
    return PagedKV4Cache(
        get_smoke_config("llama3_8b"),
        PagedKV4Config(num_pages=num_pages, page_size=page_size,
                       max_seqs=max_seqs, max_pages_per_seq=8), 1,
        device="cpu")


def test_reject_and_waiting_full():
    """waiting_full flips at max_waiting; reject() sends a request to
    FAILED("queue_full") without it entering the queue."""
    sched = Scheduler(max_batch=4, max_seqs=8, max_waiting=2)
    assert not sched.waiting_full
    sched.submit(Request(0, [1], 2, arrived_at=0.0))
    sched.submit(Request(1, [2], 2, arrived_at=1.0))
    assert sched.waiting_full
    late = Request(2, [3], 2, arrived_at=2.0)
    sched.reject(late)
    assert late.state == RequestState.FAILED
    assert late.stop_reason == "queue_full"
    assert late in sched.finished and len(sched.waiting) == 2
    assert not Scheduler(max_batch=4, max_seqs=8).waiting_full


def test_preempt_sheds_victim_when_waiting_full():
    """A victim that cannot re-queue without overflowing the bounded
    queue is shed (FAILED "shed"), partial output kept, pages freed; with
    headroom the same preemption re-queues."""
    cache = make_cache()
    sched = Scheduler(max_batch=4, max_seqs=8, max_waiting=1)
    sched.submit(Request(0, [1, 2, 3], 10, arrived_at=0.0))
    sched.submit(Request(1, [4, 5, 6], 10, arrived_at=1.0))
    sched.admit(cache)
    sched.submit(Request(2, [7, 8], 4, arrived_at=2.0))  # queue now full
    free_before = cache.pages_free
    for r in sched.running:
        r.generated = [9]
        r.prefill_pos = len(r.prompt)
    victim = sched.preempt_one(cache)
    assert victim.request_id == 1                # youngest
    assert victim.state == RequestState.FAILED
    assert victim.stop_reason == "shed"
    assert victim.generated == [9]
    assert victim in sched.finished and victim not in sched.waiting
    assert cache.pages_free == free_before + 1
    sched2 = Scheduler(max_batch=4, max_seqs=8, max_waiting=5)
    cache2 = make_cache()
    sched2.submit(Request(0, [1, 2, 3], 10, arrived_at=0.0))
    sched2.admit(cache2)
    v2 = sched2.preempt_one(cache2)
    assert v2.state == RequestState.QUEUED and v2 in sched2.waiting


def test_expire_deadlines_running_and_waiting():
    """expire_deadlines sweeps both queues: running requests free their
    pages, waiting ones leave the queue; requests within budget or
    without params are untouched; a first token makes TTFT moot."""
    cache = make_cache()
    sched = Scheduler(max_batch=1, max_seqs=8)
    doomed = Request(0, [1, 2, 3], 5, arrived_at=0.0,
                     params=SamplingParams(max_new_tokens=5,
                                           deadline_ms=10.0))
    safe = Request(1, [4, 5], 5, arrived_at=0.0,
                   params=SamplingParams(max_new_tokens=5,
                                         deadline_ms=10_000.0))
    queued_doomed = Request(2, [6], 5, arrived_at=0.0,
                            params=SamplingParams(max_new_tokens=5,
                                                  ttft_ms=10.0))
    no_params = Request(3, [7], 5, arrived_at=0.0)
    for r in (doomed, safe, queued_doomed, no_params):
        sched.submit(r)
    sched.admit(cache)
    assert doomed in sched.running
    doomed.generated = [8]
    baseline = cache.pages_free
    expired = sched.expire_deadlines(cache, now=0.020)
    assert {r.request_id for r in expired} == {0, 2}
    assert doomed.state == RequestState.TIMED_OUT
    assert doomed.stop_reason == "deadline"
    assert doomed.generated == [8]
    assert queued_doomed.stop_reason == "ttft_budget"
    assert cache.pages_free == baseline + 1
    assert safe in sched.waiting and no_params in sched.waiting
    safe.first_token_at = 0.001
    assert sched.expire_deadlines(cache, now=0.021) == []


@pytest.mark.parametrize("field,value", [("deadline_ms", 0.0),
                                         ("ttft_ms", -1.0)])
def test_sampling_params_validate_budgets(field, value):
    for sp in (SamplingParams, JAPI.SamplingParams):
        with pytest.raises(ValueError, match=field):
            sp(**{field: value})


def test_max_waiting_validated():
    for ec in (EngineConfig, JEngineConfig):
        with pytest.raises(ValueError, match="max_waiting"):
            ec(max_waiting=0)


# ---------------------------------------------------- cache (reference's)

def make_capped_cache(max_pages_cached, num_pages=8, page_size=4):
    cfg = get_smoke_config("llama3_8b")
    pb = 2 * page_size * cfg.num_kv_heads * (cfg.head_dim // 2)
    return PagedKV4Cache(
        cfg, PagedKV4Config(num_pages=num_pages, page_size=page_size,
                            max_seqs=4, max_pages_per_seq=8,
                            reclaimable_max_bytes=max_pages_cached * pb), 1,
        device="cpu")


def publish_and_free(cache, seq_id, tokens):
    assert cache.allocate_seq(seq_id, len(tokens))
    cache.seq_len[seq_id] = len(tokens)
    cache.publish_prefix(seq_id, tokens)
    cache.free_seq(seq_id)


def test_reclaimable_byte_cap_evicts_lru():
    """Publishing past the byte cap evicts oldest-first (index entries
    too), the eviction counter ticks, the newest prefixes stay matchable
    and evicted pages are on the free list."""
    cache = make_capped_cache(max_pages_cached=2)
    prompts = [[i * 10 + j for j in range(5)] for i in range(3)]
    for i, p in enumerate(prompts[:2]):
        publish_and_free(cache, i, p)
    assert cache.prefix_reclaimable_bytes == 2 * cache.page_bytes
    assert cache.prefix_evicted_pages == 0
    publish_and_free(cache, 2, prompts[2])
    assert cache.prefix_reclaimable_bytes == 2 * cache.page_bytes
    assert cache.prefix_evicted_pages == 1
    assert cache.match_prefix(prompts[0]) == ([], 0)
    assert cache.match_prefix(prompts[1])[1] == 4
    assert cache.match_prefix(prompts[2])[1] == 4
    assert cache.pages_free == 8 and len(cache.free_pages) == 6


def test_zero_byte_cap_disables_caching_without_leaks():
    """Cap 0: every published page is evicted as its refcount drops,
    every page returns to the free list, matching never hits."""
    cache = make_capped_cache(max_pages_cached=0)
    tokens = list(range(1, 10))
    publish_and_free(cache, 0, tokens)
    assert cache.prefix_reclaimable_bytes == 0
    assert cache.prefix_evicted_pages == 2
    assert cache.match_prefix(tokens + [99]) == ([], 0)
    assert len(cache.free_pages) == 8


# ------------------------------------------- engines on the same clock

@pytest.fixture(scope="module")
def model():
    """The smoke model's reference-quantized weights (numpy-seeded fp
    weights), on both sides."""
    jcfg, cfg = j_smoke_config("llama3_8b"), get_smoke_config("llama3_8b")
    rng = np.random.default_rng(0)
    n, d, f, v = jcfg.num_layers, jcfg.d_model, jcfg.d_ff, jcfg.vocab_size

    def lin(i, o):
        return {"w": (rng.standard_normal((n, i, o)) / np.sqrt(i))
                .astype(np.float32)}

    fp = {
        "embed": {"table": rng.standard_normal((v, d)).astype(np.float32)},
        "final_norm": {"scale": np.ones(d, np.float32)},
        "lm_head": {"w": (rng.standard_normal((d, v)) / np.sqrt(d))
                    .astype(np.float32)},
        "blocks": {
            "attn_norm": {"scale": np.ones((n, d), np.float32)},
            "mlp_norm": {"scale": np.ones((n, d), np.float32)},
            "attn": {"wq": lin(d, jcfg.q_dim), "wk": lin(d, jcfg.kv_dim),
                     "wv": lin(d, jcfg.kv_dim), "wo": lin(jcfg.q_dim, d)},
            "mlp": {"w_up": lin(d, f), "w_gate": lin(d, f),
                    "w_down": lin(f, d)},
        },
    }
    fp = jax.tree.map(jnp.asarray, fp)
    jqc = JQuantConfig(weight_only=False, impl="ref")
    qparams, _ = JLM(jcfg, quant=jqc).quantize(
        fp, jax.tree.map(lambda a: None, fp))
    tparams = params_from_jax(jax.tree.map(np.asarray, qparams),
                              device="cpu")
    return jcfg, cfg, jqc, qparams, tparams


class TickClock:
    """1.0 s, then 1 ms later on every read."""

    def __init__(self):
        self.reads = 0

    def __call__(self) -> float:
        self.reads += 1
        return 1.0 + 0.001 * (self.reads - 1)


ENGINE = dict(max_batch=4, num_pages=64, page_size=8, max_pages_per_seq=16,
              prefill_chunk_tokens=24, kv_range=4.0)


def _prompts(n, lo=4, hi=12, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 500, int(k)).tolist()
            for k in rng.integers(lo, hi + 1, n)]


def _deadlines(eng, sp):
    """A running request expires mid-decode (deadline), a waiting one
    before its first token (ttft_budget), a third finishes."""
    p = _prompts(3)
    ha = eng.submit(p[0], sp(max_new_tokens=12, deadline_ms=9.0))
    hb = eng.submit(p[1], sp(max_new_tokens=4, ttft_ms=5.0))
    hc = eng.submit(p[2], sp(max_new_tokens=3))
    eng.run(max_steps=100)
    return ha, hb, hc


def _queue(eng, sp):
    """Against a one-slot waiting queue: a rejected submit, then two
    sequences that outgrow a 4-page pool with the queue held full, so the
    preemption victim is shed."""
    p = _prompts(4, lo=8, hi=8, seed=11)
    ha = eng.submit(p[0], sp(max_new_tokens=12))
    eng.step()
    hb = eng.submit(p[1], sp(max_new_tokens=12))
    eng.step()
    hc = eng.submit(p[2], sp(max_new_tokens=2))
    hd = eng.submit(p[3], sp(max_new_tokens=2))          # queue full
    eng.run(max_steps=300)
    return ha, hb, hc, hd


def _preempt(eng, sp):
    """Two sequences outgrow a 4-page pool with no queue bound: the
    youngest is preempted after its first tokens and re-admitted later;
    its first-token stamp must survive the re-queue."""
    p = _prompts(2, lo=8, hi=8, seed=11)
    ha = eng.submit(p[0], sp(max_new_tokens=12))
    eng.step()
    hb = eng.submit(p[1], sp(max_new_tokens=12))
    eng.run(max_steps=300)
    return ha, hb


SCENARIOS = {
    "deadlines": (_deadlines, dict(max_batch=1)),
    "queue_full_and_shed": (_queue, dict(max_batch=2, num_pages=4,
                                         max_pages_per_seq=4, max_waiting=1)),
    "ttft_across_preemption": (_preempt, dict(max_batch=2, num_pages=4,
                                              max_pages_per_seq=4)),
}
COUNTERS = ("steps", "tokens_generated", "forward_calls", "aborted_count",
            "failed_count", "timeout_count", "shed_count", "rejected_count",
            "internal_errors", "callback_errors", "prefix_hit_tokens",
            "prefill_tokens", "interleaved_steps")


def _record(eng, handles, clock):
    reqs = [eng.result(h) for h in handles]
    return {
        "events": [(e.request_id, e.state.value, e.token, e.num_generated,
                    e.stop_reason, e.finished)
                   for r in reqs for e in r.events],
        "requests": [(r.state.value, r.stop_reason, list(r.generated),
                      r.arrived_at, r.first_token_at, r.finished_at)
                     for r in reqs],
        "counters": {k: getattr(eng, k) for k in COUNTERS},
        "preemptions": eng.sched.preemptions,
        "pages_free": eng.cache.pages_free,
        "clock_reads": clock.reads,
    }


@pytest.fixture(scope="module", params=list(SCENARIOS))
def pair(request, model):
    jcfg, cfg, jqc, qparams, tparams = model
    drive, kw = SCENARIOS[request.param]
    ecfg = dict(ENGINE, **kw)
    jclock, tclock = TickClock(), TickClock()
    je = JEngine(jcfg, qparams, jqc, JEngineConfig(**ecfg), clock=jclock)
    je._fwd = je._unified_forward           # eager: see the module docstring
    te = Engine(cfg, tparams, QuantConfig(impl="ref"), EngineConfig(**ecfg),
                device="cpu", clock=tclock)
    jrec = _record(je, drive(je, JAPI.SamplingParams), jclock)
    trec = _record(te, drive(te, SamplingParams), tclock)
    return request.param, jrec, trec


def test_same_lifecycle_as_reference(pair):
    """Same events, partial outputs, stamps, counters and pages."""
    name, jrec, trec = pair
    for key in jrec:
        assert trec[key] == jrec[key], (name, key)
    c = trec["counters"]
    assert c["internal_errors"] == c["failed_count"] == 0
    reasons = [r[1] for r in trec["requests"]]
    if name == "deadlines":
        assert reasons == ["deadline", "ttft_budget", None]
        assert c["timeout_count"] == 2
        assert 0 < len(trec["requests"][0][2]) < 12     # partial output
    elif name == "queue_full_and_shed":
        assert reasons.count("queue_full") == 1 and "shed" in reasons
        assert c["rejected_count"] == 1 and c["shed_count"] >= 1
    else:
        assert trec["preemptions"] >= 1 and reasons == [None, None]


def test_stamps_bracket_the_lifecycle(pair):
    """arrival ≤ first token ≤ terminal event for every request that
    produced a token; a preempted request keeps its first incarnation's
    first-token stamp, so its TTFT is shorter than its re-admission."""
    name, _, trec = pair
    for state, _, gen, arrived, first, fin in trec["requests"]:
        assert fin >= arrived > 0
        if gen:
            assert arrived < first <= fin
        else:
            assert first == 0.0
    if name == "ttft_across_preemption":
        # the victim's first token came before the other request finished
        (_, _, _, _, first_a, fin_a), (_, _, _, _, first_b, fin_b) = \
            trec["requests"]
        assert first_b < fin_a < fin_b
