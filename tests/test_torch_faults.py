"""The port's fault injection and step-boundary sanitizers (CPU, plain
kernel versions, the llama3 smoke model with random seeded W4 weights).

- ``FaultInjector.from_spec`` and ``random_schedule`` build the JAX
  reference's schedules, fault for fault, and the injector's accounting
  (fire once, hits, fired) follows it on the same consultations.
- Each sanitizer detects the invariant it guards when the state is
  corrupted by hand, names it in its ``SanitizerError``, and the error
  escapes ``step()``'s backstop; with ``sanitize=False`` the same
  corruption passes silently.
- Every fault point isolates what the reference isolates (a named
  schedule each), and seeded chaos sweeps over ``ENGINE_FAULT_POINTS``
  and over ``ENGINE_FAULT_POINTS + SPEC_FAULT_POINTS`` (speculation on
  every request) run under the sanitizers: the workload drains, the
  pages return to their baseline, nothing reaches the backstop.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.serving import faults as JF
from repro_torch.configs import get_smoke_config
from repro_torch.models.lm import LM, QuantConfig
from repro_torch.serving import faults as F
from repro_torch.serving.api import RequestState, SamplingParams
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.sanitize import (SanitizerError, check_cache,
                                          check_events, check_positions)

NUM_PAGES = 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's side runs tiny shapes: PyTorch's intra-op threads would
    only contend with the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def smoke():
    cfg = get_smoke_config("llama3_8b")
    return cfg, LM(cfg).init(seed=0, device="cpu")


def make_engine(smoke, faults=None, **kw):
    cfg, params = smoke
    ecfg = EngineConfig(**{**dict(max_batch=4, num_pages=NUM_PAGES,
                                  page_size=8, max_pages_per_seq=16,
                                  prefill_chunk_tokens=24, kv_range=4.0,
                                  sanitize=True), **kw})
    return Engine(cfg, params, QuantConfig(impl="ref"), ecfg, device="cpu",
                  **({} if faults is None else {"faults": faults}))


def assert_serving_invariants(eng, num_pages=NUM_PAGES):
    assert not eng.sched.has_work
    assert eng.cache.pages_free == num_pages
    assert (eng.cache.ref == 0).all() and not eng.cache.active
    for req in eng._by_id.values():
        assert req.state.terminal, (req.request_id, req.state)
        terminals = [e for e in req.events if e.finished]
        assert len(terminals) == 1 and req.events[-1].finished
        tokens = [e for e in req.events if e.token is not None]
        assert len(tokens) == req.emitted


# ------------------------------------------------------------ schedules

def _faults(inj):
    return [(f.point, f.nth, f.step, f.action, f.row) for f in inj.faults]


def test_point_tuples_are_the_reference():
    assert F.ENGINE_FAULT_POINTS == JF.ENGINE_FAULT_POINTS
    assert F.SPEC_FAULT_POINTS == JF.SPEC_FAULT_POINTS
    assert F.FAULT_POINTS == JF.FAULT_POINTS


@pytest.mark.parametrize("spec", [
    "forward:step=3,action=nan,row=2; alloc_page:nth=20; sample:nth=2",
    "draft:nth=3,action=raise;verify:nth=2;forward:step=14,action=nan",
    "draft:nth=1,action=empty;emit_event:nth=4;append_kv:nth=7",
    "crash:step=5;snapshot_write:nth=1", ""])
def test_from_spec_matches_reference(spec):
    got, want = F.FaultInjector.from_spec(spec), JF.FaultInjector.from_spec(
        spec)
    assert _faults(got) == _faults(want)
    assert got.describe() == want.describe()


@pytest.mark.parametrize("bad", ["forward:when=3", "bogus:nth=1",
                                 "forward:nth=1,step=2",
                                 "sample:nth=1,action=nan"])
def test_from_spec_refuses_what_the_reference_refuses(bad):
    with pytest.raises(ValueError) as got:
        F.FaultInjector.from_spec(bad)
    with pytest.raises(ValueError) as want:
        JF.FaultInjector.from_spec(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 1234])
@pytest.mark.parametrize("points", ["engine", "engine+spec", "all"])
def test_random_schedule_matches_reference(seed, points):
    pts = {"engine": F.ENGINE_FAULT_POINTS,
           "engine+spec": F.ENGINE_FAULT_POINTS + F.SPEC_FAULT_POINTS,
           "all": F.FAULT_POINTS}[points]
    got = F.FaultInjector.random_schedule(seed, n_faults=5, points=pts)
    want = JF.FaultInjector.random_schedule(seed, n_faults=5, points=pts)
    assert _faults(got) == _faults(want)


def test_injector_accounting_matches_reference():
    """The same consultations fire the same faults, once each."""
    spec = "sample:nth=2;sample:nth=3;forward:step=3;draft:step=3"
    got, want = (F.FaultInjector.from_spec(spec),
                 JF.FaultInjector.from_spec(spec))
    calls = [(1, "sample"), (2, "sample"), (2, "forward"), (3, "sample"),
             (3, "forward"), (3, "forward"), (3, "draft"), (4, "sample")]
    for step, point in calls:
        got.begin_step(step)
        want.begin_step(step)
        a, b = got.check(point), want.check(point)
        assert (a is None) == (b is None), (step, point)
    assert got.fired == want.fired
    assert got.hits == want.hits
    assert got.pending == [] and want.pending == []


# ----------------------------------------------------------- sanitizers

def _mapped_page(eng) -> int:
    sid = next(iter(eng.cache.active))
    return int(eng.cache.block_table[sid, 0])


def _corrupt_refcount(eng):
    eng.cache.ref[_mapped_page(eng)] += 1


def _corrupt_free_list(eng):
    eng.cache.free_pages.append(_mapped_page(eng))


def _corrupt_kv_length(eng):
    req = next(r for r in eng.sched.running if r.prefilled)
    eng.cache.seq_len[req.seq_slot] += 1     # a leaked draft token


def _corrupt_double_terminal(eng):
    req = next(r for r in eng._by_id.values() if r.state.terminal)
    req.terminal_emitted = False
    eng._emit(req)


def _corrupt_token_after_terminal(eng):
    req = next(r for r in eng._by_id.values() if r.state.terminal)
    saved = req.state
    req.state = RequestState.DECODING
    eng._emit(req, token=7)
    req.state = saved


def _corrupt_position_jump(eng):
    req = next(r for r in eng.sched.running if len(r.generated) > 1)
    last = req.events[-1]                     # a skipped position
    req.events[-1] = dataclasses.replace(
        last, num_generated=last.num_generated + 1)


# name → (corrupt, the invariant named, steps before it, max_new)
CORRUPTIONS = {
    "refcount": (_corrupt_refcount, "page-refcount conservation", 1, 4),
    "free_list": (_corrupt_free_list, "page-refcount conservation", 1, 4),
    "kv_length": (_corrupt_kv_length, "kv-length-consistency", 2, 8),
    "double_terminal": (_corrupt_double_terminal, "exactly-one-terminal",
                        None, 2),
    "token_after_terminal": (_corrupt_token_after_terminal,
                             "no-token-after-terminal", None, 2),
    "position_jump": (_corrupt_position_jump, "emitted-position-monotonic",
                      3, 8),
}


def _corrupted_engine(smoke, name, sanitize):
    corrupt, _, steps, max_new = CORRUPTIONS[name]
    eng = make_engine(smoke, sanitize=sanitize)
    for i in range(2):
        eng.submit(list(range(3 + i, 15 + i)),
                   SamplingParams(max_new_tokens=max_new))
    if steps is None:
        while eng.sched.has_work:
            eng.step()
    else:
        for _ in range(steps):
            eng.step()
    corrupt(eng)
    return eng


@pytest.mark.parametrize("name", list(CORRUPTIONS))
def test_sanitizer_detects_corruption(smoke, name):
    eng = _corrupted_engine(smoke, name, sanitize=True)
    before = eng.internal_errors
    with pytest.raises(SanitizerError, match=CORRUPTIONS[name][1]):
        eng.step()
    assert eng.internal_errors == before     # not swallowed by the backstop


@pytest.mark.parametrize("name", ["refcount", "double_terminal"])
def test_sanitizer_off_is_silent(smoke, name):
    eng = _corrupted_engine(smoke, name, sanitize=False)
    eng.step()
    assert eng.sanitize_checks == 0 and eng.internal_errors == 0


def test_clean_run_passes_every_check(smoke):
    eng = make_engine(smoke)
    for i in range(3):
        eng.submit(list(range(3, 14 + 9 * i)),
                   SamplingParams(max_new_tokens=5, speculation=2))
    while eng.sched.has_work:
        eng.step()
        assert check_positions(eng) == []
    assert eng.sanitize_checks == eng.steps > 0
    assert check_cache(eng.cache) == [] and check_events(eng) == []
    assert eng.counters()["sanitize_checks"] == eng.steps


# ------------------------------------------------- per-point schedules

def _submit(eng, n, max_new, **kw):
    return [eng.submit([3 + i, 5, 7, 11, 13],
                       SamplingParams(max_new_tokens=max_new, **kw))
            for i in range(n)]


def test_forward_raise_quarantines_batch(smoke):
    fi = F.FaultInjector([F.Fault("forward", step=2, action="raise")])
    eng = make_engine(smoke, faults=fi)
    hs = _submit(eng, 3, 6)
    eng.run(max_steps=100)
    assert all(eng.result(h).state == RequestState.FAILED for h in hs)
    assert all(eng.result(h).stop_reason.startswith("forward:") for h in hs)
    assert eng.failed_count == 3 and fi.fired == [("forward", "raise", 2)]
    assert_serving_invariants(eng)
    assert eng.internal_errors == 0


def test_forward_nan_isolates_single_row(smoke):
    fi = F.FaultInjector([F.Fault("forward", step=3, action="nan", row=1)])
    eng = make_engine(smoke, faults=fi)
    hs = _submit(eng, 3, 6)
    eng.run(max_steps=100)
    states = [eng.result(h).state for h in hs]
    assert states.count(RequestState.FAILED) == 1
    assert eng.result(hs[states.index(RequestState.FAILED)]).stop_reason \
        == "non_finite_logits"
    assert all(len(eng.result(h).generated) == 6 for h, s in zip(hs, states)
               if s == RequestState.FINISHED)
    assert_serving_invariants(eng)
    assert eng.internal_errors == 0


def test_sample_fault_fails_only_sampled_rows(smoke):
    fi = F.FaultInjector([F.Fault("sample", nth=2)])
    eng = make_engine(smoke, faults=fi)
    ha = eng.submit([2, 3, 5, 7, 11, 13], SamplingParams(max_new_tokens=6))
    hb = eng.submit(list(range(2, 62)), SamplingParams(max_new_tokens=4))
    eng.run(max_steps=100)
    assert eng.result(ha).state == RequestState.FAILED
    assert eng.result(ha).stop_reason.startswith("sample:")
    assert eng.result(hb).state == RequestState.FINISHED
    assert len(eng.result(hb).generated) == 4 and eng.failed_count == 1
    assert_serving_invariants(eng)
    assert eng.internal_errors == 0


def test_append_kv_fault_quarantines_batch(smoke):
    fi = F.FaultInjector([F.Fault("append_kv", nth=3)])
    eng = make_engine(smoke, faults=fi)
    hs = [eng.submit([3 + i, 5, 7, 11], SamplingParams(max_new_tokens=5))
          for i in range(2)]
    eng.run(max_steps=100)
    assert all(eng.result(h).state == RequestState.FAILED
               and "append_kv" in eng.result(h).stop_reason for h in hs)
    assert_serving_invariants(eng)
    assert eng.internal_errors == 0


def test_alloc_exhaust_defers_admission(smoke):
    fi = F.FaultInjector([F.Fault("alloc_page", nth=1)])
    eng = make_engine(smoke, faults=fi)
    h = eng.submit([2, 3, 5, 7], SamplingParams(max_new_tokens=4))
    eng.run(max_steps=100)
    assert fi.fired[0][0] == "alloc_page"
    assert eng.result(h).state == RequestState.FINISHED
    assert len(eng.result(h).generated) == 4 and eng.failed_count == 0
    assert_serving_invariants(eng)


def test_emit_event_fault_detaches_callback(smoke):
    fi = F.FaultInjector([F.Fault("emit_event", nth=2)])
    eng = make_engine(smoke, faults=fi)
    received = []
    h = eng.submit([2, 3, 5, 7], SamplingParams(max_new_tokens=4),
                   on_event=received.append)
    eng.run(max_steps=100)
    req = eng.result(h)
    assert req.state == RequestState.FINISHED and len(req.generated) == 4
    assert eng.callback_errors == 1 and req.on_event is None
    assert len(received) == 1
    assert_serving_invariants(eng)


# the smoke model's greedy decode falls into a cycle on this prompt, so
# prompt lookup drafts tokens that verification accepts
CYCLING = [[188] * 8, [139, 133, 188, 188] * 2]


def _spec_run(smoke, faults=None, max_new=12):
    eng = make_engine(smoke, faults=faults, max_batch=6, num_pages=128,
                      max_pages_per_seq=32)
    for i, p in enumerate(CYCLING):
        eng.submit(p, SamplingParams(max_new_tokens=max_new, speculation=4),
                   request_id=i)
    done = eng.run(max_steps=300)
    return eng, {r.request_id: [e.token for e in r.events
                                if e.token is not None] for r in done}


def test_draft_fault_degrades_to_plain_decode(smoke):
    _, baseline = _spec_run(smoke)
    fi = F.FaultInjector([F.Fault("draft", nth=1, action="raise"),
                          F.Fault("draft", nth=3, action="empty")])
    eng, out = _spec_run(smoke, fi)
    assert out == baseline
    assert eng.draft_errors == 1 and eng.internal_errors == 0
    assert {p for p, _, _ in fi.fired} == {"draft"}
    assert eng.last_error.startswith("draft:")


def test_verify_fault_quarantines_one_request(smoke):
    fi = F.FaultInjector([F.Fault("verify", nth=1)])
    eng, _ = _spec_run(smoke, fi)
    failed = [r for r in eng.sched.finished
              if r.state == RequestState.FAILED]
    assert len(failed) == 1 and "verify" in failed[0].stop_reason
    done = [r for r in eng.sched.finished
            if r.state == RequestState.FINISHED]
    assert len(done) == 1 and len(done[0].generated) == 12
    assert eng.spec_draft_tokens == (eng.spec_accepted_tokens
                                     + eng.spec_rollback_tokens)
    assert eng.internal_errors == 0
    assert eng.cache.pages_free == 128


# ------------------------------------------------------------ chaos sweeps

# what each seed of the speculation sweep fired, for the coverage test
SPEC_SWEEP_FIRED: dict = {}


def _chaos(smoke, seed, points, speculation):
    cfg = smoke[0]
    fi = F.FaultInjector.random_schedule(seed, points=points)
    eng = make_engine(smoke, faults=fi)
    rng = np.random.default_rng(seed)
    prompts = [CYCLING[seed % 2], rng.integers(1, cfg.vocab_size,
                                              12).tolist(),
               CYCLING[(seed + 1) % 2],
               rng.integers(1, cfg.vocab_size,
                            int(rng.integers(5, 40))).tolist()]
    sink = []
    for i, p in enumerate(prompts):
        # callbacks on two requests arm the emit_event point
        eng.submit(p, SamplingParams(
            max_new_tokens=int(rng.integers(8, 25)),
            temperature=0.7 if i == 1 else 0.0, top_k=8,
            speculation=speculation),
            on_event=sink.append if i in (0, 2) else None)
    eng.run(max_steps=400)
    assert_serving_invariants(eng)
    assert eng.internal_errors == 0, eng.last_error
    assert eng.sanitize_checks == eng.steps
    assert all(p in F.FAULT_POINTS for p, _, _ in fi.fired)
    assert eng.spec_draft_tokens == (eng.spec_accepted_tokens
                                     + eng.spec_rollback_tokens)
    return fi


@pytest.mark.parametrize("seed", range(8))
def test_chaos_engine_points(smoke, seed):
    _chaos(smoke, seed, F.ENGINE_FAULT_POINTS, 0)


@pytest.mark.parametrize("seed", range(12))
def test_chaos_engine_and_spec_points(smoke, seed):
    fi = _chaos(smoke, seed, F.ENGINE_FAULT_POINTS + F.SPEC_FAULT_POINTS, 3)
    SPEC_SWEEP_FIRED[seed] = {p for p, _, _ in fi.fired}


def test_chaos_sweep_reaches_every_point(smoke):
    """Across the sweep's seeds every engine and speculation point fired
    at least once: the sweep exercises each failure path. (Seeds the
    sweep above did not run in this pytest run are run here.)"""
    fired = set()
    for seed in range(12):
        if seed not in SPEC_SWEEP_FIRED:
            test_chaos_engine_and_spec_points(smoke, seed)
        fired |= SPEC_SWEEP_FIRED[seed]
    assert fired == set(F.ENGINE_FAULT_POINTS + F.SPEC_FAULT_POINTS)


def test_inject_faults_spec_builds_the_injector(smoke):
    eng = make_engine(smoke, inject_faults="forward:step=2,action=raise")
    assert eng.faults.describe() == "forward[step=2,action=raise]"
    assert eng.cache.faults is eng.faults
    _submit(eng, 2, 4)
    eng.run(max_steps=50)
    assert eng.failed_count == 2 and eng.internal_errors == 0
