"""Journaled crash recovery in the port (``serving/recovery.py``, the
engine's and cache's snapshots), on the CPU.

Held against the reference two ways:

* **Cross-check** on ``test_torch_engine.py``'s pinned workload (its
  2-layer d_model-1024 model, weights converted from the reference's):
  the JAX engine (eager) and the port serve the same requests for two
  steps; the port's own ``snapshot(full=True)`` equals the reference's
  field for field, the int4 pools byte for byte; the reference's blob
  restored into the port continues exactly as the port's own run does
  (token for token), and agrees with the reference's continuation to
  the engine tests' tolerance (greedy agreement ≥ 0.9); the port's blob
  restores into the reference with the same pools.
* **The reference's behaviours** (``tests/serving/test_recovery.py``)
  against the port's engine on the smoke model: bitwise resume, the
  exact split and cursors, pool-shape validation, exactly-once delivery
  across a crash, ``ReplayMismatch`` on a tampered journal, the
  directory mode, uid keys after ``release``, compaction, the torn
  snapshot, and a failed request staying failed.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.lm import LM as JLM
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.models.lm import LM, QuantConfig
from repro_torch.serving.api import RequestState, SamplingParams
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.faults import Fault, FaultInjector, InjectedFault
from repro_torch.serving.recovery import RecoveryLog, ReplayMismatch
from test_torch_engine import DIMS, ENGINE, PROMPT_LENS
from test_torch_engine import _fp_params
from test_torch_engine import _prompts as _pinned_prompts

ECFG = dict(max_batch=4, num_pages=64, page_size=8, max_pages_per_seq=16,
            prefill_chunk_tokens=24, kv_range=4.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny shapes: PyTorch's intra-op threads would only contend with the
    suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------ cross-check against JAX

CROSS_MAX_NEW, CROSS_STEPS = 4, 2


def _clock():
    return 1.0      # one stamp for both engines: the blobs hold the stamps


@pytest.fixture(scope="module")
def cross():
    """Both engines after CROSS_STEPS steps of the pinned workload (every
    prompt prefills in step 1, decode over int4 pages after)."""
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.models.lm import QuantConfig as JQuantConfig
    jcfg, cfg = JModelConfig(**DIMS), ModelConfig(**DIMS)
    jqc = JQuantConfig(weight_only=False, impl="ref")
    fp = jax.tree.map(jnp.asarray, _fp_params())
    qparams, _ = JLM(jcfg, quant=jqc).quantize(
        fp, jax.tree.map(lambda a: None, fp))
    tparams = params_from_jax(jax.tree.map(np.asarray, qparams),
                              device="cpu")
    je = JEngine(jcfg, qparams, jqc, JEngineConfig(**ENGINE), clock=_clock)
    je._fwd = je._unified_forward        # eager (test_torch_engine.py)
    te = Engine(cfg, tparams, QuantConfig(impl="ref"),
                EngineConfig(**ENGINE), device="cpu", clock=_clock)
    for i, p in enumerate(_pinned_prompts(PROMPT_LENS)):
        je.add_request(i, p, CROSS_MAX_NEW)
        te.add_request(i, p, CROSS_MAX_NEW)
    for _ in range(CROSS_STEPS):
        je.step()
        te.step()
    return dict(jcfg=jcfg, cfg=cfg, jqc=jqc, qparams=qparams,
                tparams=tparams, je=je, te=te,
                jblob=je.snapshot(full=True), tblob=te.snapshot(full=True))


def _pool_bytes(cache_state):
    import base64
    return {k: np.frombuffer(base64.b64decode(v), np.uint8)
            for k, v in cache_state["pools"].items()}


def test_full_blob_equals_reference_field_for_field(cross):
    """The port's blob after the same steps is the reference's: every
    engine, scheduler and cache field equal, the pools byte for byte."""
    j, t = json.loads(cross["jblob"]), json.loads(cross["tblob"])
    assert sorted(j) == sorted(t)
    for key in ("format", "steps", "tokens_generated", "next_id",
                "submit_seq"):
        assert j[key] == t[key], key
    assert json.loads(j["sched"]) == json.loads(t["sched"])
    jc, tc = json.loads(j["cache"]), json.loads(t["cache"])
    assert sorted(jc) == sorted(tc)
    for key in jc:
        if key != "pools":
            assert jc[key] == tc[key], key
    jp, tp = _pool_bytes(jc), _pool_bytes(tc)
    for k in ("k", "v"):
        differ = int((jp[k] != tp[k]).sum())
        assert differ == 0, f"{k} pool: {differ} of {jp[k].size} bytes"


def test_reference_blob_restores_into_port_and_continues(cross):
    """The reference's blob restored into the port continues token for
    token as the port's own uninterrupted run, and agrees with the
    reference's continuation to the engine tests' tolerance (greedy
    agreement ≥ 0.9; here every token agreed when written)."""
    te2 = Engine.restore(cross["jblob"], cross["cfg"], cross["tparams"],
                         QuantConfig(impl="ref"), EngineConfig(**ENGINE),
                         device="cpu", clock=_clock)
    assert te2.steps == CROSS_STEPS
    got = {r.request_id: r.generated for r in te2.run()}
    own = {r.request_id: r.generated for r in cross["te"].run()}
    ref = {r.request_id: r.generated for r in cross["je"].run()}
    assert got == own
    total = sum(len(v) for v in ref.values())
    agree = sum(a == b for i in ref for a, b in zip(ref[i], got[i])) / total
    assert sorted(got) == list(range(len(PROMPT_LENS)))
    assert all(len(v) == CROSS_MAX_NEW for v in got.values())
    assert agree >= 0.9, (ref, got)
    assert te2.cache.pages_free == ENGINE["num_pages"]


def test_port_blob_restores_into_reference(cross):
    """The other way: the reference restores the port's blob (no step
    run) with the port's scheduler split and the same pool bytes."""
    je2 = JEngine.restore(cross["tblob"], cross["jcfg"], cross["qparams"],
                          cross["jqc"], JEngineConfig(**ENGINE),
                          clock=_clock)
    te = Engine.restore(cross["tblob"], cross["cfg"], cross["tparams"],
                        QuantConfig(impl="ref"), EngineConfig(**ENGINE),
                        device="cpu", clock=_clock)
    assert [r.request_id for r in je2.sched.running] == \
        [r.request_id for r in te.sched.running]
    assert np.array_equal(np.asarray(je2.cache.k_pool),
                          te.cache.k_pool.numpy())
    assert np.array_equal(np.asarray(je2.cache.v_pool),
                          te.cache.v_pool.numpy())
    assert je2.cache.free_pages == te.cache.free_pages


# ------------------------------------- the reference's behaviours, ported

@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config("llama3_8b")
    return cfg, QuantConfig(impl="ref"), LM(cfg).init(seed=0, device="cpu")


def make_engine(setup, faults=None, **kw):
    cfg, qc, params = setup
    return Engine(cfg, params, qc, EngineConfig(**dict(ECFG, **kw)),
                  device="cpu", faults=faults)


def _resume(log, setup, journal=None, **kw):
    cfg, qc, params = setup
    return RecoveryLog.resume(
        log.snapshot_blob, log.journal if journal is None else journal,
        cfg, params, qc, EngineConfig(**ECFG), device="cpu", **kw)


def _prompts(n=2, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 100, int(rng.integers(10, 18))).tolist()
            for _ in range(n)]


def _submit_all(eng, prompts, max_new=8):
    return [eng.submit(p, SamplingParams(max_new_tokens=max_new))
            for p in prompts]


def _reference(setup, prompts, max_new=8):
    eng = make_engine(setup)
    _submit_all(eng, prompts, max_new)
    eng.run()
    return {r.request_id: list(r.generated) for r in eng.sched.finished}


def _tokens(eng):
    return {r.request_id: list(r.generated) for r in eng.sched.finished}


def test_full_snapshot_resumes_bitwise(setup):
    """Stopped mid-decode and restored from ``snapshot(full=True)``: the
    continuation is the uninterrupted run's token for token (nothing
    re-prefills); the abandoned original still completes the same."""
    cfg, qc, params = setup
    prompts = _prompts()
    ref = _reference(setup, prompts)
    eng = make_engine(setup)
    _submit_all(eng, prompts)
    for _ in range(4):
        eng.step()
    blob = eng.snapshot(full=True)
    mid = [len(r.generated) for r in eng.sched.running]
    assert any(n > 0 for n in mid) and any(n < 8 for n in mid)
    eng2 = Engine.restore(blob, cfg, params, qc, EngineConfig(**ECFG),
                          device="cpu")
    assert eng2.steps == eng.steps
    eng2.run()
    assert _tokens(eng2) == ref
    assert eng2.cache.pages_free == ECFG["num_pages"]
    eng.run()
    assert _tokens(eng) == ref


def test_full_snapshot_preserves_split_and_cursors(setup):
    """The exact waiting/running split, slots, prefill cursors, free-slot
    order, block tables and pool bytes come back."""
    cfg, qc, params = setup
    eng = make_engine(setup, max_batch=1)
    _submit_all(eng, _prompts(n=3, seed=9), max_new=4)
    for _ in range(2):
        eng.step()
    assert len(eng.sched.running) == 1 and len(eng.sched.waiting) == 2
    eng2 = Engine.restore(eng.snapshot(full=True), cfg, params, qc,
                          EngineConfig(**dict(ECFG, max_batch=1)),
                          device="cpu")
    for attr in ("running", "waiting"):
        assert [r.request_id for r in getattr(eng2.sched, attr)] == \
            [r.request_id for r in getattr(eng.sched, attr)]
    r, r2 = eng.sched.running[0], eng2.sched.running[0]
    assert (r2.seq_slot, r2.prefill_pos, r2.state, r2.emitted) == \
        (r.seq_slot, r.prefill_pos, r.state, r.emitted)
    assert eng2.sched._free_slots == eng.sched._free_slots
    assert eng2.sched._plan_cursor == eng.sched._plan_cursor
    assert np.array_equal(eng2.cache.block_table, eng.cache.block_table)
    assert eng2.cache.free_pages == eng.cache.free_pages
    assert torch.equal(eng2.cache.k_pool, eng.cache.k_pool)
    assert torch.equal(eng2.cache.v_pool, eng.cache.v_pool)


def test_restore_rejects_mismatched_pool_shape(setup):
    cfg, qc, params = setup
    blob = make_engine(setup).snapshot(full=True)
    with pytest.raises(ValueError, match="pool shape"):
        Engine.restore(blob, cfg, params, qc,
                       EngineConfig(**dict(ECFG, num_pages=32)),
                       device="cpu")


def test_legacy_snapshot_demotes_running_work(setup):
    """The legacy blob re-queues running work with its generated text
    folded into the prompt, and the restored engine finishes it."""
    cfg, qc, params = setup
    eng = make_engine(setup)
    _submit_all(eng, _prompts(seed=11), max_new=6)
    for _ in range(3):
        eng.step()
    done = {r.request_id: len(r.generated) for r in eng.sched.running}
    eng2 = Engine.restore(eng.snapshot(), cfg, params, qc,
                          EngineConfig(**ECFG), device="cpu")
    assert not eng2.sched.running and len(eng2.sched.waiting) == 2
    assert all(r.uid >= 0 for r in eng2.sched.waiting)
    eng2.run()
    for r in eng2.sched.finished:
        assert len(r.generated) == 6 - done[r.request_id]


def test_recovery_log_exactly_once_across_crash(setup):
    """A crash two steps past a checkpoint: the resumed log re-runs the
    gap, verifies it against the journal and suppresses it; the deliveries
    before and after reassemble the uninterrupted run, one terminal
    each, and compaction keeps the journal to one interval."""
    prompts = _prompts(seed=13)
    ref = _reference(setup, prompts)
    eng = make_engine(setup)
    log = RecoveryLog(eng, snapshot_every=4)
    _submit_all(eng, prompts)
    delivered = []
    for _ in range(6):
        delivered.extend(log.step())
    assert log.journal
    log2 = _resume(log, setup, snapshot_every=4)
    delivered2 = log2.run()
    assert log2.replayed > 0
    keys = [(ev.request_id, ev.token, ev.num_generated)
            for ev in delivered + delivered2 if ev.token is not None]
    assert len(keys) == len(set(keys))
    for rid, toks in ref.items():
        evs = [ev for ev in delivered + delivered2 if ev.request_id == rid]
        assert [ev.token for ev in evs if ev.token is not None] == toks
        terms = [ev for ev in evs if ev.finished]
        assert len(terms) == 1 and terms[0].state.value == "finished"
    assert log2.compacted_total > 0
    assert len(log2.journal) < log2.journaled_total


def test_replay_mismatch_is_detected(setup):
    eng = make_engine(setup)
    log = RecoveryLog(eng, snapshot_every=4)
    _submit_all(eng, _prompts(seed=17))
    for _ in range(6):
        log.step()
    tampered = [dict(e) for e in log.journal]
    gap = [e for e in tampered if e["ord"] != -1][-1]
    gap["token"] += 1
    log2 = _resume(log, setup, journal=tampered, snapshot_every=4)
    with pytest.raises(ReplayMismatch):
        log2.run()


def test_dir_backed_recovery_survives_reload(setup, tmp_path):
    cfg, qc, params = setup
    d = str(tmp_path / "rlog")
    prompts = _prompts(seed=21)
    ref = _reference(setup, prompts)
    eng = make_engine(setup)
    log = RecoveryLog(eng, snapshot_every=3, dir=d)
    _submit_all(eng, prompts)
    for _ in range(5):
        log.step()
    del eng, log                         # the "kill"
    log2 = RecoveryLog.open_dir(d, cfg, params, qc, EngineConfig(**ECFG),
                                snapshot_every=3, device="cpu")
    log2.run()
    assert _tokens(log2.engine) == ref
    assert all(r.state == RequestState.FINISHED
               for r in log2.engine.sched.finished)
    with open(tmp_path / "rlog" / "journal.jsonl") as f:
        on_disk = [json.loads(line) for line in f if line.strip()]
    assert on_disk == log2.journal
    assert len(on_disk) < log2.journaled_total


def test_journal_keys_survive_request_id_reuse(setup):
    """After ``release()`` a recycled request id journals under a fresh
    uid: its tokens are delivered, not swallowed as replays."""
    eng = make_engine(setup)
    log = RecoveryLog(eng, snapshot_every=100)
    p1, p2 = _prompts(seed=29)
    h1 = eng.submit(p1, SamplingParams(max_new_tokens=4), request_id=7)
    evs = []
    while not eng.result(h1).state.terminal:
        evs.extend(log.step())
    assert len([e for e in evs if e.token is not None]) == 4
    assert eng.release(h1)
    eng.submit(p2, SamplingParams(max_new_tokens=4), request_id=7)
    evs2 = log.run()
    assert len([e for e in evs2 if e.request_id == 7
                and e.token is not None]) == 4
    assert log.replayed == 0
    assert len({e["uid"] for e in log.journal if e["rid"] == 7}) == 2


def test_journal_compacts_at_checkpoint(setup, tmp_path):
    d = str(tmp_path / "rlog")
    eng = make_engine(setup)
    log = RecoveryLog(eng, snapshot_every=2, dir=d)
    _submit_all(eng, _prompts(seed=33), max_new=10)
    sizes = []
    while eng.sched.has_work:
        log.step()
        sizes.append(len(log.journal))
    assert log.compacted_total > 0
    assert log.journaled_total == log.compacted_total + len(log.journal)
    assert min(sizes) == 0 and max(sizes) < log.journaled_total
    with open(tmp_path / "rlog" / "journal.jsonl") as f:
        assert [json.loads(line) for line in f if line.strip()] == \
            log.journal


def test_torn_snapshot_write_keeps_last_good(setup, tmp_path):
    """``snapshot_write`` tears the step-4 checkpoint's temp file: the last
    good snapshot.json (step 2) survives and resumes to the same tokens."""
    cfg, qc, params = setup
    d = str(tmp_path / "rlog")
    prompts = _prompts(seed=37)
    ref = _reference(setup, prompts)
    eng = make_engine(setup,
                      faults=FaultInjector([Fault("snapshot_write", nth=3)]))
    log = RecoveryLog(eng, snapshot_every=2, dir=d)
    _submit_all(eng, prompts)
    with pytest.raises(InjectedFault):
        while eng.sched.has_work:
            log.step()
    assert eng.steps == 4
    assert (tmp_path / "rlog" / "snapshot.json.tmp").exists()
    with open(tmp_path / "rlog" / "snapshot.json") as f:
        assert json.loads(f.read())["steps"] == 2
    log2 = RecoveryLog.open_dir(d, cfg, params, qc, EngineConfig(**ECFG),
                                snapshot_every=2, device="cpu")
    assert log2.engine.steps == 2
    log2.run()
    assert _tokens(log2.engine) == ref
    assert log2.engine.cache.pages_free == ECFG["num_pages"]


def test_recovery_log_validates_snapshot_every():
    with pytest.raises(ValueError, match="snapshot_every"):
        RecoveryLog.__new__(RecoveryLog).__init__(None, snapshot_every=0)


def test_recovery_under_failure_outcome_is_stable(setup):
    """A request failed before the crash stays failed after the resume,
    and its delivered terminal is not delivered again."""
    eng = make_engine(setup, faults=FaultInjector(
        [Fault("forward", step=3, action="nan", row=0)]))
    log = RecoveryLog(eng, snapshot_every=2)
    _submit_all(eng, _prompts(seed=25), max_new=6)
    delivered = []
    for _ in range(5):
        delivered.extend(log.step())
    failed = [rid for rid, r in eng._by_id.items()
              if r.state == RequestState.FAILED]
    assert failed
    log2 = _resume(log, setup, snapshot_every=2)
    delivered2 = log2.run()
    for rid in failed:
        assert log2.engine._by_id[rid].state == RequestState.FAILED
        if any(e.request_id == rid and e.finished for e in delivered):
            assert not any(ev.request_id == rid and ev.finished
                           for ev in delivered2)
    assert log2.engine.cache.pages_free == ECFG["num_pages"]


def test_speculating_run_resumes_bitwise(setup):
    """Drafts and their ``truncate_seq`` rollbacks pass through the
    snapshots: a greedy run with 3 drafts a row, crashed two steps past
    a checkpoint, resumes without a replay mismatch to the same tokens."""
    # the smoke model's greedy output cycles on this prompt, so prompt
    # lookup drafts and some drafts are accepted
    prompts = [[188] * 8, [188] * 12]
    sp = SamplingParams(max_new_tokens=12, speculation=3)
    eng = make_engine(setup)
    for p in prompts:
        eng.submit(p, sp)
    eng.run()
    ref = _tokens(eng)
    assert eng.spec_accepted_tokens > 0 and eng.spec_rollback_tokens > 0
    eng = make_engine(setup)
    log = RecoveryLog(eng, snapshot_every=2)
    for p in prompts:
        eng.submit(p, sp)
    while not eng.spec_draft_tokens:     # up to the first verify step
        log.step()
    if eng.steps % 2 == 0:               # then past a checkpoint
        log.step()
    log2 = _resume(log, setup, snapshot_every=2)
    log2.run()
    assert log2.replayed > 0
    assert _tokens(log2.engine) == ref
