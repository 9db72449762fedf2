"""The port's split-step baselines (``unified_step=False``: a prefill
forward, then a separate decode forward) against the JAX engine, on the
same converted weights and requests (CPU, plain kernel versions).

The model and the pinned workload are those of ``test_torch_engine.py``:
2 layers, d_model 1024, every prompt prefilled in step 1, then the rows
decode over int4 pages. The reference's split forwards run eagerly, as
the port's do, so the first forward's logits are expected to agree
exactly (observed: bit for bit). They are held to 2e-2·max|logit|, the
tolerance of ``test_torch_engine.py``: int4 act-quant can turn a last-bit
difference of a bf16 projection into a whole quantization step. Greedy
tokens are compared by agreement ratio, and the schedule counters must
be equal. ``test_torch_split_step_whole.py`` covers the whole-prompt and
gather baselines the same way.
"""
import numpy as np
import pytest

from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro_torch.models.lm import QuantConfig
from repro_torch.serving.engine import Engine, EngineConfig
from test_torch_engine import (ENGINE, MAX_NEW, PROMPT_LENS,  # noqa: F401
                               _prompts, model)

COUNTERS = ("forward_calls", "interleaved_steps", "attn_forwards",
            "attn_work_items", "attn_grid_items", "attn_dense_grid_items",
            "peak_prefill_fp_tokens")
CONFIGS = {
    "split_work_queue": dict(unified_step=False),
    "split_dense": dict(unified_step=False, attention_schedule="dense"),
    # pages of 128 keys: more than a 64-key tile per work-queue decode item
    "split_work_queue_ps128": dict(unified_step=False, page_size=128),
}


def _capture_first(eng, first: list):
    """Record the logits of the engine's first forward: the unified step's
    ``_guarded_forward`` result, or the logits the split forwards hand to
    ``_sample_batch``."""
    for name in ("_guarded_forward", "_sample_batch"):
        inner = getattr(eng, name)

        def wrapped(*a, inner=inner, name=name, **k):
            out = inner(*a, **k)
            if not first:
                logits = (out[0] if name == "_guarded_forward"
                          and isinstance(out, tuple) else out)
                first.append(np.array(a[0] if name == "_sample_batch"
                                      else logits))
            return out

        setattr(eng, name, wrapped)


def serve_pair(model, kw: dict, lens=PROMPT_LENS, max_new=MAX_NEW) -> dict:
    """Serve the same requests on the JAX engine (``impl="ref"``, eager)
    and on the port (plain versions, CPU) under ``EngineConfig`` of
    ``ENGINE`` updated by ``kw`` → {"j": ..., "t": ...}, each with the
    tokens by request, the first forward's logits, the counters and the
    engine."""
    jcfg, cfg, jqc, qparams, tparams = model
    kw = {**ENGINE, **kw}
    je = JEngine(jcfg, qparams, jqc, JEngineConfig(**kw))
    je._fwd = je._unified_forward       # eager: see test_torch_engine.py
    te = Engine(cfg, tparams, QuantConfig(impl="ref"), EngineConfig(**kw),
                device="cpu")
    out = {}
    for key, eng in (("j", je), ("t", te)):
        first: list = []
        _capture_first(eng, first)
        for i, p in enumerate(_prompts(lens)):
            eng.add_request(i, p, max_new)
        done = eng.run()
        out[key] = dict(tokens={r.request_id: list(r.generated) for r in done},
                        first=first[0], engine=eng,
                        counters={k: getattr(eng, k) for k in COUNTERS})
    return out


def check_first_logits(pair):
    lj, lt = pair["j"]["first"], pair["t"]["first"]
    assert lt.shape == lj.shape
    err = np.abs(lt - lj).max()
    assert err <= 2e-2 * np.abs(lj).max(), err


def check_greedy_agreement(pair, n_req: int, max_new: int):
    jt, tt = pair["j"]["tokens"], pair["t"]["tokens"]
    assert sorted(tt) == sorted(jt) == list(range(n_req))
    assert all(len(v) == max_new for v in tt.values())
    total = sum(len(v) for v in jt.values())
    agree = sum(a == b for i in jt for a, b in zip(jt[i], tt[i])) / total
    assert agree >= 0.9, (agree, jt, tt)


def check_counters(pair):
    assert pair["t"]["counters"] == pair["j"]["counters"]
    c = pair["t"]["engine"].counters()
    assert c["failed_count"] == c["internal_errors"] == 0, c["last_error"]


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request, model):
    return serve_pair(model, CONFIGS[request.param])


def test_first_forward_logits_match(pair):
    check_first_logits(pair)


def test_greedy_agreement(pair):
    check_greedy_agreement(pair, len(PROMPT_LENS), MAX_NEW)


def test_schedule_counters_match(pair):
    """The split step runs two forwards in step 1 (prefill, then decode of
    the rows it finished: an interleaved step) and one per later step;
    the attention counters follow the decode descriptors or tables."""
    check_counters(pair)
    c = pair["t"]["counters"]
    assert c["interleaved_steps"] >= 1
    assert c["forward_calls"] == pair["t"]["engine"].steps + 1
    assert c["attn_dense_grid_items"] >= c["attn_work_items"] > 0


def test_split_dense_and_work_queue_same_tokens(model):
    """Within the port, the split step's decode forward honours the
    schedule knob token for token (reference
    ``tests/serving/test_work_queue.py::test_wq_matches_dense_split_step_decode``)."""
    cfg, tparams = model[1], model[4]
    prompts = _prompts((24, 7, 13))
    toks = {}
    for sched in ("dense", "work_queue"):
        eng = Engine(cfg, tparams, QuantConfig(impl="ref"),
                     EngineConfig(**dict(ENGINE, unified_step=False,
                                         attention_schedule=sched)),
                     device="cpu")
        for i, p in enumerate(prompts):
            eng.add_request(i, p, 8)
        toks[sched] = {r.request_id: r.generated for r in eng.run()}
    assert toks["dense"] == toks["work_queue"]
