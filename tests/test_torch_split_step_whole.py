"""The port's whole-prompt baselines against the JAX engine (CPU, plain
kernel versions): ``prefill_mode="whole"`` (one fp forward per prompt,
then the split decode forward) with ``decode_attention="gather"`` (the
decode batch's pages gathered contiguously for the KV4 decode kernel,
in bf16 on the ref path as the reference's ops run it) and with paged
work-queue decode.

Harness and tolerances are those of ``test_torch_split_step.py``. The
reference compiles every eager op once per shape, and a whole-prompt
forward has the prompt's length in its shapes, so this workload uses two
prompt lengths and six new tokens to stay quick.
"""
import pytest

from test_torch_engine import model  # noqa: F401
from test_torch_split_step import (check_counters, check_first_logits,
                                   check_greedy_agreement, serve_pair)

LENS, NEW = (20, 9, 20, 9), 6
CONFIGS = {
    "whole_gather": dict(prefill_mode="whole", decode_attention="gather"),
    "split_whole": dict(unified_step=False, prefill_mode="whole"),
}


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request, model):  # noqa: F811
    return serve_pair(model, CONFIGS[request.param], LENS, NEW)


def test_first_forward_logits_match(pair):
    """The first forward is the first request's whole-prompt prefill: one
    row of logits."""
    assert pair["t"]["first"].shape == (1, 512)
    check_first_logits(pair)


def test_greedy_agreement(pair):
    check_greedy_agreement(pair, len(LENS), NEW)


def test_schedule_counters_match(pair):
    """One prefill forward per prompt, no prefix caching under "whole";
    the gather decode never counts as paged attention."""
    check_counters(pair)
    eng = pair["t"]["engine"]
    c = pair["t"]["counters"]
    assert c["peak_prefill_fp_tokens"] == max(LENS)
    assert eng.prefix_hit_tokens == 0 and not eng.ecfg.prefix_caching
    if eng.ecfg.decode_attention == "gather":
        assert c["attn_forwards"] == c["attn_grid_items"] == 0
    else:
        assert c["attn_forwards"] > 0
