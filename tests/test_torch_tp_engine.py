"""Tensor-parallel serving on the CPU: the port's engine at M = 2 under
gloo (two spawned ranks) against the port's single-device engine, on the
reference's configuration and workloads (``tests/serving/
test_sharded_engine.py``: the llama3 smoke model at head_dim 64, so q_dim
and d_ff are two 128-channel blocks each; ``int4_fraction=1.0``;
``impl="ref"``; the reference's own weights, converted).

The single-device engine is the one the other port tests hold to the
reference's un-jitted forward; the reference's jitted sharded engine is
not used (jit and eager disagree on the W4A4 path, ROADMAP caveats). The
ranks are spawned once for the file and run every workload with the
sanitizers on, which also compare the ranks' tokens and scheduler state
after every step; the row seam (``_row_linear``) runs on the reference's
numpy-made K-slices at both ``int4_fraction`` values, with and without a
bias, and must be bit for bit the rank-order sum of the reference's
``_dispatch_qlinear(..., out_dtype=f32)`` partials.

At head_dim 64 a shard of wo and w_down is one 128-channel block, so the
rank-order sum adds the blocks in one device's order. The grouping
workload (``GROUPED``: head_dim 128 and d_ff 512, two blocks a shard, the
port's own seeded weights) holds every forward's logits under M = 2 bit
for bit to one device whose row-parallel projections are K-slices of the
whole weights summed in rank order (``_torch_tp_ranks.serial_seams``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import _torch_tp_ranks as R
from repro.configs.base import get_smoke_config as jget_smoke_config
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import spawn
from repro_torch.models.lm import QuantConfig
from test_torch_tp import reference_model, seam_cases

TP = 2
JCFG = dataclasses.replace(jget_smoke_config("llama3_8b"), head_dim=64)
CFG = dataclasses.replace(get_smoke_config("llama3_8b"), head_dim=64)
QC = QuantConfig(int4_fraction=1.0, impl="ref")
GROUPED = dataclasses.replace(get_smoke_config("llama3_8b"), head_dim=128,
                              d_ff=512)
WORKLOADS = ("mixed", "decode_only", "prefix_cache", "dense", "spec0",
             "spec4", "fault", "snapshot", "restored_own")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny shapes: PyTorch's intra-op threads would only contend with
    the suite's other workers (the ranks are pinned too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return reference_model(JCFG, CFG, QC)


@pytest.fixture(scope="module")
def one(model):
    return R.run_workloads(model, None)


@pytest.fixture(scope="module")
def seams():
    return seam_cases(TP)


@pytest.fixture(scope="module")
def grouped():
    return R.grouping_model(GROUPED)


@pytest.fixture(scope="module")
def serial(grouped):
    with R.serial_seams(TP):
        return R.run_grouping(grouped, None)


@pytest.fixture(scope="module")
def ranks(model, one, seams, grouped):
    return spawn(R.rank_main, TP, (model, one["blob"],
                                   [c for c, _ in seams], R.FULL, grouped),
                 threads=1, timeout_s=300.0)


def test_ranks_import_no_reference(ranks):
    assert [r["foreign"] for r in ranks] == [[]] * TP


@pytest.mark.parametrize("name", WORKLOADS)
def test_tokens_equal_one_device(ranks, one, name):
    """The same greedy tokens as one device, on every rank, a sanitizer
    pass (ranks-agree included) every step, one forward a step."""
    want = one[name]
    for r in ranks:
        got = r[name]
        assert got["tokens"] == want["tokens"]
        assert got["states"] == want["states"]
        assert got["internal_errors"] == 0
        assert got["steps"] == want["steps"]
        # a restored engine's steps count from the blob's, its sanitizer
        # passes from the restore
        restored = R.SNAPSHOT_AT if name == "restored_own" else 0
        assert got["sanitize_checks"] == got["steps"] - restored
        assert got["forward_calls"] == want["forward_calls"]


@pytest.mark.parametrize("name", ("mixed", "decode_only"))
def test_work_items_per_shard(ranks, one, name):
    """Each rank attends its kv heads over the same pages: the reference's
    per-shard split, total // tp each, and the total one device's."""
    total = one[name]["attn_work_items"]
    assert total > 0
    for r in ranks:
        assert r[name]["attn_work_items"] == total
        assert r[name]["per_shard"] == [total // TP] * TP


def test_prefix_cache_hits(ranks, one):
    assert one["prefix_cache"]["prefix_hit_tokens"] > 0
    assert ranks[0]["prefix_cache"]["prefix_hit_tokens"] == \
        one["prefix_cache"]["prefix_hit_tokens"]


def test_speculation_tokens(ranks, one):
    """Drafts change the forwards, not the tokens: with 4 drafts a row the
    TP engine emits speculation-off's tokens (and one device's), in fewer
    steps (19 against 20 here, as on one device; the reference's JAX
    engine takes 20 and 20 on this workload under four forced host
    devices, ROADMAP caveats)."""
    r = ranks[0]
    assert r["spec4"]["tokens"] == r["spec0"]["tokens"] == \
        one["spec0"]["tokens"]
    drafted, accepted, rolled = r["spec4"]["spec"]
    assert drafted > 0 and accepted > 0 and drafted == accepted + rolled
    assert r["spec4"]["steps"] < r["spec0"]["steps"]


def test_fault_isolation(ranks, one):
    """A NaN-logits fault at step 3 fails the same request on every rank
    as on one device; pages go back, the survivors' tokens are equal."""
    want = R.failed_ids(one["fault"])
    assert len(want) == 1
    for r in ranks:
        assert R.failed_ids(r["fault"]) == want
        assert r["fault"]["failed_count"] == 1
        assert r["fault"]["pages_free"] == 64 and r["fault"]["refs_zero"]


def test_snapshot_restores_across_meshes(model, ranks, one):
    """A TP snapshot (the full cache, heads gathered) resumes in a new
    M = 2 engine token for token (``restored_own``), and in one device;
    one device's blob resumes under TP (``restored``)."""
    assert ranks[0]["blob"] == ranks[1]["blob"]
    want = one["snapshot"]["tokens"]
    assert ranks[0]["snapshot"]["tokens"] == want
    for r in ranks:
        assert r["restored_own"]["tokens"] == want
        assert r["restored"]["tokens"] == want
        assert r["restored"]["pages_free"] == 64
    assert R.restore_and_run(model, None, ranks[0]["blob"])["tokens"] == want


def test_row_seam_bit_for_bit(ranks, seams):
    """The seam's bf16 output on every rank is the reference's partials
    summed in rank order, the bias added once, rounded once."""
    for i, (_, want) in enumerate(seams):
        for r in ranks:
            np.testing.assert_array_equal(r["seam"][i], want)


@pytest.mark.parametrize("frac", R.GROUPING_FRACTIONS)
def test_two_blocks_a_shard_is_the_rank_order_sum(ranks, serial, frac):
    """Two blocks a shard of wo and w_down (at 0.5 one INT4 and one INT8
    block a shard, where one device would split 2 + 2): every forward's
    logits on every rank are bit for bit one device's under
    ``serial_seams``, so each shard holds its rows and scales in their
    place and the seams sum them in rank order."""
    assert GROUPED.q_dim // TP // 128 == GROUPED.d_ff // TP // 128 == 2
    tokens, logits = serial[frac]
    assert len(logits) > 1
    for r in ranks:
        got_tokens, got = r["grouping"][frac]
        assert got_tokens == tokens
        assert len(got) == len(logits)
        for a, b in zip(got, logits):
            np.testing.assert_array_equal(a, b)
