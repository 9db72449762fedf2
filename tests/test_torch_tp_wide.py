"""Tensor-parallel serving at M = 4 under gloo (four spawned ranks) on a
widened copy of the reference's TP test configuration: the llama3 smoke
model at head_dim 64 with 8/4 heads and d_ff 512, so q_dim and d_ff split
into whole 128-channel blocks four ways and every rank holds one kv head
(``int4_fraction=1.0``, ``impl="ref"``, the reference's weights). The
mixed, decode-only and dense-schedule workloads and a full snapshot
(restored into a new M = 4 engine and into one device) must give the
port's single-device tokens on every rank; the row seam at M = 4 must be
the rank-order sum bit for bit (``test_torch_tp.seam_cases``). On
``GROUPED`` (head_dim 128, 8/4 heads, d_ff 1024: two 128-channel blocks
a shard of wo and w_down) every forward's logits must be one device's
under ``_torch_tp_ranks.serial_seams`` bit for bit.
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

TP = 4
WIDE = dict(head_dim=64, num_heads=8, num_kv_heads=4, d_ff=512)
JCFG = dataclasses.replace(jget_smoke_config("llama3_8b"), **WIDE)
CFG = dataclasses.replace(get_smoke_config("llama3_8b"), **WIDE)
QC = QuantConfig(int4_fraction=1.0, impl="ref")
GROUPED = dataclasses.replace(get_smoke_config("llama3_8b"), head_dim=128,
                              num_heads=8, num_kv_heads=4, d_ff=1024)
NAMES = ("mixed", "decode_only", "dense", "snapshot")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return reference_model(JCFG, CFG, QC)


@pytest.fixture(scope="module")
def one(model):
    return R.run_workloads(model, None, names=NAMES)


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
    return spawn(R.rank_main, TP, (model, one["blob"], [c for c, _ in seams],
                                   NAMES, grouped), threads=1,
                 timeout_s=300.0)


@pytest.mark.parametrize("name", NAMES + ("restored_own", "restored"))
def test_tokens_equal_one_device(ranks, one, name):
    want = one["snapshot" if name.startswith("restored") else name]
    for r in ranks:
        assert r[name]["tokens"] == want["tokens"]
        assert r[name]["internal_errors"] == 0
    assert [r["foreign"] for r in ranks] == [[]] * TP


def test_work_items_per_shard(ranks, one):
    total = one["mixed"]["attn_work_items"]
    for r in ranks:
        assert r["mixed"]["per_shard"] == [total // TP] * TP


def test_blob_restores_into_one_device(model, ranks, one):
    assert all(r["blob"] == ranks[0]["blob"] for r in ranks)
    assert R.restore_and_run(model, None, ranks[0]["blob"])["tokens"] == \
        one["snapshot"]["tokens"]


def test_row_seam_bit_for_bit(ranks, seams):
    for i, (_, want) in enumerate(seams):
        for r in ranks:
            np.testing.assert_array_equal(r["seam"][i], want)


@pytest.mark.parametrize("frac", R.GROUPING_FRACTIONS)
def test_two_blocks_a_shard_is_the_rank_order_sum(ranks, serial, frac):
    assert GROUPED.q_dim // TP // 128 == GROUPED.d_ff // TP // 128 == 2
    tokens, logits = serial[frac]
    for r in ranks:
        got_tokens, got = r["grouping"][frac]
        assert got_tokens == tokens and len(got) == len(logits) > 1
        for a, b in zip(got, logits):
            np.testing.assert_array_equal(a, b)
