"""Replica groups over per-replica tensor-parallel meshes on the CPU: two
replicas of two gloo ranks each (four ranks, spawned once for the file)
against the port's one-device ``ReplicaGroup``, which
``test_torch_replication.py`` holds to the reference.

The model is the TP test model (the llama3 smoke config at head_dim 64,
``int4_fraction=1.0``, ``impl="ref"``: a shard of wo and w_down is one
128-channel block, so a mesh's tokens are one device's). Every rank runs
the group controller; replica i's engine lives on ranks 2i and 2i + 1
(``launch.mesh.make_replica_meshes``). The kill sweep
(``_torch_durable_ranks.REPLICA_CASES``: replica 0 killed mid-prefill,
mid-decode and between a checkpoint and the crash, under both failover
policies, and no kill) must give every rank the one-device group's
streams, terminals, owners, counters and deaths; the launcher's
``--replicas 2 --mesh 1x2`` its one-device summary.
"""
import dataclasses
import re

import pytest
import torch

import _torch_durable_ranks as D
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as SERVE
from repro_torch.launch.mesh import spawn
from repro_torch.models.lm import LM, QuantConfig

REPLICAS, M = 2, 2
CFG = dataclasses.replace(get_smoke_config("llama3_8b"), head_dim=64)
QC = QuantConfig(int4_fraction=1.0, impl="ref")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    lm = LM(CFG)
    params = lm.init(seed=7, device="cpu")
    return CFG, params, lm.axes(params), QC


@pytest.fixture(scope="module")
def one(model):
    return D.run_replica_cases(model, None)


@pytest.fixture(scope="module")
def ranks(model):
    return spawn(D.replica_rank, REPLICAS * M, (model, REPLICAS, M),
                 threads=1, timeout_s=300.0)


def test_meshes_carve_the_world(ranks):
    """Replica i on ranks [2i, 2i + 2); no rank imports the reference."""
    for rank, r in enumerate(ranks):
        assert r["foreign_modules"] == []
        assert [tuple(ranks_) for ranks_, _ in r["mesh"]] == [(0, 1), (2, 3)]
        assert [mr for _, mr in r["mesh"]] == [
            rank % M if rank // M == i else -1 for i in range(REPLICAS)]


@pytest.mark.parametrize("failover,kill", D.REPLICA_CASES,
                         ids=[f"{f}-{k}" for f, k in D.REPLICA_CASES])
def test_kill_sweep_streams_equal_one_device(ranks, one, failover, kill):
    """Every rank's controller delivers the one-device group's streams and
    terminals, routes and moves requests alike, and counts the same
    failovers, migrations, replica steps and deaths; the live replicas'
    pages are back and nothing raised inside an engine."""
    want = one[(failover, kill)]
    assert all(len(t) == D.REPLICA_MAX_NEW for t in want["tokens"].values())
    assert set(want["terminals"].values()) == {"finished"}
    assert want["counters"]["failovers"] == (1 if kill else 0)
    for r in ranks:
        got = r[(failover, kill)]
        for key in ("tokens", "terminals", "owner_before", "owner",
                    "counters", "deaths"):
            assert got[key] == want[key], key
        assert got["stats"] == want["stats"]
        assert all(n == D.REPLICA_ENGINE["num_pages"]
                   for n in got["pages_free"].values())


def test_migrate_moves_in_flight_requests(ranks, one):
    """Replica 0 killed mid-decode under ``migrate``: its in-flight
    requests move to replica 1, as on one device."""
    for r in ranks + [one]:
        got = r[("migrate", 6)]
        assert got["counters"]["migrated_requests"] > 0
        assert 0 in got["owner_before"].values()
        assert set(got["owner"].values()) == {1}
        assert got["counters"]["health"] == {0: "dead:crash", 1: "live"}


def _group_lines(text: str) -> list:
    return [re.sub(r" in [\d.]+s → [\d.]+ tok/s", "", ln)
            for ln in text.splitlines()
            if ln.startswith(("[done]", "[group]", "[robust]", "[faults]",
                              "[death]", "[states]"))]


def test_cli_group_counts_equal_one_device(capfd):
    """``--replicas 2 --mesh 1x2`` (four gloo ranks, rank 0 printing)
    prints the one-device group's ``[done]``, ``[group]``, ``[robust]``,
    ``[faults]``, ``[death]`` and ``[states]`` lines after the
    reference's ``[mesh]`` line."""
    argv = ["--arch", "llama3_8b", "--smoke", "--device", "cpu",
            "--head-dim", "64", "--int4-fraction", "1.0", "--impl", "ref",
            "--max-new", "6", "--page-size", "8", "--requests", "4",
            "--prompt-len", "32", "--replicas", "2", "--failover",
            "migrate", "--kill-replica-at", "4", "--snapshot-every", "2"]
    SERVE.main(argv)
    single = capfd.readouterr().out
    counters = SERVE.main(argv + ["--mesh", "1x2"])
    meshed = capfd.readouterr().out
    assert "[mesh] 2 replica(s) x (data=1, model=2) over 4 cpu rank(s)" \
        in meshed
    assert meshed.count("[group]") == 1          # rank 0 alone prints
    want = _group_lines(single)
    assert len(want) == 6 and "failovers=1 migrated=" in want[1]
    assert _group_lines(meshed) == want
    assert len(counters) == 4 and all(c == counters[0] for c in counters)
    assert counters[0]["failovers"] == 1
