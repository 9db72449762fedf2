"""Replica groups with failover in the port (``serving/replication.py``), on
the CPU.

The reference's behaviours (``tests/serving/test_replication.py``)
against the port's engines on the smoke model: for a kill mid-prefill,
mid-decode and between a checkpoint and the crash, under both policies,
one terminal each, the survivors' pools back to baseline and no internal
error (the sanitizers run every step); under ``standby`` every delivered
stream equals the group run without the crash. Under ``migrate`` a moved
request re-prefills its prompt and delivered tokens on a survivor, whose
fp in-flight chunk is not the int4 pages its decode read (the
reference's test gets equal streams from its weight-only W4A16 model;
the port's W4A4 act-quant turns that difference into other tokens), so
there the tokens delivered before the death equal the run without the
crash, each stream has its full budget, and the requests that never
moved equal it entirely; migration moves work; a missed
heartbeat kills a replica; least-loaded routing; backpressure and
shedding under halved capacity; ``replica_lost`` with no survivor; and
the arguments' checks. Every replica shares the one parameter dict.
The launcher's replica path is held to the reference launcher's: the
same flags give the same ``[done]``, ``[group]`` and ``[death]`` counts.
"""
import contextlib
import io
import re
import sys

import numpy as np
import pytest
import torch

from repro.launch import serve as JSERVE
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as SERVE
from repro_torch.models.lm import LM, QuantConfig
from repro_torch.serving.api import SamplingParams
from repro_torch.serving.engine import EngineConfig
from repro_torch.serving.faults import Fault, FaultInjector
from repro_torch.serving.replication import ReplicaGroup

# a small chunk, so prefill spans several steps and a step-2 kill lands
# mid-prefill; the sanitizers run in every engine, resumed ones included
ECFG = dict(max_batch=4, num_pages=64, page_size=8, max_pages_per_seq=16,
            prefill_chunk_tokens=8, kv_range=4.0, sanitize=True)
SNAP = 4                        # checkpoint cadence: gap kills at 6/7
MAX_NEW = 6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config("llama3_8b")
    return cfg, QuantConfig(impl="ref"), LM(cfg).init(seed=0, device="cpu")


def _prompts(n=3, seed=41):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 100, int(rng.integers(12, 18))).tolist()
            for _ in range(n)]


def make_group(setup, **kw):
    cfg, qc, params = setup
    ecfg = EngineConfig(**dict(ECFG, **kw.pop("ecfg", {})))
    kw.setdefault("replicas", 2)
    kw.setdefault("snapshot_every", SNAP)
    return ReplicaGroup(cfg, params, qc, ecfg, device="cpu", **kw)


def _record_deaths(group) -> dict:
    """→ a dict that receives, at the failover, each request's count of
    tokens delivered before the death and its owner."""
    at_death = {}
    on_death = group._on_death

    def wrapped(rep, why):
        at_death["delivered"] = {rid: len(t)
                                 for rid, t in group.delivered.items()}
        at_death["owner"] = dict(group.owner)
        on_death(rep, why)

    group._on_death = wrapped
    return at_death


def _check_migrated(group, rids, at_death, reference, dead=0):
    """The migrate policy's streams against the run without the crash:
    the full budget, the tokens delivered before the death equal, and a
    request the dead replica did not own equal entirely."""
    for rid in rids:
        toks, ref = group.tokens_for(rid), reference[rid][0]
        assert len(toks) == len(ref)
        n = at_death["delivered"].get(rid, 0)
        assert toks[:n] == ref[:n]
        if at_death["owner"][rid] != dead:
            assert toks == ref


def _drive(group, prompts, max_new=MAX_NEW):
    rids = [group.submit(p, SamplingParams(max_new_tokens=max_new))
            for p in prompts]
    group.run()
    return rids


@pytest.fixture(scope="module")
def reference(setup):
    """The group run without a crash, which every case is compared with
    (routing decides prefill chunking, so not a single engine's run)."""
    group = make_group(setup)
    rids = _drive(group, _prompts())
    assert group.failovers == 0 and group.internal_errors == 0
    return {rid: (group.tokens_for(rid), group.terminal_for(rid))
            for rid in rids}


@pytest.mark.parametrize("failover", ["standby", "migrate"])
@pytest.mark.parametrize("kill_step,phase",
                         [(2, "mid_prefill"), (6, "mid_decode"),
                          (7, "mid_snapshot_gap")])
def test_kill_sweep_streams_identical(setup, reference, failover,
                                      kill_step, phase):
    faults = [FaultInjector([Fault("crash", step=kill_step)]),
              FaultInjector()]
    group = make_group(setup, failover=failover, faults=faults)
    at_death = _record_deaths(group)
    rids = _drive(group, _prompts())
    assert group.failovers == 1
    assert group.deaths and group.deaths[0][1] == "crash"
    assert group.internal_errors == 0
    if failover == "standby":
        for rid in rids:
            assert group.tokens_for(rid) == reference[rid][0], phase
    else:
        _check_migrated(group, rids, at_death, reference)
    for rid in rids:
        got = group.terminal_for(rid)
        assert got is not None and got.state == reference[rid][1].state
    assert len(group.terminals) == len(rids)
    for rep in group.replicas:
        if rep.alive:
            assert rep.engine.cache.pages_free == ECFG["num_pages"]
            assert rep.engine.internal_errors == 0
            assert rep.engine.sanitize_checks > 0
    if failover == "standby":
        assert group.health[0] == "promoted"
        assert all(r.alive for r in group.replicas)
    else:
        assert group.health[0] == "dead:crash"


def test_migrate_moves_in_flight_requests(setup, reference):
    faults = [FaultInjector([Fault("crash", step=6)]), FaultInjector()]
    group = make_group(setup, failover="migrate", faults=faults)
    at_death = _record_deaths(group)
    rids = _drive(group, _prompts())
    assert group.migrated_requests > 0
    assert all(group.owner[rid] == 1 for rid in rids)
    _check_migrated(group, rids, at_death, reference)


def test_replicas_share_the_weights(setup):
    """One parameter dict, no copy per replica: every engine holds the
    same tensors; each has its own pools, scheduler and log."""
    group = make_group(setup, replicas=3)
    e0, e1, e2 = (r.engine for r in group.replicas)
    assert e0.params is e1.params is e2.params is setup[2]
    assert e0.cache.k_pool.data_ptr() != e1.cache.k_pool.data_ptr()
    assert e0.sched is not e1.sched
    assert group.replicas[0].log is not group.replicas[1].log


def test_heartbeat_deadline_kills_slow_replica(setup, reference):
    t = {"now": 0.0}
    group = make_group(setup, failover="migrate", heartbeat_s=1.0,
                       clock=lambda: t["now"])
    rep = group.replicas[0]
    orig = rep.log.step

    def slow_step():
        out = orig()
        if rep.engine.steps >= 3:
            t["now"] += 5.0              # blows the 1 s deadline
        return out

    rep.log.step = slow_step
    at_death = _record_deaths(group)
    rids = _drive(group, _prompts())
    assert group.health[0] == "dead:heartbeat"
    assert group.failovers == 1 and group.internal_errors == 0
    _check_migrated(group, rids, at_death, reference)
    for rid in rids:
        assert group.terminal_for(rid) is not None


def test_least_loaded_routing_spreads_requests(setup):
    group = make_group(setup)
    rids = [group.submit(p, SamplingParams(max_new_tokens=2))
            for p in _prompts(n=4, seed=43)]
    assert [group.owner[rid] for rid in rids] == [0, 1, 0, 1]
    group.run()
    assert len(group.terminals) == 4


def test_backpressure_rejects_when_all_replicas_full(setup):
    group = make_group(setup, ecfg=dict(max_batch=1, max_waiting=1))
    rids = [group.submit(p, SamplingParams(max_new_tokens=2))
            for p in _prompts(n=8, seed=47)]
    group.run()
    assert len(group.terminals) == 8
    rejected = [rid for rid in rids
                if group.terminal_for(rid).stop_reason == "queue_full"]
    served = [rid for rid in rids
              if group.terminal_for(rid).state.value == "finished"]
    assert rejected and served
    assert sum(r.engine.rejected_count for r in group.replicas) \
        == len(rejected)


def test_shed_on_halved_capacity(setup):
    faults = [FaultInjector([Fault("crash", step=6)]), FaultInjector()]
    group = make_group(setup, failover="migrate", faults=faults,
                       ecfg=dict(max_batch=2, max_waiting=2))
    rids = [group.submit(p, SamplingParams(max_new_tokens=4))
            for p in _prompts(n=8, seed=53)]
    group.run()
    assert group.failovers == 1
    assert len(group.terminals) == len(rids)
    reasons = {group.terminal_for(rid).stop_reason for rid in rids}
    survivor = group.replicas[1].engine
    assert survivor.rejected_count + survivor.shed_count > 0 \
        or "queue_full" in reasons or "shed" in reasons
    assert survivor.cache.pages_free == ECFG["num_pages"]


def test_replica_lost_without_survivors_fails_terminally(setup):
    faults = [FaultInjector([Fault("crash", step=3)])]
    group = make_group(setup, replicas=1, failover="migrate",
                       faults=faults)
    rids = [group.submit(p, SamplingParams(max_new_tokens=MAX_NEW))
            for p in _prompts(n=2, seed=59)]
    group.run()
    assert not group.has_work
    for rid in rids:
        term = group.terminal_for(rid)
        assert term is not None and term.stop_reason == "replica_lost"
        assert term.state.value == "failed"


def test_group_validates_arguments(setup):
    cfg, qc, params = setup
    ecfg = EngineConfig(**ECFG)
    with pytest.raises(ValueError, match="replicas"):
        ReplicaGroup(cfg, params, qc, ecfg, replicas=0, device="cpu")
    with pytest.raises(ValueError, match="failover"):
        ReplicaGroup(cfg, params, qc, ecfg, failover="bogus", device="cpu")
    with pytest.raises(ValueError, match="one injector per replica"):
        ReplicaGroup(cfg, params, qc, ecfg, replicas=2,
                     faults=[FaultInjector()], device="cpu")


# ------------------------------------------------ the launcher's group path

GROUP_ARGV = ["--arch", "llama3_8b", "--smoke", "--impl", "ref",
              "--requests", "4", "--max-new", "8", "--replicas", "2",
              "--failover", "migrate", "--kill-replica-at", "3",
              "--snapshot-every", "2"]
GROUP_FIELDS = {
    "done": r"\[done\] (\d+) requests, (\d+) tokens .*group_steps=(\d+), "
            r"replica_steps=(\d+)\)",
    "group": r"\[group\] replicas=(\d+) failover=\w+ failovers=(\d+) "
             r"migrated=(\d+) replica_steps=(\d+) dup_suppressed=(\d+) "
             r"internal_errors=(\d+)",
    "death": r"\[death\] replica (\d+) at engine step (\d+)",
}


def test_cli_group_counts_match_reference(capsys, monkeypatch):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        group = SERVE.main(GROUP_ARGV + ["--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["serve"] + GROUP_ARGV)
    JSERVE.main()
    ref = capsys.readouterr().out
    for key, pat in GROUP_FIELDS.items():
        got, want = re.search(pat, out.getvalue()), re.search(pat, ref)
        assert got and want, (key, out.getvalue(), ref)
        assert got.groups() == want.groups(), key
    assert group.failovers == 1 and group.migrated_requests > 0
    assert all(len(group.tokens_for(r)) == 8 for r in range(4))
    assert "r0=dead:crash" in out.getvalue()
