"""The port's serve CLI against the reference's (CPU, plain kernel
versions, the smoke model).

Both launchers get the same flags and draw the same prompts from
``np.random.default_rng(seed)``; greedy decoding has no EOS, so every
request runs to its token budget unless the flags end it. Their weights
differ (each makes its own random weights), so token ids are not
compared; everything the flags decide is: requests, tokens, steps,
forwards, preemptions, prefix-hit and prompt tokens, prefix evictions and
reclaimable bytes, aborted, rejected, shed and timed-out requests. The
schedule is ``mixed`` at ``--int4-fraction 0.5``, where the smoke model's
down projection has one INT4 and one INT8 block.
"""
import contextlib
import io
import re
import sys

import pytest

from repro.launch import serve as JSERVE
from repro_torch.launch import serve as SERVE

COMMON = ["--arch", "llama3_8b", "--smoke", "--int4-fraction", "0.5",
          "--schedule", "mixed", "--impl", "ref", "--max-new", "6",
          "--page-size", "8", "--shared-prefix", "16"]
CASES = {
    # all up front: one rejected at the door, one aborted after its first
    # token, a byte cap on the prefix LRU, budgets that never expire
    "reject_abort_cap": ["--requests", "4", "--prompt-len", "32",
                         "--max-waiting", "3", "--abort-every", "2",
                         "--prefix-cache-max-bytes", "4096",
                         "--deadline-ms", "600000", "--ttft-ms", "600000"],
    # staggered arrivals into a 7-page pool: prefix hits, a preemption
    # whose victim is shed, a rejection, an abort, a pressure eviction
    "shed_under_pressure": ["--requests", "4", "--prompt-len", "16",
                            "--pages", "7", "--max-waiting", "1",
                            "--arrival-every", "1", "--abort-every", "3"],
}
FIELDS = {
    "done": r"\[done\] (\d+) requests, (\d+) tokens .*steps=(\d+), "
            r"forwards=(\d+),.*preemptions=(\d+)\)",
    "cache": r"\[cache\] .*\((\d+)/(\d+) prompt tokens .*evicted=(\d+) "
             r"pages; reclaimable=(\d+)B; aborted=(\d+)",
    "robust": r"\[robust\] failed=(\d+) timed_out=(\d+) shed=(\d+) "
              r"rejected=(\d+) callback_errors=(\d+) internal_errors=(\d+)",
    "slo": r"\[slo\] .*\(over (\d+) first tokens / (\d+) decode windows\)",
    "sched": r"\[sched\] work_queue: (\d+) attention work items over (\d+) "
             r"forwards; grid=(\d+)",
}


def _summary(out: str) -> dict:
    got = {}
    for key, pat in FIELDS.items():
        m = re.search(pat, out)
        assert m, (key, out)
        got[key] = tuple(int(g) for g in m.groups())
    return got


@pytest.fixture(scope="module", params=list(CASES))
def runs(request):
    """→ (case, the port CLI's engine, its flags, what it printed)."""
    argv = COMMON + CASES[request.param]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        eng = SERVE.main(argv + ["--device", "cpu"])
    return request.param, eng, argv, out.getvalue()


def test_cli_counts_match_reference(runs, capsys, monkeypatch):
    name, eng, argv, port = runs
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    JSERVE.main()
    ref = capsys.readouterr().out
    assert _summary(port) == _summary(ref), (port, ref)
    c = eng.counters()
    assert c["internal_errors"] == c["failed_count"] == 0
    assert c["rejected_count"] == 1 and c["aborted_count"] == 1
    if name == "reject_abort_cap":
        assert eng.cache.prefix_reclaimable_bytes <= 4096
        assert eng.cache.prefix_evicted_pages > 0
    else:
        assert c["shed_count"] == 1 and c["preemptions"] == 1
        assert c["prefix_hit_tokens"] > 0


def test_states_line(runs):
    """The ``[states]`` line tallies the terminal states the counters
    report, with every finished request at its token budget."""
    name, eng, argv, port = runs
    line = next(ln for ln in port.splitlines() if ln.startswith("[states]"))
    fin = [r for r in eng.sched.finished if r.state.value == "finished"]
    assert f"finished={len(fin)}" in line and "aborted=1" in line
    assert "queue_full=1" in line
    assert line.endswith(",".join(["6"] * len(fin)))


def test_cli_needs_a_card_unless_told_cpu():
    """The device defaults to the card; without one the CLI raises."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SERVE.main(COMMON + ["--requests", "1"])


def test_sampling_faults_sanitize_flags_match_reference(capsys,
                                                       monkeypatch):
    """Stochastic sampling, an armed fault schedule and the sanitizers:
    what the flags decide (a NaN row failed at step 3, the sampler's 5th
    call failing its rows, a check after every step) matches the
    reference launcher, ``[faults]`` line included."""
    argv = COMMON + ["--requests", "4", "--prompt-len", "16",
                     "--temperature", "0.8", "--top-k", "8", "--sanitize",
                     "--inject-faults",
                     "forward:step=3,action=nan;sample:nth=5"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        eng = SERVE.main(argv + ["--device", "cpu"])
    port = out.getvalue()
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    JSERVE.main()
    ref = capsys.readouterr().out
    assert _summary(port) == _summary(ref), (port, ref)

    def faults_line(text):
        return next(ln for ln in text.splitlines()
                    if ln.startswith("[faults]"))

    assert faults_line(port) == faults_line(ref)
    c = eng.counters()
    assert c["failed_count"] > 0 and c["internal_errors"] == 0
    assert c["sanitize_checks"] == c["steps"]
    assert f"sanitize_checks={c['steps']}" in port


def test_speculation_flag_prints_its_line():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        eng = SERVE.main(COMMON + ["--requests", "3", "--prompt-len", "16",
                                   "--speculation", "3", "--sanitize",
                                   "--device", "cpu"])
    m = re.search(r"\[sched\] speculation: drafted=(\d+) accepted=(\d+) "
                  r"\(acceptance \d+%\) rollback=(\d+) noop=(\d+) "
                  r"draft_errors=(\d+)", out.getvalue())
    assert m, out.getvalue()
    drafted, accepted, rollback, noop, errors = map(int, m.groups())
    assert drafted == accepted + rollback == eng.spec_draft_tokens
    assert noop == eng.spec_noop_count and errors == 0
    assert eng.sanitize_checks == eng.steps


@pytest.mark.parametrize("flag", [["--mesh", "1x2"], ["--head-dim", "64"]])
def test_unported_flags_are_refused(flag):
    """The tensor-parallel flags parse as the reference's do; what is not
    ported with them (a data axis above 1) is refused, naming ROADMAP."""
    args = SERVE.build_parser().parse_args(COMMON + flag)
    assert (args.mesh, args.head_dim) == (
        ("1x2", 0) if flag[0] == "--mesh" else ("1x1", 64))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SERVE.main(COMMON + ["--head-dim", "64", "--mesh", "2x1",
                             "--replicas", "2", "--device", "cpu"])


TP_ARGV = ["--arch", "llama3_8b", "--smoke", "--device", "cpu",
           "--head-dim", "64", "--int4-fraction", "1.0", "--impl", "ref",
           "--max-new", "6", "--page-size", "8", "--shared-prefix", "16",
           "--requests", "4", "--prompt-len", "32", "--abort-every", "2"]


def test_mesh_launcher_counts_match_single_device(capfd):
    """``--mesh 1x2`` (two gloo ranks, rank 0 printing) serves the trace
    with the single-device launcher's counts and tokens; every rank's
    counters agree."""
    SERVE.main(TP_ARGV)
    single = capfd.readouterr().out
    counters = SERVE.main(TP_ARGV + ["--mesh", "1x2"])
    meshed = capfd.readouterr().out
    assert "[mesh] (data=1, model=2) over 2 cpu rank(s)" in meshed
    assert meshed.count("[done]") == 1         # rank 0 alone prints
    got, want = _summary(meshed), _summary(single)
    # the launched grid is per rank's descriptors × ranks: not compared
    got["sched"], want["sched"] = got["sched"][:2], want["sched"][:2]
    assert got == want
    reqs = [ln for ln in single.splitlines() if ln.startswith("  req ")]
    assert reqs and reqs == [ln for ln in meshed.splitlines()
                             if ln.startswith("  req ")]
    assert len(counters) == 2 and counters[0] == counters[1]


@pytest.mark.parametrize("flag,attr,value", [
    (["--failover", "migrate"], "failover", "migrate"),
    (["--kill-replica-at", "3"], "kill_replica_at", 3),
    (["--replicas", "2"], "replicas", 2),
    (["--snapshot-every", "2"], "snapshot_every", 2)])
def test_recovery_and_replica_flags_parse(flag, attr, value):
    """The recovery and replication flags, refused until they were ported,
    parse as the reference's do (their runs: test_torch_replication.py)."""
    assert getattr(SERVE.build_parser().parse_args(COMMON + flag),
                   attr) == value
