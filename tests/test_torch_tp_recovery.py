"""A ``RecoveryLog`` over a tensor-parallel engine on the CPU: two gloo
ranks (spawned once for the file) against the port's one-device log, on
the TP test model (the llama3 smoke config at head_dim 64, so a
row-parallel shard of wo and w_down is one 128-channel block and a mesh's
tokens are one device's; ``int4_fraction=1.0``; ``impl="ref"``; the
port's own seeded weights). The one-device log is held to the reference
by ``test_torch_recovery.py``.

Every rank builds its log over its own engine and steps it in lockstep;
only model rank 0 writes the directory. The workloads
(``_torch_durable_ranks.run_recovery``): a directory-backed log served
uninterrupted; the same crashed two steps past a checkpoint, mid-decode,
and resumed with ``RecoveryLog.open_dir``; a torn ``snapshot_write`` at
the third checkpoint, resumed from the last good snapshot; and a crash
directory of the other kind of engine resumed (a mesh's on one device,
one device's on the mesh).
"""
import dataclasses
import os

import pytest
import torch

import _torch_durable_ranks as D
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import spawn
from repro_torch.models.lm import LM, QuantConfig

TP = 2
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
    params = lm.init(seed=5, device="cpu")
    return CFG, params, lm.axes(params), QC


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("tp_recovery")


@pytest.fixture(scope="module")
def one(model, root):
    return D.run_recovery(model, None, str(root / "one"))


@pytest.fixture(scope="module")
def ranks(model, one, root):
    return spawn(D.recovery_rank, TP, (model, str(root / "mesh"),
                                       one["crash_copy"]),
                 threads=1, timeout_s=240.0)


def test_ranks_import_no_reference(ranks):
    assert [r["foreign_modules"] for r in ranks] == [[]] * TP


def test_crash_resume_streams_equal_uninterrupted_and_one_device(ranks,
                                                                 one):
    """Crashed mid-decode two steps past a checkpoint and resumed from the
    directory: every request's delivered stream, on every rank, is the
    uninterrupted mesh run's and the one-device log's, token for token,
    with one terminal each."""
    want = one["plain"]["tokens"]
    assert len(want) == 3 and all(len(t) == D.MAX_NEW
                                  for t in want.values())
    assert one["crash"]["tokens"] == want
    assert one["crashed_past"] < D.CRASH_AT
    for r in ranks:
        assert r["plain"]["tokens"] == want
        assert r["crash"]["tokens"] == want
        assert r["resumed_at"] == r["crashed_past"] == one["crashed_past"]
        for run in ("plain", "crash"):
            assert r[run]["terminals"] == {i: ["finished"] for i in want}


def test_replay_verified_and_pages_back(ranks, one):
    """The resumed log re-ran the gap: replayed events > 0 (each verified
    bit for bit, no ReplayMismatch), the pages back in the pool, the
    sanitizers run every step, no internal error; the ranks hold one
    snapshot and one journal, and rank 0's ``journal.jsonl`` is it."""
    for r in ranks + [one]:
        got = r["crash"]
        assert got["replayed"] > 0
        assert got["replayed"] == one["crash"]["replayed"]
        assert got["pages_free"] == 64 and got["refs_zero"]
        assert got["internal_errors"] == 0
        assert got["sanitize_checks"] == got["steps"] - r["resumed_at"]
    assert ranks[0]["crash"]["snapshot"] == ranks[1]["crash"]["snapshot"]
    assert ranks[0]["journal"] == ranks[1]["journal"] == \
        ranks[0]["journal_file"]


def test_torn_write_keeps_last_good(ranks, one):
    """A torn ``snapshot_write`` fires on every rank at the same
    checkpoint and raises the same ``InjectedFault`` on each: the last
    good ``snapshot.json`` stands beside the torn temp file, and a resume
    from it finishes with the uninterrupted run's tokens."""
    want = one["plain"]["generated"]
    for r in ranks + [one]:
        torn = r["torn"]
        assert torn is not None and torn["error"] == one["torn"]["error"]
        assert torn["at"] == one["torn"]["at"] == \
            (D.TORN_NTH - 1) * D.SNAP_EVERY
        assert torn["good"] == torn["resumed_at"] < torn["at"]
        assert torn["generated"] == want
        assert torn["pages_free"] == 64
    assert ranks[0]["torn"]["tmp"]       # rank 0's torn temp file


def test_mesh_directory_resumes_on_one_device(model, ranks, root):
    """The mesh's directory at the crash (every kv head gathered into its
    snapshot) resumes on one device with the uninterrupted tokens."""
    got = D.resume_dir(model, None, ranks[0]["crash_copy"],
                       str(root / "mesh_on_one"))
    assert got["generated"] == ranks[0]["plain"]["generated"]
    assert got["replayed"] > 0 and got["pages_free"] == 64


def test_one_device_directory_resumes_on_mesh(ranks, one):
    """One device's directory at the crash resumes on the mesh, every
    rank keeping its kv heads, with the uninterrupted tokens."""
    for r in ranks:
        got = r["foreign"]
        assert got["resumed_at"] == one["crashed_past"]
        assert got["generated"] == one["plain"]["generated"]
        assert got["replayed"] > 0 and got["pages_free"] == 64
    assert os.path.exists(os.path.join(one["crash_copy"], "snapshot.json"))
