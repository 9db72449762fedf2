"""The port's training launcher (``repro_torch.launch.train``) on the CPU:
the reference's line format, exact resume from a checkpoint, training
over a ``(data, model)`` mesh of gloo ranks (its loss lines within the
one-device run's bounds, exact resume of a 2 × 2 mesh from its own
checkpoint) and the refusal of a CUDA device without a card."""
import os
import re

import numpy as np
import pytest
import torch

from repro_torch.launch import train as T

SMOKE = ["--arch", "llama3_8b", "--smoke", "--device", "cpu", "--batch",
         "4", "--seq", "32", "--log-every", "1", "--warmup", "2"]
LINE = re.compile(r"^step (\d+): loss=(\d+\.\d{4}) ce=(\d+\.\d{4}) "
                  r"gnorm=(\d+\.\d{3}) \((\d+\.\d{2})s\)$")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(capsys, *extra):
    T.main(SMOKE + list(extra))
    return capsys.readouterr().out.splitlines()


def _steps(lines) -> dict:
    """step → the line without its wall-clock time."""
    out = {}
    for line in lines:
        m = LINE.match(line)
        if m:
            out[int(m[1])] = line[:line.rindex(" (")]
    return out


def _arrays(step_dir) -> list:
    names = sorted(n for n in os.listdir(step_dir) if n.endswith(".npy"))
    return [np.load(os.path.join(step_dir, n)) for n in names]


def test_resume_reproduces_uninterrupted_run(tmp_path, capsys):
    """8 steps with checkpoints every 4, and a run resumed from step 4's:
    the same step 4–7 lines and the same final checkpoint, bit for bit."""
    full, part = tmp_path / "full", tmp_path / "part"
    a = _run(capsys, "--steps", "8", "--ckpt-dir", str(full),
             "--ckpt-every", "4")
    assert a[-1] == "done"
    assert sorted(os.listdir(full)) == ["step_00000004", "step_00000008"]
    steps_a = _steps(a)
    assert sorted(steps_a) == list(range(8))
    part.mkdir()
    os.rename(full / "step_00000004", part / "step_00000004")
    b = _run(capsys, "--steps", "8", "--ckpt-dir", str(part),
             "--ckpt-every", "4")
    assert b[0] == "[resume] restored step 4" and b[-1] == "done"
    steps_b = _steps(b)
    assert sorted(steps_b) == [4, 5, 6, 7]
    assert all(steps_b[s] == steps_a[s] for s in steps_b)
    got, want = (_arrays(d / "step_00000008") for d in (part, full))
    assert len(got) == len(want) > 0
    assert all(x.dtype == y.dtype and np.array_equal(x, y)
               for x, y in zip(got, want))


def test_loss_falls_and_keeps_last_three(tmp_path, capsys):
    """Each cleanup, right after a background save starts, keeps the
    newest three complete steps; the final save adds the last."""
    lines = _run(capsys, "--steps", "12", "--lr", "3e-3", "--ckpt-dir",
                 str(tmp_path), "--ckpt-every", "2")
    steps = _steps(lines)
    losses = [float(LINE.match(steps[s] + " (0.00s)")[2]) for s in (0, 11)]
    assert losses[1] < losses[0]
    assert sorted(os.listdir(tmp_path)) == [
        "step_00000006", "step_00000008", "step_00000010", "step_00000012"]


@pytest.mark.parametrize("arch", ["hubert_xlarge", "llama3p2_vision_90b"])
def test_frames_and_image_embeds_per_step(arch, capsys):
    lines = _run(capsys, "--arch", arch, "--steps", "2")
    assert sorted(_steps(lines)) == [0, 1] and lines[-1] == "done"


def _numbers(steps: dict) -> dict:
    """step → (loss, ce, gnorm) of its line."""
    return {k: tuple(float(x) for x in LINE.match(v + " (0.00s)").group(
        2, 3, 4)) for k, v in steps.items()}


@pytest.mark.parametrize("flag", ["--data", "--model"])
def test_mesh_above_one_is_refused(flag, capfd):
    """Once refused, now trained: ``--data 2`` (two data ranks) and
    ``--model 2`` (two model ranks) on gloo print the ``[mesh]`` line and
    the one-device run's step lines within the bounds of
    ``test_torch_train_step.py`` (loss and ce 1e-3, grad norm 1e-2
    relative, plus the lines' rounding)."""
    T.main(SMOKE + ["--steps", "4"])
    one = _steps(capfd.readouterr().out.splitlines())
    T.main(SMOKE + ["--steps", "4", flag, "2"])
    lines = capfd.readouterr().out.splitlines()
    d, m = (2, 1) if flag == "--data" else (1, 2)
    assert lines[0] == f"[mesh] (data={d}, model={m}) over 2 cpu rank(s)"
    assert lines[-1] == "done"
    got, want = _numbers(_steps(lines)), _numbers(one)
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for s in got:
        for x, y, tol in zip(got[s], want[s], (1e-3, 1e-3, 1e-2)):
            assert abs(x - y) <= tol * abs(y) + 5e-4, (s, got[s], want[s])


def test_mesh_resume_reproduces_uninterrupted_run(tmp_path, capfd):
    """``--data 2 --model 2``: 8 steps with checkpoints every 4 written
    from the mesh, and a run resumed from step 4's: the same step 4–7
    lines and the same final checkpoint, bit for bit."""
    full, part = tmp_path / "full", tmp_path / "part"
    mesh = ["--data", "2", "--model", "2", "--steps", "8", "--ckpt-every",
            "4"]
    T.main(SMOKE + mesh + ["--ckpt-dir", str(full)])
    a = capfd.readouterr().out.splitlines()
    assert a[-1] == "done"
    assert sorted(os.listdir(full)) == ["step_00000004", "step_00000008"]
    part.mkdir()
    os.rename(full / "step_00000004", part / "step_00000004")
    T.main(SMOKE + mesh + ["--ckpt-dir", str(part)])
    b = capfd.readouterr().out.splitlines()
    assert b[1] == "[resume] restored step 4" and b[-1] == "done"
    steps_a, steps_b = _steps(a), _steps(b)
    assert sorted(steps_a) == list(range(8))
    assert sorted(steps_b) == [4, 5, 6, 7]
    assert all(steps_b[s] == steps_a[s] for s in steps_b)
    got, want = (_arrays(d / "step_00000008") for d in (part, full))
    assert len(got) == len(want) > 0
    assert all(x.dtype == y.dtype and np.array_equal(x, y)
               for x, y in zip(got, want))


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda runs")
    with pytest.raises(RuntimeError, match="none is available"):
        T.main(["--arch", "llama3_8b", "--smoke", "--steps", "1"])
