"""The port's trainer CLIs (``python -m bvsc_tpu_torch.cli.train_bvrnn`` /
``train_vocoder``) in subprocesses on ``--device cpu`` with a tiny TOML: 2
steps, then a resume to 4; the BVRNN export to ``.npz`` and a vocoder warm
start from a ``g_`` checkpoint; the flags that are not ported raise."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from bvsc_tpu_torch.cli import train_bvrnn, train_vocoder
from bvsc_tpu_torch.convert import load_bvrnn_npz

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240


def _tiny_toml() -> str:
    """``tests/test_cli.py``'s TINY_TOML, read from its source (importing
    that module would put ``scripts/`` on the path)."""
    with open(os.path.join(REPO, "tests", "test_cli.py")) as f:
        for node in ast.parse(f.read()).body:
            if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "TINY_TOML":
                return ast.literal_eval(node.value)
    raise LookupError("TINY_TOML")


TINY_TOML = _tiny_toml()


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    (root / "wavs").mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        t = np.arange(8000) / 8000
        x = 0.3 * np.sin(2 * np.pi * (200 + 50 * i) * t) + 0.02 * rng.standard_normal(8000)
        wavfile.write(str(root / "wavs" / f"a{i}.wav"), 8000, (x * 32767).astype(np.int16))
    (root / "train.txt").write_text("a0|x\na1|x\n")
    (root / "val.txt").write_text("a2|x\n")
    (root / "tiny.toml").write_text(TINY_TOML)
    return root


def common(env, run):
    return ["--config", str(env / "tiny.toml"), "--input_wavs_dir", str(env / "wavs"),
            "--input_training_file", str(env / "train.txt"),
            "--input_validation_file", str(env / "val.txt"),
            "--checkpoint_path", str(env / run), "--stdout_interval", "1", "--device", "cpu"]


BVRNN = ["--batch_size", "4", "--stats_batches", "1"]
VOCODER = ["--batch_size", "2", "--segment_size", "1024", "--validation_interval", "2",
           "--freeze_step", "1"]


def start(module, args):
    return subprocess.Popen(
        [sys.executable, "-m", f"bvsc_tpu_torch.cli.{module}", *args], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"})


def finish(proc) -> str:
    out, _ = proc.communicate(timeout=TIMEOUT)
    assert proc.returncode == 0, out
    return out


@pytest.fixture(scope="module")
def runs(env):
    """Both CLIs at once for 2 steps, then both again to 4 (a resume)."""
    outs = []
    for steps in ("2", "4"):
        procs = [start("train_bvrnn", [*common(env, "bvrnn"), *BVRNN, "--max_steps", steps]),
                 start("train_vocoder", [*common(env, "voc"), *VOCODER, "--max_steps", steps])]
        outs.append([finish(p) for p in procs])
    return outs


def test_train_bvrnn_cli(env, runs):
    (first, _), (second, _) = runs
    assert "Steps : 2" in first and "validation @ 2" in first and "done at step 2" in first
    assert "resumed from step 2" in second and "Steps : 4" in second
    assert "done at step 4" in second
    run = env / "bvrnn"
    assert sorted(f for f in os.listdir(run) if f.startswith("bvrnn_")) == [
        "bvrnn_00000002", "bvrnn_00000004"]
    assert (run / "config.toml").read_text() == TINY_TOML
    assert os.listdir(run / "best")


def test_export_bvrnn_npz_cli(env, runs):
    dst = env / "trained.npz"
    out = subprocess.run([sys.executable, "-m", "bvsc_tpu_torch.cli.export_bvrnn_npz",
                          str(env / "bvrnn" / "bvrnn_00000004"), str(dst)], cwd=REPO,
                         capture_output=True, text=True, timeout=TIMEOUT,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    tree = load_bvrnn_npz(str(dst))
    assert tree["gru"]["w_hh"].shape == (24, 72) and tree["log_sigma"].shape == (1,)


def test_train_vocoder_cli(env, runs):
    (_, first), (_, second) = runs
    assert "Steps : 2" in first and "validation @ 2" in first and "done at step 2" in first
    assert "resumed from step 2" in second and "validation @ 4" in second
    assert "done at step 4" in second
    names = sorted(f for f in os.listdir(env / "voc") if f[:2] in ("g_", "do"))
    assert names == ["do_00000002", "do_00000004", "g_00000002", "g_00000004"]


def test_train_vocoder_warm_start(env, runs, capsys):
    """--init_generator from the run's g_ checkpoint, in process."""
    train_vocoder.main([*common(env, "warm"), *VOCODER, "--max_steps", "1", "--debug",
                        "--init_generator", str(env / "voc" / "g_00000004")])
    out = capsys.readouterr().out
    assert "warm-started" in out and "done at step 1" in out


def test_train_vocoder_fine_tuning(env, capsys):
    """--fine_tuning on precomputed .npy mels (--input_mels_dir), in process."""
    mels = env / "mels"
    mels.mkdir(exist_ok=True)
    rng = np.random.default_rng(1)
    for i in range(2):
        np.save(str(mels / f"a{i}.npy"), (rng.standard_normal((8, 125)) - 4).astype(np.float32))
    train_vocoder.main([*common(env, "ft"), *VOCODER, "--max_steps", "2", "--debug",
                        "--fine_tuning", "--input_mels_dir", str(mels)])
    out = capsys.readouterr().out
    assert "Steps : 2" in out and "done at step 2" in out
    with pytest.raises(SystemExit, match="incompatible"):
        train_vocoder.main([*common(env, "ft2"), *VOCODER, "--max_steps", "1", "--fine_tuning",
                            "--input_mels_dir", str(mels), "--augment"])


@pytest.mark.parametrize("module", [train_bvrnn, train_vocoder], ids=["bvrnn", "vocoder"])
def test_distributed_flags_raise(env, module, tmp_path):
    """Incomplete distributed flags are refused before any connection (the
    two-process run: tests/test_torch_distributed.py)."""
    args = ["--config", str(env / "tiny.toml"), "--input_training_file", str(env / "train.txt"),
            "--checkpoint_path", str(tmp_path), "--device", "cpu"]
    with pytest.raises(ValueError, match="needs --num_processes and --process_id"):
        module.main([*args, "--coordinator_address", "localhost:1234"])
    with pytest.raises(ValueError, match="need --coordinator_address"):
        module.main([*args, "--num_processes", "2", "--process_id", "1"])


@pytest.mark.parametrize("module", [train_bvrnn, train_vocoder], ids=["bvrnn", "vocoder"])
def test_default_device_is_the_card(env, module, tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            module.main(["--config", str(env / "tiny.toml"),
                         "--input_training_file", str(env / "train.txt"),
                         "--checkpoint_path", str(tmp_path)])
