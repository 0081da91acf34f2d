"""The port's synthesis and evaluation CLIs (``bvsc_tpu_torch.cli``) on the
CPU against the JAX scripts' ``main`` (``scripts/``) on the same BVRNN
``.npz`` and the same vocoder weights, at ``tests/test_cli.py``'s TINY_TOML.

The TOML is read from that file's source, as ``tests/test_torch_train_cli.py``
reads it, with one change: three dilations a resblock (``[1, 3, 5]``, the
shipped configs' count) in place of its two, since the port's codec runs the
residual stacks through the K1 path, which covers three-dilation blocks.
JAX reads the vocoder from an Orbax ``g_`` directory
(``bvsc_tpu.train.checkpoint.save_pytree``), the port the same weights as a
``.npz`` or its own ``g_`` file.  The JAX scripts run on the tests' JAX
compilation cache, as ``tests/test_cli.py`` keeps them."""

import ast
import csv
import importlib
import json
import os
import re
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import scipy.signal
import torch
from scipy.io import wavfile

from bvsc_tpu.config import CodecConfig as JCodecConfig
from bvsc_tpu.models import bvrnn as JB
from bvsc_tpu.train import checkpoint as jckpt
from bvsc_tpu_torch.cli import (compare_reference_conditions, dump_finetune_mels,
                                entropy_representativeness, evaluate_codec, prepare_demo_data,
                                select_vocoder_ckpt, synthesize, train_vocoder, validate_pesq)
from bvsc_tpu_torch.config import load_config
from bvsc_tpu_torch.convert import flatten_tree
from bvsc_tpu_torch.data.audio import load_wav, save_wav
from bvsc_tpu_torch.eval.metrics import frontend_for
from bvsc_tpu_torch.serve.client import CodecClient
from bvsc_tpu_torch.train import checkpoint as tckpt
from bvsc_tpu_torch.train.checkpoint import FORMAT as TRAIN_FORMAT
from test_torch_amp_resblock import perturbed_generator_params

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH_TOL = 1e-4  # the vocoder gate; the wavs are int16, one step 3.05e-5
MEL_TOL = 2e-5  # the BVRNN's decoded mel gate
EVAL_TOL = {"mel_l1": 1e-3, "stoi": 1e-3, "mrstft": 1e-3, "mcd_db": 1e-2, "pesq_wb": 1e-2}
DAEMON_TIMEOUT = 120


def _tiny_toml() -> str:
    """``tests/test_cli.py``'s TINY_TOML, read from its source, with three
    dilations a resblock."""
    with open(os.path.join(REPO, "tests", "test_cli.py")) as f:
        for node in ast.parse(f.read()).body:
            if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "TINY_TOML":
                text = ast.literal_eval(node.value)
                break
    old = "resblock_dilation_sizes = [[1, 3]]"
    assert old in text
    return text.replace(old, "resblock_dilation_sizes = [[1, 3, 5]]")


TINY_TOML = _tiny_toml()


def _jax_script(name: str):
    """A JAX script's module, imported by name from ``scripts/`` (they import
    their helpers by bare name)."""
    scripts = os.path.join(REPO, "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    return importlib.import_module(name)


@pytest.fixture()
def jax_cache(monkeypatch):
    """Keep the JAX scripts on the compilation cache conftest.py set
    up (they set the cache from this variable, or a fixed path, which is
    put back afterwards)."""
    cache = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", cache)
    yield
    jax.config.update("jax_compilation_cache_dir", cache)


def _save_port_g(path: str, tree: dict) -> None:
    tckpt.save(path, {"format": TRAIN_FORMAT, "kind": "generator", "step": 0,
                      "params": {k: torch.from_numpy(np.array(v, np.float32))
                                 for k, v in flatten_tree(tree).items()}})


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The TOML, three 0.8-s wavs at 8 kHz with filelists, a BVRNN ``.npz``
    (JAX init), and two vocoders (perturbed JAX inits, seeds 1 and 2) as
    Orbax ``g_`` directories for JAX and as a ``.npz`` (seed 1) and a port
    ``g_`` file (seed 2) for the port."""
    root = tmp_path_factory.mktemp("eval_cli")
    (root / "wavs").mkdir()
    (root / "tiny.toml").write_text(TINY_TOML)
    rng = np.random.default_rng(0)
    t = np.arange(int(0.8 * 8000)) / 8000.0
    names = [f"utt_{i}" for i in range(3)]
    for i, name in enumerate(names):
        wav = 0.5 * np.sin(2 * np.pi * (150 + 60 * i) * t) + 0.05 * rng.standard_normal(t.shape)
        save_wav(wav.astype(np.float32), str(root / "wavs" / f"{name}.wav"), 8000)
    (root / "train.txt").write_text("\n".join(names[:2]) + "\n")
    (root / "val.txt").write_text(names[2] + "\n")

    conf = JCodecConfig.from_toml(str(root / "tiny.toml"))
    bparams = jax.tree.map(np.asarray, JB.init_bvrnn_params(
        jax.random.key(0), JB.BVRNNConfig(x_dim=conf.num_mels, h_dim=conf.h_dim,
                                          z_dim=conf.z_dim)))
    np.savez(root / "bvrnn.npz", **flatten_tree(bparams))
    voc = {}
    for seed in (1, 2):
        tree = perturbed_generator_params(conf.vocoder_config, seed=seed)
        jckpt.save_pytree(str(root / f"jax_g_{seed}" / "g_00000001"), {"generator": tree})
        voc[seed] = tree
    np.savez(root / "voc_1.npz", **flatten_tree(voc[1]))
    (root / "port").mkdir()
    _save_port_g(str(root / "port" / "g_00000002"), voc[2])
    return root


def _args(env, *extra):
    return ["--config", str(env / "tiny.toml"), *extra]


def _read(path) -> np.ndarray:
    return load_wav(str(path))[0]


# -- synthesize -----------------------------------------------------------------

@pytest.fixture(scope="module")
def mels(env):
    """``dump_finetune_mels`` of both packages on the training filelist, at
    one drawn bitrate per utterance."""
    out = {}
    common = ["--bvrnn_checkpoint", str(env / "bvrnn.npz"), "--input_wavs_dir",
              str(env / "wavs"), "--input_training_file", str(env / "train.txt"),
              "--random_bitrate", "150", "450", "--seed", "3"]
    _jax_script("dump_finetune_mels").main(_args(env, *common, "--output_dir",
                                                 str(env / "mels_jax"), "--platform", "cpu"))
    out["jax"] = str(env / "mels_jax")
    dump_finetune_mels.main(_args(env, *common, "--output_dir", str(env / "mels_port"),
                                  "--device", "cpu"))
    out["port"] = str(env / "mels_port")
    return out


def test_dump_finetune_mels_matches_jax(mels):
    names = sorted(os.listdir(mels["port"]))
    assert names == sorted(os.listdir(mels["jax"])) == ["utt_0.npy", "utt_1.npy"]
    for n in names:
        got, want = np.load(os.path.join(mels["port"], n)), np.load(os.path.join(mels["jax"], n))
        assert got.dtype == np.float32 and got.shape == want.shape and got.shape[0] == 8
        gap = np.abs(got - want).max()
        assert gap <= MEL_TOL, f"{n}: decoded mel {gap} from bvsc_tpu's (tolerance {MEL_TOL})"


@pytest.mark.parametrize("mode", ["wavs", "mels"])
def test_synthesize_matches_jax(env, mels, tmp_path, mode):
    """wav -> mel -> waveform and ``.npy`` mel -> waveform: the port's wavs
    (from the ``.npz`` and from the port ``g_`` of the same weights) against
    the JAX script's (from the Orbax ``g_``), with ``--fs_out``."""
    src = (["--input_wavs_dir", str(env / "wavs")] if mode == "wavs"
           else ["--input_mels_dir", mels["port"]])
    _jax_script("synthesize").main(_args(env, *src, "--output_dir", str(tmp_path / "jax"),
                                         "--checkpoint_file",
                                         str(env / "jax_g_1" / "g_00000001"),
                                         "--fs_out", "4000", "--platform", "cpu"))
    written = synthesize.main(_args(env, *src, "--output_dir", str(tmp_path / "port"),
                                    "--checkpoint_file", str(env / "voc_1.npz"),
                                    "--fs_out", "4000", "--device", "cpu"))
    suffix = "_generated.wav" if mode == "wavs" else "_generated_e2e.wav"
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert [os.path.basename(w) for w in written] == names
    assert all(n.endswith(suffix) for n in names) and len(names) == (3 if mode == "wavs" else 2)
    for n in names:
        fs, _ = wavfile.read(tmp_path / "port" / n)
        got, want = _read(tmp_path / "port" / n), _read(tmp_path / "jax" / n)
        assert fs == 4000 and got.shape == want.shape
        gap = np.abs(got - want).max()
        assert gap <= SYNTH_TOL, f"{n}: {gap} from bvsc_tpu's (tolerance {SYNTH_TOL})"
        assert np.abs(got).max() > 10 * SYNTH_TOL, "a silent output compares nothing"


def test_synthesize_reads_port_checkpoints_and_nearby_config(env, tmp_path, capsys):
    """The port ``g_`` of seed 2 synthesises what its ``.npz`` does, and
    without ``--config`` the ``config.toml`` beside the checkpoint is used."""
    tree = perturbed_generator_params(JCodecConfig.from_toml(str(env / "tiny.toml"))
                                      .vocoder_config, seed=2)
    np.savez(tmp_path / "voc_2.npz", **flatten_tree(tree))
    run = tmp_path / "run"
    run.mkdir()
    (run / "config.toml").write_text(TINY_TOML)
    _save_port_g(str(run / "g_00000002"), tree)
    synthesize.main(["--input_wavs_dir", str(env / "wavs"), "--output_dir", str(tmp_path / "g"),
                     "--checkpoint_file", str(run / "g_00000002"), "--device", "cpu"])
    assert f"using config {run / 'config.toml'}" in capsys.readouterr().out
    synthesize.main(_args(env, "--input_wavs_dir", str(env / "wavs"), "--output_dir",
                          str(tmp_path / "npz"), "--checkpoint_file", str(tmp_path / "voc_2.npz"),
                          "--device", "cpu"))
    for n in sorted(os.listdir(tmp_path / "npz")):
        np.testing.assert_array_equal(_read(tmp_path / "g" / n), _read(tmp_path / "npz" / n))
    with pytest.raises(SystemExit, match="exactly one"):
        synthesize.main(["--checkpoint_file", str(run / "g_00000002"), "--device", "cpu"])
    with pytest.raises(SystemExit, match="Orbax"):
        synthesize.main(_args(env, "--input_wavs_dir", str(env / "wavs"), "--checkpoint_file",
                              str(env / "jax_g_1" / "g_00000001"), "--device", "cpu"))


def test_fine_tuning_takes_the_dumped_mels(env, mels, tmp_path, capsys):
    """``train_vocoder --fine_tuning`` trains a step on the dumped mels."""
    train_vocoder.main(_args(env, "--input_wavs_dir", str(env / "wavs"),
                             "--input_training_file", str(env / "train.txt"),
                             "--input_mels_dir", mels["port"], "--fine_tuning",
                             "--checkpoint_path", str(tmp_path / "ft"), "--max_steps", "1",
                             "--batch_size", "2", "--segment_size", "1024", "--debug",
                             "--stdout_interval", "1", "--device", "cpu"))
    out = capsys.readouterr().out
    assert "Steps : 1" in out and "done at step 1" in out
    assert os.path.exists(tmp_path / "ft" / "g_00000001")


def test_train_vocoder_validation_prints_stoi_and_pesq(env, tmp_path, capsys):
    """``--evaluate`` validates the seen set and an unseen one, with STOI and
    PESQ beside mel-L1 and MRSTFT; a ``nonspeech`` set has no PESQ."""
    (tmp_path / "nonspeech.txt").write_text("utt_0\n")
    train_vocoder.main(_args(env, "--input_wavs_dir", str(env / "wavs"),
                             "--input_training_file", str(env / "train.txt"),
                             "--input_validation_file", str(env / "val.txt"),
                             "--list_input_unseen_wavs_dir", str(env / "wavs"),
                             "--list_input_unseen_validation_file",
                             str(tmp_path / "nonspeech.txt"),
                             "--checkpoint_path", str(tmp_path / "voc"), "--evaluate",
                             "--device", "cpu"))
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("validation @")]
    seen = next(ln for ln in lines if "[seen_val]" in ln)
    nonspeech = next(ln for ln in lines if "[unseen_nonspeech]" in ln)
    for line, pesq in ((seen, True), (nonspeech, False)):
        values = dict(re.findall(r"(\w+)=(-?[\d.]+)", line))
        assert np.isfinite(float(values["stoi"])) and 0 < float(values["stoi"]) <= 1
        assert ("pesq" in values) == pesq, line
        if pesq:
            assert 1.0 <= float(values["pesq"]) <= 4.7, line


# -- evaluate_codec ---------------------------------------------------------------

def test_evaluate_codec_matches_jax(env, tmp_path, jax_cache):
    """The summary of both packages on the same weights and wavs: mel-L1,
    MRSTFT and STOI within 1e-3, MCD and PESQ within 1e-2; the port's run
    also conceals seeded losses and entropy-codes its codes."""
    common = ["--stimuli_dir", str(env / "wavs"), "--bitrates", "200", "400", "--limit", "1",
              "--bvrnn_checkpoint", str(env / "bvrnn.npz")]
    _jax_script("evaluate_codec").main(_args(env, *common, "--vocoder_checkpoint",
                                             str(env / "jax_g_1" / "g_00000001"),
                                             "--out_json", str(tmp_path / "jax.json"),
                                             "--platform", "cpu"))
    report = evaluate_codec.main(_args(env, *common, "--vocoder_checkpoint",
                                       str(env / "voc_1.npz"), "--out_json",
                                       str(tmp_path / "port.json"), "--loss_rate", "0.2",
                                       "--entropy", "--device", "cpu"))
    want = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(json.dumps(report))
    assert report["n_stimuli"] == want["n_stimuli"] == 1
    assert sorted(report["summary"]) == sorted(want["summary"]) == ["200.0", "400.0"]
    for bps, jsum in want["summary"].items():
        got = report["summary"][bps]
        for k, tol in EVAL_TOL.items():
            assert abs(got[k] - jsum[k]) <= tol, f"{bps} {k}: {got[k]} vs {jsum[k]} (tol {tol})"
        for k in ("mel_l1_plc", "stoi_plc", "entropy_bps", "entropy_saving_pct"):
            assert np.isfinite(got[k]), k
    frames = frontend_for(load_config(str(env / "tiny.toml")), "cpu").num_frames(
        evaluate_codec.load_22k(str(env / "wavs" / "utt_0.wav")).shape[0])
    for row, jrow in zip(report["rows"], want["rows"]):
        assert row["bits_per_frame"] == jrow["bits_per_frame"]
        # the loss pattern is seeded by crc32 of the name: the same in every run
        lost = evaluate_codec.draw_losses(evaluate_codec.loss_rng(0, row["stim"], row["bps"]),
                                          frames, 0.2)
        assert row["loss_pct"] == round(100.0 * float(lost.mean()), 2)


@pytest.mark.parametrize("burst", [None, 4.0], ids=["iid", "gilbert_elliott"])
def test_draw_losses_matches_jax(burst):
    """``draw_losses`` is the JAX script's on the same generator."""
    jax_draw = _jax_script("evaluate_codec").draw_losses
    got = evaluate_codec.draw_losses(np.random.default_rng(5), 500, 0.1, burst)
    np.testing.assert_array_equal(got, jax_draw(np.random.default_rng(5), 500, 0.1, burst))
    assert 0.02 < got.mean() < 0.25


def test_loss_seed_does_not_depend_on_the_process():
    """A row's losses are the same in another process with another string
    hash seed (the JAX script seeds with the salted ``hash``)."""
    code = ("from bvsc_tpu_torch.cli.evaluate_codec import draw_losses, loss_rng;"
            "print(draw_losses(loss_rng(0, 'stim_01', 1378.0), 64, 0.3).tolist())")
    other = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                           timeout=120, cwd=REPO,
                           env={**os.environ, "PYTHONPATH": REPO, "PYTHONHASHSEED": "1"})
    here = evaluate_codec.draw_losses(evaluate_codec.loss_rng(0, "stim_01", 1378.0), 64, 0.3)
    assert other.returncode == 0, other.stderr
    assert other.stdout.strip() == str(here.tolist()) and 0 < here.sum() < 64


# -- select_vocoder_ckpt ----------------------------------------------------------

def test_select_vocoder_ckpt_matches_jax(env, capsys, jax_cache):
    """Both packages rank the same two generators the same way, with mel-L1
    within 1e-3."""
    _jax_script("select_vocoder_ckpt").main(_args(
        env, "--bvrnn_checkpoint", str(env / "bvrnn.npz"), "--candidates",
        str(env / "jax_g_1" / "g_00000001"), str(env / "jax_g_2" / "g_00000001"),
        "--stimuli", str(env / "wavs" / "utt_0.wav"), str(env / "wavs" / "utt_1.wav"),
        "--bitrate", "200", "--platform", "cpu"))
    jout = capsys.readouterr().out
    want = {("voc_1" if "jax_g_1" in line else "voc_2"): float(line.split("=")[-1])
            for line in jout.splitlines() if "e2e mel-L1 =" in line}
    got = select_vocoder_ckpt.main(_args(
        env, "--bvrnn_checkpoint", str(env / "bvrnn.npz"), "--candidates",
        str(env / "voc_1.npz"), str(env / "port" / "g_????????"),
        "--stimuli", str(env / "wavs" / "utt_0.wav"), str(env / "wavs" / "utt_1.wav"),
        "--bitrate", "200", "--device", "cpu"))
    ranked = [("voc_1" if p.endswith("voc_1.npz") else "voc_2") for _, p in got]
    assert ranked == sorted(want, key=want.get)
    for (l1, _), name in zip(got, ranked):
        assert abs(l1 - want[name]) <= 1e-3, f"{name}: {l1} vs {want[name]}"
    assert f"BEST: {got[0][1]}" in capsys.readouterr().out


# -- the MUSHRA layout: compare_reference_conditions, validate_pesq, prepare_demo_data

# condition -> (file stem, noise SNR in dB of the synthetic condition, human mean)
CONDITIONS = {"Reference": ("ref", None, 97.0), "Proposed 1.38": ("prop_13", 8.0, 52.0),
              "Proposed 5.51": ("prop_55", 22.0, 63.0), "Lyra 3.2": ("lyra_32", 12.0, 41.0),
              "Lyra 6": ("lyra_6", 28.0, 57.0)}


def _speech(fs: int, seconds: float, seed: int) -> np.ndarray:
    """Gliding harmonics under a syllable envelope with bursts of high-band
    noise (fricatives), peak 0.9."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(fs * seconds)) / fs
    phase = 2 * np.pi * np.cumsum(120 + 40 * np.sin(2 * np.pi * 0.7 * t)) / fs
    voiced = sum(np.sin(k * phase) / k for k in range(1, 12))
    voiced *= 0.3 + 0.7 * np.clip(np.sin(2 * np.pi * 2.3 * t), 0, 1)
    sos = scipy.signal.butter(4, [2500, 0.45 * fs], btype="band", fs=fs, output="sos")
    fric = scipy.signal.sosfilt(sos, rng.standard_normal(t.size))
    fric *= np.clip(np.sin(2 * np.pi * 2.3 * t + np.pi), 0, 1) ** 2
    x = voiced / np.abs(voiced).max() + 0.6 * fric / np.abs(fric).max()
    return 0.9 * x / np.abs(x).max()


@pytest.fixture(scope="module")
def mushra_layout(tmp_path_factory):
    """The dataset's layout: ``audio/stim_NN/{ref,prop_13,...}.wav`` at 24 kHz
    (stereo int16, as the reference ships them) and the ratings CSV, for
    two stimuli; each condition is the reference at its SNR."""
    root = tmp_path_factory.mktemp("mushra")
    rng = np.random.default_rng(11)
    with open(root / "ratings_formated_filtered.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["signal", "condition", "ratings", "participant_ids", "file"])
        for s in (1, 2):
            d = root / "audio" / f"stim_{s:02d}"
            d.mkdir(parents=True)
            ref = _speech(24000, 1.2, s)
            for cond, (stem, snr, mean) in CONDITIONS.items():
                x = ref
                if snr is not None:
                    noise = rng.standard_normal(ref.size)
                    x = ref + noise * np.sqrt((ref ** 2).mean() / (noise ** 2).mean()) \
                        * 10 ** (-snr / 20)
                pcm = (np.clip(x, -1, 1) * 32767).astype(np.int16)
                wavfile.write(str(d / f"{stem}.wav"), 24000, np.stack([pcm, pcm], 1))
                ratings = np.clip(mean + rng.normal(0, 4, 5), 0, 100).round(1).tolist()
                w.writerow([f"stim_{s:02d}", cond, str(ratings), str([0, 1, 2, 3, 4]),
                            f"mushra/audio/stim_{s:02d}/{stem}.wav"])
    return root


def test_compare_reference_conditions_matches_jax(mushra_layout, tmp_path, jax_cache):
    """``--skip_ours`` on the synthetic layout: the same table and Spearman
    correlations as the JAX script's; the metrics, rounded to 4 decimals,
    within one step of that rounding plus the mel frontend's gate for
    mel-L1 and 1e-2 dB for MCD (121 dB here: the noise fills the log-mel's
    floor)."""
    args = ["--dataset", str(mushra_layout), "--skip_ours"]
    _jax_script("compare_reference_conditions").main(
        args + ["--out_json", str(tmp_path / "jax.json"), "--platform", "cpu"])
    got = compare_reference_conditions.main(
        args + ["--out_json", str(tmp_path / "port.json"), "--device", "cpu"])
    want = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == got
    assert got["n_stimuli"] == want["n_stimuli"] == 2
    assert got["spearman_vs_mushra"] == want["spearman_vs_mushra"]
    assert set(got["spearman_vs_mushra"]) == {"mel_l1", "mrstft", "stoi", "mcd_db"}
    assert sorted(got["conditions"]) == sorted(want["conditions"]) == [
        "lyra_32.wav", "lyra_6.wav", "prop_13.wav", "prop_55.wav"]
    for cond, row in want["conditions"].items():
        for k, v in row.items():
            if isinstance(v, float) and k != "mushra_mean":
                tol = 1e-4 + {"mel_l1": 2e-4, "mcd_db": 1e-2}.get(k, 1e-9)
                assert abs(got["conditions"][cond][k] - v) <= tol, (cond, k, tol)
            else:
                assert got["conditions"][cond][k] == v, (cond, k)
    assert got["conditions"]["prop_13.wav"]["mushra_condition"] == "Proposed 1.38"


def test_validate_pesq_on_a_synthetic_layout(mushra_layout, tmp_path):
    """The port's validation runs on the layout given as its argument and
    writes its report where ``--out`` says."""
    out = tmp_path / "pesq_validation.json"
    report = validate_pesq.main(["--dataset", str(mushra_layout), "--out", str(out)])
    assert json.loads(out.read_text())["within_family"] == report["within_family"]
    assert all(v["agrees"] for v in report["within_family"].values())
    sl = report["signal_level"]
    assert sl["identical"] > 4.6 and sl["awgn_by_snr"][0] < sl["awgn_by_snr"][40]
    assert report["conditions"]["prop_55.wav"]["n"] == 2
    assert report["conditions"]["prop_13.wav"]["pesq_mean"] \
        < report["conditions"]["prop_55.wav"]["pesq_mean"]


def test_prepare_demo_data_matches_jax(mushra_layout, tmp_path):
    """The corpus rebuild: the same filelists and the same wav bytes."""
    src = str(mushra_layout / "audio")
    _jax_script("prepare_demo_data").main(["--src", src, "--out", str(tmp_path / "jax"),
                                           "--val", "stim_02"])
    train, val = prepare_demo_data.main(["--src", src, "--out", str(tmp_path / "port"),
                                         "--val", "stim_02"])
    assert (train, val) == (["stim_01"], ["stim_02"])
    for name in ("train.txt", "val.txt", "wavs/stim_01.wav", "wavs/stim_02.wav"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    x, fs = load_wav(str(tmp_path / "port" / "wavs" / "stim_01.wav"))
    assert fs == 22050 and x.shape == (int(1.2 * 22050),)
    with pytest.raises(SystemExit, match="not found"):
        prepare_demo_data.main(["--src", src, "--out", str(tmp_path / "port"), "--val", "stim_9"])


@pytest.mark.parametrize("main, argv, flag", [
    (evaluate_codec.main, [], "--stimuli_dir"),
    (select_vocoder_ckpt.main, ["--bvrnn_checkpoint", "b.npz", "--candidates", "g.npz"],
     "--stimuli"),
    (compare_reference_conditions.main, ["--skip_ours"], "--dataset"),
    (validate_pesq.main, [], "--dataset"),
    (prepare_demo_data.main, [], "--src"),
], ids=["evaluate_codec", "select_vocoder_ckpt", "compare_reference_conditions",
        "validate_pesq", "prepare_demo_data"])
def test_dataset_flags_have_no_default(main, argv, flag, capsys):
    """The MUSHRA dataset is not in the checkout: a CLI run without the flag
    that names it stops and names the flag, reading nothing."""
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 2 and flag in capsys.readouterr().err


# -- entropy_representativeness and serve_daemon ----------------------------------

def test_entropy_representativeness_on_a_tiny_model(env, tmp_path, monkeypatch):
    """The wire coder's statistics for a checkpoint and the random init,
    every block decoded back, into ``--out``; the bitrates cut to what the
    tiny model's 6 code bits carry."""
    monkeypatch.setattr(entropy_representativeness, "BITRATES", (250.0, 500.0))
    out = tmp_path / "stats.json"
    report = entropy_representativeness.main(_args(
        env, "--wavs", str(env / "wavs"), "--checkpoints", str(env / "bvrnn.npz"),
        "--stimuli", "2", "--block", "4", "--out", str(out),
        "--device", "cpu"))
    assert json.loads(out.read_text()) == report
    assert sorted(report["sources"]) == ["bvrnn", "random_init_fullsize"]
    frames = frontend_for(load_config(str(env / "tiny.toml")), "cpu").num_frames(6400)
    for rows in report["sources"].values():
        assert [rows[b]["raw_bits_per_frame"] for b in ("250", "500")] == [2.0, 4.0]
        for r in rows.values():
            assert r["frames"] == 2 * (frames // 4 * 4) and r["payload_bits_per_frame"] > 0


@pytest.fixture(scope="module")
def daemon_cli_run(env):
    """``python -m bvsc_tpu_torch.cli.serve_daemon`` on the CPU (fast
    serving, 2 slots) serving one resynthesis stream of whole hops, then
    SIGTERM: (the stream's input, its audio, the exit code, the "served"
    lines)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "bvsc_tpu_torch.cli.serve_daemon", *_args(env),
         "--bvrnn", str(env / "bvrnn.npz"), "--vocoder", str(env / "voc_1.npz"),
         "--port", "0", "--max_streams", "2", "--device", "cpu"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"})
    try:
        line = proc.stdout.readline()  # blocks until the daemon is up
        assert line.startswith("BVSP/1 serving on 127.0.0.1:") and "2 stream slots" in line, line
        port = int(line.split()[3].rsplit(":", 1)[1])
        x = (0.3 * np.random.default_rng(4).standard_normal(2048)).astype(np.float32)
        with CodecClient("127.0.0.1", port, mode="resynth", bitrate=200,
                         timeout=DAEMON_TIMEOUT) as c:
            c.send_audio(x)
            c.close_input()
            out = c.drain()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=DAEMON_TIMEOUT)
        served = [ln for ln in proc.stdout.read().splitlines() if ln.startswith("BVSP/1 served ")]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return x, out["audio"], rc, served


def test_serve_daemon_cli_sigterm(env, daemon_cli_run):
    """The daemon CLI serves one resynthesis stream, then exits 0 on SIGTERM
    and reports a tick a frame, no kernel launch on the CPU, and the
    process's TF32 flags (PyTorch's defaults: the fast codec sets none)."""
    x, audio, rc, served = daemon_cli_run
    assert audio.shape == x.shape and np.isfinite(audio).all()
    assert rc == 0
    hop = load_config(str(env / "tiny.toml")).hopsize
    assert len(served) == 1 and json.loads(served[0][len("BVSP/1 served "):]) == {
        "ticks": {"serve": x.shape[0] // hop, "decode": 0},
        "k1_launches": {"float32": 0, "bf16": 0},  # no kernel on the CPU
        "tf32": {"matmul": False, "cudnn": True}}, served


def test_serve_daemon_cli_audio_is_the_engines(env, daemon_cli_run):
    """The daemon CLI's fast audio bitwise an in-process 2-slot fast
    ServingEngine's on the same input, weights and bitrate (flushed as the
    daemon's CLOSE flushes)."""
    from bvsc_tpu_torch.codec import BVRNNCodecModel
    from bvsc_tpu_torch.serve.engine import ServingEngine

    x, audio, _, _ = daemon_cli_run
    codec = BVRNNCodecModel(str(env / "tiny.toml"), bvrnn_chkpt_path=str(env / "bvrnn.npz"),
                            vocoder_chkpt_path=str(env / "voc_1.npz"), precision="default",
                            device="cpu")
    eng = ServingEngine(codec, max_streams=2)
    sid = eng.open_stream(200)
    eng.push(sid, x)
    eng.begin_flush(sid)
    ref = []
    while (out := eng.tick()):
        ref.append(out[sid][1])
    np.testing.assert_array_equal(audio, np.concatenate(ref)[: audio.shape[0]])
