"""The port's eval package (``bvsc_tpu_torch.eval``) against
``bvsc_tpu.eval`` on the CPU, on the same seeded numpy signals: the host
metrics (STOI, PESQ-WB, SNR: the same numpy code) equal, mel-L1 within the
mel frontend's 2e-4, MRSTFT within 1e-5 relative, MCD within 1e-2 dB; PESQ's
properties (tests/test_pesq.py); the MUSHRA statistics, screening rule and
command line on a synthetic ratings CSV."""

import csv
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from bvsc_tpu.eval import metrics as JM
from bvsc_tpu.eval import mushra as JMU
from bvsc_tpu.eval.pesq import pesq_wb as j_pesq_wb
from bvsc_tpu.ops.mel import MelFrontend as JMelFrontend
from bvsc_tpu_torch.codec import DEFAULT_CONFIG
from bvsc_tpu_torch.config import load_config
from bvsc_tpu_torch.eval import metrics as TM
from bvsc_tpu_torch.eval import mushra as TMU
from bvsc_tpu_torch.eval.pesq import pesq_wb

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = 22050
MEL_TOL = 2e-4  # the mel frontend's gate
MRSTFT_RTOL = 1e-5
MCD_TOL = 1e-2  # dB


def speechlike(fs: int, seconds: float, seed: int = 0) -> np.ndarray:
    """Gliding harmonics with an envelope and a little noise, peak 1."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(fs * seconds)) / fs
    f0 = 120 + 40 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / fs
    x = sum(np.sin(k * phase) / k for k in range(1, 9))
    env = 0.4 + 0.6 * np.clip(np.sin(2 * np.pi * 2.3 * t), 0, 1)
    x = x * env + 0.001 * rng.standard_normal(t.size)
    return x / np.abs(x).max()


@pytest.fixture(scope="module")
def clips():
    """A clean clip and a degraded one (lowpassed, noisy, slightly delayed),
    float32 at 22 050 Hz."""
    x = speechlike(FS, 1.5)
    sos = scipy.signal.butter(6, 3000, fs=FS, output="sos")
    y = scipy.signal.sosfilt(sos, x) + 0.02 * np.random.default_rng(1).standard_normal(x.size)
    y = np.concatenate([np.zeros(40), y[:-40]])
    return x.astype(np.float32), y.astype(np.float32)


@pytest.fixture(scope="module")
def frontends():
    conf = load_config(DEFAULT_CONFIG)
    jf = JMelFrontend(sampling_rate=conf.fs, n_fft=conf.winsize, num_mels=conf.num_mels,
                      hop_size=conf.hopsize, win_size=conf.winsize, fmin=conf.fmin,
                      fmax=conf.fmax, padding_left=conf.mel_pad_left)
    return jf, TM.frontend_for(conf, "cpu")


HOST_METRICS = {
    "stoi": (TM.stoi, JM.stoi, lambda x, y: (x, y)),
    "pesq_wb": (pesq_wb, j_pesq_wb, lambda x, y: (x, y, FS)),
    "pesq_wb_16k": (TM.pesq_wb_16k, JM.pesq_wb_16k, lambda x, y: (x, y)),
    "snr_db": (TM.snr_db, JM.snr_db, lambda x, y: (x, y)),
}


@pytest.mark.parametrize("name", sorted(HOST_METRICS))
def test_host_metric_equals_jax(clips, name):
    port, ref, args = HOST_METRICS[name]
    got, want = port(*args(*clips)), ref(*args(*clips))
    assert got == want, f"{name}: {got} != {want} (the same numpy code: equal)"


def test_mel_l1_matches_jax(clips, frontends):
    x, y = clips
    jf, tf = frontends
    want = JM.mel_l1(jf, jnp.asarray(x[None]), jnp.asarray(y[None]))
    got = TM.mel_l1(tf, torch.from_numpy(x[None]), torch.from_numpy(y[None]))
    assert abs(got - want) <= MEL_TOL, f"mel_l1 {got} vs {want} (tolerance {MEL_TOL})"
    assert TM.mel_l1(tf, x[None], y[None]) == got, "numpy inputs give the tensors' value"
    assert TM.mel_l1(tf, x[None], x[None]) == 0.0


def test_mrstft_matches_jax(clips):
    x, y = clips
    want = JM.mrstft(jnp.asarray(y[None]), jnp.asarray(x[None]))
    got = TM.mrstft(torch.from_numpy(y[None]), torch.from_numpy(x[None]))
    assert abs(got - want) <= MRSTFT_RTOL * abs(want), (
        f"mrstft {got} vs {want} (relative tolerance {MRSTFT_RTOL})")
    assert TM.mrstft(y[None], x[None]) == got, "numpy inputs give the tensors' value"


def test_mcd_matches_jax(clips, frontends):
    x, y = clips
    jf, tf = frontends
    want = JM.mcd(jf, x, y)
    got = TM.mcd(tf, x, y)
    assert abs(got - want) <= MCD_TOL, f"mcd {got} vs {want} dB (tolerance {MCD_TOL} dB)"
    assert got > 1.0 and TM.mcd(tf, x, x) == 0.0


def test_stoi_bounds(clips):
    x, y = clips
    assert TM.stoi(x, x) == pytest.approx(1.0, abs=1e-9)
    assert 0.0 < TM.stoi(x, y) < 1.0
    with pytest.raises(ValueError):
        TM.stoi(x[:200], y[:200])  # shorter than one frame at 10 kHz
    with pytest.raises(ValueError):
        TM.stoi(x[:4000], y[:4000])  # fewer than 30 active frames


def test_metrics_leave_the_tf32_flags(clips, frontends):
    """The metrics never set the process-wide TF32 flags."""
    x, y = clips
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        for flags in ((True, False), (False, True)):
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
            TM.mel_l1(frontends[1], x[None], y[None])
            TM.mrstft(y[None], x[None])
            TM.mcd(frontends[1], x, y)
            assert (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32) == flags
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# -- PESQ's properties (tests/test_pesq.py), on the port's copy --------------

@pytest.fixture(scope="module")
def speech16k():
    return speechlike(16000, 2.0), 16000


def _awgn(x, snr, rng):
    noise = rng.standard_normal(x.size)
    return x + noise * np.sqrt((x ** 2).mean() / (noise ** 2).mean()) * 10 ** (-snr / 20)


def _ceiling(x, fs):
    assert pesq_wb(x, x, fs) > 4.6


def _gain(x, fs):
    base = pesq_wb(x, x, fs)
    assert abs(pesq_wb(x, 0.3 * x, fs) - base) < 0.05
    assert abs(pesq_wb(x, 2.0 * x, fs) - base) < 0.05


def _noise_monotone(x, fs):
    rng = np.random.default_rng(1)
    scores = [pesq_wb(x, _awgn(x, snr, rng), fs) for snr in (40, 25, 10)]
    assert scores[0] > scores[1] > scores[2], scores
    assert scores[2] < 2.5  # 10 dB SNR is plainly bad


def _delay(x, fs):
    """A pure 10 ms delay is not distortion (a codec's algorithmic delay)."""
    assert pesq_wb(x, np.concatenate([np.zeros(160), x]), fs) > 4.5


def _silence(x, fs):
    assert pesq_wb(x, np.zeros_like(x) + 1e-6, fs) < 2.0


PESQ_PROPERTIES = {"ceiling": _ceiling, "gain_invariance": _gain,
                   "monotone_under_noise": _noise_monotone, "delay": _delay,
                   "silence": _silence}


@pytest.mark.parametrize("prop", sorted(PESQ_PROPERTIES))
def test_pesq_property(speech16k, prop):
    PESQ_PROPERTIES[prop](*speech16k)


# -- MUSHRA statistics -------------------------------------------------------

CONDITIONS = ("Reference", "Proposed 1.38", "Proposed 5.51", "Anchor")


@pytest.fixture(scope="module")
def ratings_csv(tmp_path_factory):
    """A synthetic ratings CSV in the dataset's layout: 3 stimuli x 4
    conditions, 6 raters.  Rater 4 rates the hidden reference below 90 in
    two trials (screened out), rater 5 in one (kept)."""
    rng = np.random.default_rng(7)
    base = {"Reference": 97.0, "Proposed 1.38": 55.0, "Proposed 5.51": 62.0, "Anchor": 20.0}
    path = tmp_path_factory.mktemp("mushra") / "ratings_formated_filtered.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["signal", "condition", "ratings", "participant_ids", "file"])
        for s in range(3):
            for cond in CONDITIONS:
                pids = [0, 1, 2, 3, 4, 5]
                r = np.clip(base[cond] + rng.normal(0, 8, len(pids)), 0, 100).round(1)
                if cond == "Reference":
                    r = np.maximum(r, 91.0)
                    if s < 2:
                        r[4] = 60.0
                    if s == 0:
                        r[5] = 80.0
                w.writerow([f"stim_{s:02d}", cond, str([float(v) for v in r]), str(pids),
                            f"audio/stim_{s:02d}/{cond.replace(' ', '_')}.wav"])
    return str(path)


def test_mushra_stats_match_jax(ratings_csv):
    rows, jrows = TMU.load_ratings(ratings_csv), JMU.load_ratings(ratings_csv)
    assert rows == jrows
    assert TMU.condition_stats(rows) == JMU.condition_stats(jrows)
    assert TMU.per_stimulus_means(rows) == JMU.per_stimulus_means(jrows)
    kept, jkept = TMU.filter_participants(rows), JMU.filter_participants(jrows)
    assert kept == jkept
    assert TMU.condition_stats(kept) == JMU.condition_stats(jkept)


def test_mushra_filtering_rule(ratings_csv):
    """Rater 4 (two hidden-reference ratings below 90) goes, rater 5 (one)
    stays, everyone else stays; no rating is changed."""
    rows = TMU.load_ratings(ratings_csv)
    kept = TMU.filter_participants(rows)
    for before, after in zip(rows, kept):
        assert after["participant_ids"] == [0, 1, 2, 3, 5]
        assert after["ratings"] == [r for p, r in zip(before["participant_ids"], before["ratings"])
                                    if p != 4]
    stats = TMU.condition_stats(kept)
    assert stats["Reference"]["n"] == 15
    assert stats["Reference"]["mean"] > stats["Proposed 5.51"]["mean"] > stats["Anchor"]["mean"]


def test_mushra_cli_needs_the_csv():
    """The ratings CSV has no default (the dataset is not in the checkout):
    run without it, the CLI stops with its usage."""
    with pytest.raises(SystemExit, match="RATINGS_CSV"):
        TMU.main(["--screen"])


@pytest.mark.parametrize("screen", [False, True], ids=["pooled", "screened"])
def test_mushra_cli_matches_jax(ratings_csv, capsys, screen):
    """``python -m bvsc_tpu_torch.eval.mushra`` prints what ``bvsc_tpu``'s
    ``main`` prints."""
    argv = ["--screen", ratings_csv] if screen else [ratings_csv]
    JMU.main(argv)
    want = capsys.readouterr().out
    proc = subprocess.run([sys.executable, "-m", "bvsc_tpu_torch.eval.mushra", *argv],
                          capture_output=True, text=True, timeout=120, cwd=REPO,
                          env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == want
    assert ("(participant screening applied)" in want) == screen
