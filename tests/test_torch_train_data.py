"""The port's training data pipeline and checkpoints: ``data.augment`` and
``data.dataset`` bitwise ``bvsc_tpu``'s for the same seed (split,
validation and fine-tuning modes, augmentation, the wav cache, host
shards), and ``train.checkpoint``'s names, scan and restore."""

import os
import pickle

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from bvsc_tpu.data import augment as JA
from bvsc_tpu.data import dataset as JD
from bvsc_tpu_torch.data import augment as TA
from bvsc_tpu_torch.data import dataset as TD
from bvsc_tpu_torch.train import checkpoint as ckpt
from bvsc_tpu_torch.utils.logging import TrainLogger

torch.set_num_threads(1)

SR = 22050
FULL_AUG = {"speed": (0.85, 1.15), "gain_db": (-10.0, 0.0), "noise_snr_db": (8.0, 30.0),
            "noise_p": 0.5, "reverb_rt60": (0.1, 0.4), "reverb_p": 0.3,
            "pitch_semitones": (-2.0, 2.0), "pitch_p": 0.3}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Five seeded wavs of different lengths (one shorter than a segment),
    their fine-tuning .npy mels and a filelist."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    files = []
    for i, n in enumerate((9000, 3000, 12000, 7000, 20000)):
        t = np.arange(n) / SR
        x = 0.4 * np.sin(2 * np.pi * (150 + 40 * i) * t) + 0.05 * rng.standard_normal(n)
        path = str(root / f"w{i}.wav")
        wavfile.write(path, SR, (x * 20000).astype(np.int16))
        np.save(str(root / f"w{i}.npy"), rng.standard_normal((8, n // 256 + 1)).astype(np.float32))
        files.append(path)
    (root / "train.txt").write_text("".join(f"w{i}|text\n" for i in range(5)))
    return str(root), files


def test_augment_bitwise():
    x = (np.random.default_rng(1).standard_normal(6000) * 0.3).astype(np.float32)
    for fn in (lambda m, r: m.add_noise_snr(x, 12.0, r),
               lambda m, r: m.synthetic_reverb(x, 0.25, SR, r)):
        np.testing.assert_array_equal(fn(TA, np.random.default_rng(5)),
                                      fn(JA, np.random.default_rng(5)))
    np.testing.assert_array_equal(TA.wsola_stretch(x, 1.1), JA.wsola_stretch(x, 1.1))
    for semitones in (-2.0, 1.3):
        np.testing.assert_array_equal(TA.pitch_shift(x, semitones), JA.pitch_shift(x, semitones))


def test_filelist(corpus):
    root, _ = corpus
    lst = os.path.join(root, "train.txt")
    assert TD.get_dataset_filelist(lst, lst, root, [lst], [root]) == \
        JD.get_dataset_filelist(lst, lst, root, [lst], [root])


def _batches(mod, files, n, **kw):
    batch_kw = {k: kw.pop(k) for k in ("host_id", "num_hosts") if k in kw}
    ds = mod.AudioSegmentDataset(files, 4096, SR, 256, **kw)
    it = ds.batches(3, **batch_kw)
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("kw", [
    {},
    {"augment": FULL_AUG},
    {"n_cache_reuse": 2, "seed": 7},
    {"host_id": 1, "num_hosts": 2},
], ids=["split", "augment_full", "wav_cache", "host_shard"])
def test_batches_bitwise(corpus, kw):
    _, files = corpus
    got = _batches(TD, files, 4, **dict(kw))
    ref = _batches(JD, files, 4, **dict(kw))
    for (a, ma), (b, mb) in zip(got, ref):
        assert ma is None and mb is None
        np.testing.assert_array_equal(a, b)
        assert a.shape == (3, 4096)


def test_fine_tuning_batches_bitwise(corpus):
    root, files = corpus
    got = _batches(TD, files, 3, fine_tuning=True, base_mels_path=root)
    ref = _batches(JD, files, 3, fine_tuning=True, base_mels_path=root)
    for (a, ma), (b, mb) in zip(got, ref):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ma, mb)
        assert ma.shape == (3, 8, 16)


def test_validation_items_bitwise(corpus):
    _, files = corpus
    t = TD.AudioSegmentDataset(files, 4096, SR, 256, split=False, shuffle=False)
    j = JD.AudioSegmentDataset(files, 4096, SR, 256, split=False, shuffle=False)
    for i in range(len(files)):
        a, _, fa = t[i]
        b, _, fb = j[i]
        assert fa == fb and a.shape[0] % 256 == 0
        np.testing.assert_array_equal(a, b)


def test_checkpoint_names_scan_and_restore(tmp_path):
    d = str(tmp_path)
    assert ckpt.checkpoint_name("g_", 50000) == "g_00050000"
    assert ckpt.scan_checkpoint(d, "g_") is None
    assert ckpt.restore_latest(d, "g_") == (None, 0)
    for step in (2, 10, 7):
        ckpt.save_step(d, "g_", step, {"step": step, "params": {"a/0/w": torch.full((2,), step)}})
    (tmp_path / "g_0000000x").write_text("not a checkpoint")
    ckpt.save_step(d, "do_", 99, {"step": 99})
    latest = ckpt.scan_checkpoint(d, "g_")
    assert latest == os.path.join(d, "g_00000010") and ckpt.step_of(latest) == 10
    state, step = ckpt.restore_latest(d, "g_")
    assert step == 10 and state["step"] == 10
    assert torch.equal(state["params"]["a/0/w"], torch.full((2,), 10))
    assert not any(f.endswith(".tmp") for f in os.listdir(d))


def test_checkpoint_loads_weights_only(tmp_path):
    """A checkpoint holding anything but tensors and plain data is refused."""
    import argparse

    path = str(tmp_path / "bad_00000001")
    torch.save({"x": argparse.Namespace(a=1)}, path)
    with pytest.raises(pickle.UnpicklingError):
        ckpt.load(path)


def test_logger_without_a_directory_is_silent():
    log = TrainLogger(None)
    log.scalar("a", 1.0, 0)
    log.scalars({"b": 2.0}, 0)
    log.audio("c", np.zeros(4), 0, SR)
    log.spectrogram_figure("d", np.zeros((2, 2)), 0)
    log.flush()
