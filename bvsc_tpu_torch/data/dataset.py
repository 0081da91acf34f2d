"""Filelist-driven audio segment dataset for the trainers.

A copy of ``bvsc_tpu/data/dataset.py`` (numpy and scipy only): for the same
seed it yields bitwise the JAX package's batches.  Host-side numpy
re-creation of the reference ``MelDataset``
(``third_party/BigVGAN/meldataset.py:120-223``): the dataset yields raw
audio segments and the trainers compute mels on the device.  The
fine-tuning mode (training the vocoder on BVRNN-decoded mels, reference
``meldataset.py:197-214``) instead loads precomputed ``.npy`` mels and yields
them alongside the audio.

No torch DataLoader: a seeded numpy sampler + per-host sharding replaces
``DistributedSampler`` (reference ``train.py:108``); each host reads only its
shard of the filelist.
"""

from __future__ import annotations

import math
import os
import random
from typing import Iterator

import numpy as np

from bvsc_tpu_torch.data.audio import load_wav, peak_normalize


def get_dataset_filelist(
    input_training_file: str,
    input_validation_file: str,
    input_wavs_dir: str,
    list_input_unseen_validation_file=(),
    list_input_unseen_wavs_dir=(),
):
    """Pipe-separated filelists -> wav paths (reference ``meldataset.py:98-117``)."""

    def read_list(path, wavs_dir):
        with open(path, encoding="utf-8") as fi:
            return [
                os.path.join(wavs_dir, x.split("|")[0] + ".wav")
                for x in fi.read().split("\n")
                if len(x) > 0
            ]

    training_files = read_list(input_training_file, input_wavs_dir)
    validation_files = read_list(input_validation_file, input_wavs_dir)
    unseen = [
        read_list(f, d)
        for f, d in zip(list_input_unseen_validation_file, list_input_unseen_wavs_dir)
    ]
    return training_files, validation_files, unseen


class AudioSegmentDataset:
    """Random fixed-length segments for GAN/VAE training.

    split=True: random ``segment_size`` crops (zero-padded if short).
    split=False: full files trimmed to a hop multiple (validation mode).
    """

    def __init__(
        self,
        audio_files: list[str],
        segment_size: int,
        sampling_rate: int,
        hop_size: int,
        *,
        split: bool = True,
        shuffle: bool = True,
        seed: int = 1234,
        normalize: bool = True,
        fine_tuning: bool = False,
        base_mels_path: str | None = None,
        check_integrity: bool = True,
        n_cache_reuse: int = 1,
        augment: dict | None = None,
    ):
        """augment (train-split only; the reference has no augmentation):
        optional dict enabling on-the-fly waveform augmentation per fetch.
        Always-on keys (value = (lo, hi) uniform range):
          ``speed``: polyphase resample by a random factor (rational p/100
            approximation; changes duration AND pitch — classic speed
            perturbation),
          ``gain_db``: random gain (a constant shift of the log-mel —
            counters overfitting of the frozen mel statistics).
        Probability-gated keys (each ``<name>`` has a ``<name>_p``
        probability, default 0.5/0.3/0.3):
          ``noise_snr_db``: additive white Gaussian noise at a random SNR,
          ``reverb_rt60``: convolve with a synthetic exponentially-decaying
            noise RIR of random RT60 seconds (direct path preserved; output
            re-peaked to the dry level),
          ``pitch_semitones``: pitch shift WITHOUT duration change
            (polyphase resample + WSOLA time-stretch back) — decorrelates
            pitch from timing, unlike ``speed`` which moves both."""
        self.audio_files = list(audio_files)
        rng = random.Random(seed)
        if shuffle:
            rng.shuffle(self.audio_files)
        self.segment_size = segment_size
        self.sampling_rate = sampling_rate
        self.hop_size = hop_size
        self.split = split
        self.normalize = normalize
        self.fine_tuning = fine_tuning
        self.base_mels_path = base_mels_path
        self._rng = np.random.default_rng(seed)
        self.augment = dict(augment) if augment else None
        if self.augment:
            unknown = set(self.augment) - {
                "speed", "gain_db",
                "noise_snr_db", "noise_p",
                "reverb_rt60", "reverb_p",
                "pitch_semitones", "pitch_p",
            }
            if unknown:
                raise ValueError(f"unknown augment keys {sorted(unknown)}")
        # wav cache (reference meldataset.py:145-171): serve the same decoded
        # wav for n_cache_reuse consecutive fetches (different random crops),
        # trading sample diversity for disk-read throughput.  1 = off.
        # Disabled in fine_tuning mode: the cache is filename-agnostic and
        # would pair file A's audio with file B's .npy mel (the reference has
        # the same hazard; deliberately not replicated).
        self.n_cache_reuse = 1 if fine_tuning else max(1, int(n_cache_reuse))
        self._cached_wav: np.ndarray | None = None
        self._cache_ref_count = 0
        if check_integrity:  # reference meldataset.py:152-154
            for f in self.audio_files:
                assert os.path.exists(f), f"{f} not found"

    def __len__(self):
        return len(self.audio_files)

    def _load(self, filename: str) -> np.ndarray:
        if self._cache_ref_count > 0 and self._cached_wav is not None:
            self._cache_ref_count -= 1
            return self._cached_wav
        audio, sr = load_wav(filename, self.sampling_rate)
        if audio.ndim > 1:
            audio = audio[:, 0]
        if self.normalize and not self.fine_tuning:
            audio = peak_normalize(audio) * 0.95  # reference meldataset.py:163
        audio = audio.astype(np.float32)
        if self.n_cache_reuse > 1:
            self._cached_wav = audio
            self._cache_ref_count = self.n_cache_reuse - 1
        return audio

    def __getitem__(self, index: int):
        filename = self.audio_files[index]
        audio = self._load(filename)

        if self.fine_tuning:
            mel_path = os.path.join(
                self.base_mels_path,
                os.path.splitext(os.path.split(filename)[-1])[0] + ".npy",
            )
            mel = np.load(mel_path)
            if mel.ndim == 3:
                mel = mel[0]
            # mel: (num_mels, frames)
            if self.split:
                frames_per_seg = math.ceil(self.segment_size / self.hop_size)
                if audio.shape[0] >= self.segment_size and mel.shape[1] >= frames_per_seg:
                    # endpoint=True: a mel exactly frames_per_seg long is a
                    # valid zero-offset crop (reference meldataset.py has the
                    # same off-by-one crash; deliberately not replicated)
                    start = int(
                        self._rng.integers(0, mel.shape[1] - frames_per_seg, endpoint=True)
                    )
                    mel = mel[:, start : start + frames_per_seg]
                    audio = audio[
                        start * self.hop_size : (start + frames_per_seg) * self.hop_size
                    ]
                else:
                    mel = np.pad(mel, ((0, 0), (0, max(0, frames_per_seg - mel.shape[1]))))[
                        :, :frames_per_seg
                    ]
                    # pad to frames_per_seg * hop like the crop branch — a
                    # segment_size that is not a hop multiple would
                    # otherwise produce ragged batches (crop yields
                    # ceil(seg/hop)*hop samples, pad yielded seg)
                    target = frames_per_seg * self.hop_size
                    audio = np.pad(audio, (0, max(0, target - audio.shape[0])))[
                        :target
                    ]
            return audio, mel, filename

        if self.split:
            audio = self._apply_augment(audio)
            if audio.shape[0] >= self.segment_size:
                start = int(self._rng.integers(0, audio.shape[0] - self.segment_size + 1))
                audio = audio[start : start + self.segment_size]
            else:
                audio = np.pad(audio, (0, self.segment_size - audio.shape[0]))
        else:
            if audio.shape[0] % self.hop_size:
                audio = audio[: -(audio.shape[0] % self.hop_size)]
        return audio, None, filename

    def _apply_augment(self, audio: np.ndarray) -> np.ndarray:
        if not self.augment:
            return audio
        speed = self.augment.get("speed")
        if speed:
            f = float(self._rng.uniform(*speed))
            p = max(1, int(round(f * 100)))  # rational f ~= p/100
            if p != 100:
                import scipy.signal

                # playback f times faster => length / f => up=100, down=p
                audio = scipy.signal.resample_poly(
                    audio.astype(np.float64), 100, p
                ).astype(np.float32)
        pitch = self.augment.get("pitch_semitones")
        if pitch and self._rng.uniform() < self.augment.get("pitch_p", 0.3):
            from bvsc_tpu_torch.data.augment import pitch_shift

            audio = pitch_shift(audio, float(self._rng.uniform(*pitch)))
        rt60 = self.augment.get("reverb_rt60")
        if rt60 and self._rng.uniform() < self.augment.get("reverb_p", 0.3):
            from bvsc_tpu_torch.data.augment import synthetic_reverb

            audio = synthetic_reverb(
                audio, float(self._rng.uniform(*rt60)), self.sampling_rate,
                self._rng,
            )
        snr = self.augment.get("noise_snr_db")
        if snr and self._rng.uniform() < self.augment.get("noise_p", 0.5):
            from bvsc_tpu_torch.data.augment import add_noise_snr

            audio = add_noise_snr(audio, float(self._rng.uniform(*snr)),
                                  self._rng)
        gain_db = self.augment.get("gain_db")
        if gain_db:
            audio = audio * np.float32(
                10.0 ** (self._rng.uniform(*gain_db) / 20.0)
            )
        return audio

    def batches(
        self, batch_size: int, *, host_id: int = 0, num_hosts: int = 1,
        drop_last: bool = True, epochs: int | None = None,
    ) -> Iterator[np.ndarray]:
        """Infinite (or ``epochs``-bounded) shuffled batch iterator over this
        host's shard — the DistributedSampler replacement."""
        files = self.audio_files[host_id::num_hosts]
        if not files:
            raise ValueError(
                f"host {host_id}/{num_hosts} has an empty filelist shard"
            )
        # files[j] == audio_files[host_id + j*num_hosts] by the stride
        # slice above — arithmetic beats a path->index dict, which would
        # also collapse deliberately duplicated (oversampled) entries
        epoch = 0
        while epochs is None or epoch < epochs:
            order = self._rng.permutation(len(files))
            if drop_last and len(files) < batch_size:
                # Fewer files than the batch: tile reshuffled permutations so
                # every epoch still yields full batches (each entry gets an
                # independent random crop).  Without this, drop_last would
                # yield NOTHING and the epoch loop would spin forever.
                reps = -(-batch_size // len(files))
                order = np.concatenate(
                    [order] + [self._rng.permutation(len(files))
                               for _ in range(reps - 1)]
                )
            for i in range(0, len(order) - (batch_size - 1 if drop_last else 0), batch_size):
                chunk = order[i : i + batch_size]
                if drop_last and len(chunk) < batch_size:
                    break
                items = [self[host_id + int(j) * num_hosts] for j in chunk]
                audio = np.stack([it[0] for it in items])
                if self.fine_tuning:
                    mel = np.stack([it[1] for it in items])
                    yield audio, mel
                else:
                    yield audio, None
            epoch += 1
