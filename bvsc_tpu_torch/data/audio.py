"""WAV IO and normalization (scipy-backed; no librosa/soundfile deps).

A copy of ``bvsc_tpu/data/audio.py`` (numpy and scipy only), which
re-creates the reference's audio handling
(``third_party/BigVGAN/meldataset.py:19-27,160-163``, ``utils.py:76-80``):
int16 wavs scaled by 32768, peak normalization x0.95.
"""

from __future__ import annotations

import numpy as np
from scipy.io import wavfile

MAX_WAV_VALUE = 32768.0


def load_wav(full_path: str, sr_target: int | None = None):
    """Returns (float waveform in [-1, 1] as written, sampling_rate).

    Raises on sample-rate mismatch like reference ``load_wav``
    (``meldataset.py:22-27``).  Multi-channel files keep channels last.
    """
    sampling_rate, data = wavfile.read(full_path)
    if sr_target is not None and sampling_rate != sr_target:
        raise RuntimeError(
            f"Sampling rate of the file {full_path} is {sampling_rate} Hz, "
            f"but the model requires {sr_target} Hz"
        )
    if data.dtype == np.int16:
        data = data.astype(np.float32) / MAX_WAV_VALUE
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        # 8-bit PCM is offset-binary: 128 is zero
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    return data, sampling_rate


def peak_normalize(audio: np.ndarray) -> np.ndarray:
    """librosa.util.normalize equivalent (inf-norm)."""
    peak = np.abs(audio).max()
    return audio / peak if peak > 0 else audio


def save_wav(audio: np.ndarray, path: str, sr: int) -> None:
    """int16 WAV writing (reference ``utils.py:76-80`` save_audio)."""
    audio = np.clip(np.asarray(audio), -1.0, 1.0)
    wavfile.write(path, sr, (audio * (MAX_WAV_VALUE - 1)).astype(np.int16))
