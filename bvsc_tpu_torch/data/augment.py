"""Waveform augmentation for tiny-corpus training.

A copy of ``bvsc_tpu/data/augment.py`` (numpy and scipy only; the port
imports nothing of ``bvsc_tpu``): for the same seed its outputs are
bitwise the JAX package's.

The reference trains on full corpora (VCTK/LibriTTS-scale) and ships no
augmentation; in this environment only ~41 s of speech exists, so the
trainers expose an augmentation tier instead (``AudioSegmentDataset
(augment=...)``).  All functions are host-side numpy.

Three transforms beyond the speed/gain pair:
  * :func:`add_noise_snr` — additive white Gaussian noise at a target SNR,
  * :func:`synthetic_reverb` — convolution with a synthetic RIR
    (exponentially-decaying white noise, the classic image-method stand-in;
    direct path preserved, output re-peaked to the dry level),
  * :func:`pitch_shift` — pitch WITHOUT duration change: polyphase resample
    (moves pitch and duration) + WSOLA time-stretch back (restores
    duration, preserves pitch) — decorrelates f0 from timing, which plain
    speed perturbation cannot.
"""

from __future__ import annotations

import numpy as np


def add_noise_snr(audio: np.ndarray, snr_db: float,
                  rng: np.random.Generator) -> np.ndarray:
    """Additive white Gaussian noise at ``snr_db`` vs the signal power."""
    sig_pow = float(np.mean(np.square(audio, dtype=np.float64)))
    if sig_pow <= 0.0:
        return audio
    noise_pow = sig_pow / (10.0 ** (snr_db / 10.0))
    noise = rng.standard_normal(audio.shape[0]) * np.sqrt(noise_pow)
    return (audio + noise).astype(np.float32)


def synthetic_reverb(audio: np.ndarray, rt60: float, fs: int,
                     rng: np.random.Generator) -> np.ndarray:
    """Convolve with a synthetic room impulse response.

    RIR model: unit direct path + white noise with an exponential envelope
    decaying 60 dB over ``rt60`` seconds (ln(1000) ~ 6.908), scaled so the
    tail carries ~half the direct-path energy (a moderately live room).
    The wet signal is re-peaked to the dry peak so downstream level
    statistics are unchanged.
    """
    import scipy.signal

    n = max(1, int(rt60 * fs))
    t = np.arange(n, dtype=np.float64) / fs
    tail = rng.standard_normal(n) * np.exp(-6.908 * t / rt60)
    e = float(np.sum(tail * tail))
    if e > 0:
        tail *= np.sqrt(0.5 / e)
    rir = np.zeros(n + 1)
    rir[0] = 1.0
    rir[1:] = tail
    wet = scipy.signal.fftconvolve(audio.astype(np.float64), rir)[
        : audio.shape[0]
    ]
    dry_peak = float(np.max(np.abs(audio)))
    wet_peak = float(np.max(np.abs(wet)))
    if wet_peak > 0 and dry_peak > 0:
        wet *= dry_peak / wet_peak
    return wet.astype(np.float32)


def wsola_stretch(audio: np.ndarray, factor: float, *, frame: int = 512,
                  search: int = 128) -> np.ndarray:
    """WSOLA time stretch: output length ~ ``factor * len(audio)``, pitch
    preserved.

    Standard waveform-similarity overlap-add: synthesis frames advance by
    ``hs = frame/2`` with a Hann window; each analysis frame is picked
    within ``+-search`` samples of its nominal position ``k*hs/factor`` to
    maximize cross-correlation with the natural continuation of the
    previous frame (the segment that WOULD have followed it in the input),
    so the overlap-add stays phase-coherent.
    """
    x = np.asarray(audio, np.float64)
    if abs(factor - 1.0) < 1e-4 or x.shape[0] < 2 * frame + 2 * search:
        return np.asarray(audio, np.float32)
    hs = frame // 2
    ha = hs / factor
    win = np.hanning(frame)
    n_out = int(x.shape[0] * factor)
    out = np.zeros(n_out + frame)
    norm = np.zeros(n_out + frame)

    prev = 0  # analysis start of the previous frame
    k = 0
    while True:
        pos_out = k * hs
        if pos_out + frame > n_out:
            break
        nominal = int(round(k * ha))
        if k == 0:
            start = 0
        else:
            # natural continuation of the previous frame
            nat0 = prev + hs
            target = x[nat0 : nat0 + frame]
            lo = max(0, nominal - search)
            hi = min(x.shape[0] - frame, nominal + search)
            if hi <= lo or target.shape[0] < frame:
                start = min(max(nominal, 0), x.shape[0] - frame)
            else:
                region = x[lo : hi + frame]
                # 'valid' cross-correlation: one dot per candidate offset
                cc = np.correlate(region, target, mode="valid")
                start = lo + int(np.argmax(cc[: hi - lo + 1]))
        seg = x[start : start + frame]
        if seg.shape[0] < frame:
            break
        out[pos_out : pos_out + frame] += seg * win
        norm[pos_out : pos_out + frame] += win
        prev = start
        k += 1

    out = out[:n_out] / np.maximum(norm[:n_out], 1e-3)
    return out.astype(np.float32)


def pitch_shift(audio: np.ndarray, semitones: float) -> np.ndarray:
    """Shift pitch by ``semitones`` keeping duration (within one frame).

    factor f = 2^(semitones/12): polyphase-resample the signal to length/f
    (pitch * f, duration / f), then WSOLA-stretch by f back to the original
    duration.  The result is trimmed/zero-padded to exactly ``len(audio)``.
    """
    import scipy.signal

    f = 2.0 ** (semitones / 12.0)
    p = max(1, int(round(f * 1000)))  # rational f ~= p/1000
    if p == 1000:
        return np.asarray(audio, np.float32)
    fast = scipy.signal.resample_poly(
        np.asarray(audio, np.float64), 1000, p
    )
    out = wsola_stretch(fast.astype(np.float32),
                        audio.shape[0] / max(1, fast.shape[0]))
    if out.shape[0] < audio.shape[0]:
        out = np.pad(out, (0, audio.shape[0] - out.shape[0]))
    return out[: audio.shape[0]]
