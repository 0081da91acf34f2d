"""Self-contained PESQ-WB-style perceptual speech-quality metric (numpy).

A copy of ``bvsc_tpu/eval/pesq.py`` (numpy only; the names and constants
are the same, so both packages give the same scores).

The reference validates its vocoder with PESQ wideband (reference
``third_party/BigVGAN/train.py:184-191`` via the ``pesq`` wheel).  That
wheel does not exist in this environment and cannot be installed, so this
module re-creates the ITU-T P.862 / P.862.2 processing structure from the
published algorithm description:

  level alignment -> STFT (32 ms Hann, 50 % overlap at 16 kHz) -> Bark-band
  grouping -> partial frequency compensation (on the reference) and
  short-term gain compensation (on the degraded) -> Zwicker-law loudness ->
  per-band disturbance with the 0.25·min deadzone -> symmetric (L2 over
  bands) and asymmetric (L1 x Bark-ratio^1.2 factor) frame disturbances,
  weighted by frame audible power -> L6-within / L2-across 320 ms interval
  aggregation -> raw score 4.5 − 0.1·D − 0.0309·DA -> the P.862.2 logistic
  MOS-LQO mapping.

HONESTY CONTRACT — what this is and is not:

* It is NOT conformance-tested against the ITU reference implementation:
  no ``pesq`` wheel, ITU test vectors, or network access exist in this
  environment, so exact P.862 constants that live only in the reference C
  tables (the 49 Bark band edges, the absolute-threshold table, the power
  calibration) are re-derived from their published functional forms
  (Zwicker Bark warp, Terhardt threshold-in-quiet) rather than copied.
  Scores are therefore on a PESQ-like scale, not interchangeable with ITU
  PESQ to the second decimal.
* Time alignment is a single constant-delay estimate (cross-correlation
  of envelopes — P.862's crude alignment): this framework's use case is
  codec/vocoder output that is sample-synchronous or constant-delay with
  its input, so P.862's per-utterance splitting / bad-interval
  realignment are deliberately out of scope.
* It IS validated as a *perceptual* metric in this repo: identical
  signals score at the top of the scale, scores degrade monotonically
  with additive noise and with lowpassing (tests/test_pesq.py,
  tests/test_torch_eval.py), and the
  scores rank-correlate strongly with the human MUSHRA means on the
  reference's published listening-test conditions (docs/EVAL.md) —
  stronger than the spectral metrics previously used as PESQ stand-ins.

Use :func:`bvsc_tpu_torch.eval.metrics.pesq_wb_16k`, which prefers the ITU
wheel when one exists and falls back to this implementation.
"""

from __future__ import annotations

import numpy as np

_FS = 16000
_NFFT = 512  # 32 ms
_HOP = 256
_NB = 49  # Bark bands (P.862 wideband count)
_F_LO, _F_HI = 100.0, 7500.0
_TARGET_POWER = 1e7  # active-band level-alignment target (internal units)
_ZWICKER = 0.23


def _bark(f):
    """Zwicker/P.862 Bark warp."""
    f = np.asarray(f, np.float64)
    return 13.0 * np.arctan(7.6e-4 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)


def _threshold_in_quiet_db(f):
    """Terhardt absolute hearing threshold (dB SPL-like)."""
    khz = np.maximum(np.asarray(f, np.float64), 20.0) / 1000.0
    return (3.64 * khz ** -0.8
            - 6.5 * np.exp(-0.6 * (khz - 3.3) ** 2)
            + 1e-3 * khz ** 4)


class _Bands:
    """FFT-bin -> Bark-band grouping at the module constants."""

    def __init__(self):
        freqs = np.fft.rfftfreq(_NFFT, 1.0 / _FS)
        edges = np.linspace(_bark(_F_LO), _bark(_F_HI), _NB + 1)
        zf = _bark(freqs)
        self.index = np.digitize(zf, edges) - 1  # -1 / _NB outside
        self.valid = (self.index >= 0) & (self.index < _NB)
        centers_z = 0.5 * (edges[:-1] + edges[1:])
        # invert the warp numerically for band centre frequencies
        grid = np.linspace(20.0, _FS / 2, 4096)
        self.center_hz = np.interp(centers_z, _bark(grid), grid)
        self.width_z = np.diff(edges)  # uniform by construction
        # per-band absolute threshold, in power units consistent with the
        # level alignment (see pesq_wb: 57 dB headroom below the target)
        thr_db = _threshold_in_quiet_db(self.center_hz)
        self.abs_thresh = 10.0 ** ((thr_db - 57.0) / 10.0) * _TARGET_POWER / 1e7
        self.counts = np.bincount(self.index[self.valid], minlength=_NB)
        self.counts = np.maximum(self.counts, 1)

    def group(self, power_spec):
        """(frames, bins) power -> (frames, _NB) mean band power."""
        out = np.zeros((power_spec.shape[0], _NB))
        idx = self.index[self.valid]
        np.add.at(out.T, idx, power_spec[:, self.valid].T)
        return out / self.counts


_BANDS = None


def _bands() -> _Bands:
    global _BANDS
    if _BANDS is None:
        _BANDS = _Bands()
    return _BANDS


def _frames_power(x):
    """(frames, rfft bins) power spectrum, 32 ms Hann, 50 % overlap."""
    n = (len(x) - _NFFT) // _HOP + 1
    if n < 1:
        raise ValueError("signal shorter than one 32 ms PESQ frame")
    idx = np.arange(_NFFT)[None, :] + _HOP * np.arange(n)[:, None]
    frames = x[idx] * np.hanning(_NFFT)[None, :]
    spec = np.fft.rfft(frames, axis=1)
    return (spec.real ** 2 + spec.imag ** 2) / _NFFT


def _level_align(x):
    """Scale so the 350-3250 Hz band of speech-active frames hits the
    internal target power (P.862's level alignment, simplified to a
    single global gain)."""
    p = _frames_power(x)
    freqs = np.fft.rfftfreq(_NFFT, 1.0 / _FS)
    band = (freqs >= 350) & (freqs <= 3250)
    frame_pow = p[:, band].sum(axis=1)
    # speech-active frames: above 1/1000 of the loudest frame
    active = frame_pow > frame_pow.max() / 1000.0
    mean_pow = frame_pow[active].mean() if active.any() else frame_pow.mean()
    if mean_pow <= 0:
        return p
    return p * (_TARGET_POWER / mean_pow)


def _loudness(band_pow, b: _Bands):
    """Zwicker-law specific loudness per Bark band (sone-like units)."""
    p0 = b.abs_thresh[None, :]
    s = (2.0 * p0) ** _ZWICKER * (
        np.maximum(0.5 + 0.5 * band_pow / p0, 0.5) ** _ZWICKER - 1.0
    )
    return np.maximum(s, 0.0)


def disturbances(ref: np.ndarray, deg: np.ndarray, fs: int) -> tuple[float, float]:
    """(D, DA): aggregated symmetric and asymmetric disturbances of the
    P.862 perceptual model (the two numbers the MOS mapping consumes).
    """
    import scipy.signal

    ref = np.asarray(ref, np.float64).reshape(-1)
    deg = np.asarray(deg, np.float64).reshape(-1)
    n = min(ref.size, deg.size)
    ref, deg = ref[:n], deg[:n]
    if fs != _FS:
        ref = scipy.signal.resample_poly(ref, _FS, fs)
        deg = scipy.signal.resample_poly(deg, _FS, fs)

    # constant-delay compensation (P.862's crude alignment, without the
    # per-utterance refinement): codecs under test may carry algorithmic
    # delay (the published MUSHRA condition wavs measure up to ~300
    # samples); a constant shift must not read as distortion
    lag = int(np.argmax(np.abs(
        scipy.signal.fftconvolve(deg, ref[::-1], mode="full")
    ))) - (ref.size - 1)
    if lag > 0:
        deg = deg[lag:]
    elif lag < 0:
        ref = ref[-lag:]
    n = min(ref.size, deg.size)
    ref, deg = ref[:n], deg[:n]

    b = _bands()
    pr = _level_align(ref)
    pd = _level_align(deg)
    n_frames = min(pr.shape[0], pd.shape[0])
    pr, pd = pr[:n_frames], pd[:n_frames]
    br = b.group(pr)  # (T, NB) band powers
    bd = b.group(pd)

    # --- partial frequency compensation (applied to the reference) -------
    # mean band power over frames where the band is audible; ratio clipped
    # to +-20 dB (P.862 compensates the reference towards the degraded
    # spectrum so a pure spectral tilt is only partially penalised)
    audible = br > b.abs_thresh[None, :]
    num = np.where(audible, bd, 0.0).sum(axis=0) + 1e3
    den = np.where(audible, br, 0.0).sum(axis=0) + 1e3
    comp = np.clip(num / den, 0.01, 100.0)
    br_c = br * comp[None, :]

    # --- short-term gain compensation (applied to the degraded) ----------
    # per-frame audible-power ratio, first-order smoothed, clipped
    apr = (br_c * (br_c > b.abs_thresh)).sum(axis=1) + 1e5
    apd = (bd * (bd > b.abs_thresh)).sum(axis=1) + 1e5
    gain = apr / apd
    sm = np.empty_like(gain)
    g = 1.0
    for t in range(gain.size):  # short loop over frames
        g = 0.8 * g + 0.2 * gain[t]
        sm[t] = g
    bd_c = bd * np.clip(sm, 3e-4, 5.0)[:, None]

    # --- loudness + disturbance -------------------------------------------
    lr = _loudness(br_c, b)
    ld = _loudness(bd_c, b)
    d = ld - lr
    dead = 0.25 * np.minimum(ld, lr)
    d_abs = np.maximum(np.abs(d) - dead, 0.0)

    # asymmetry factor: additive distortions hurt more than omissions
    h = ((bd_c + 50.0) / (br_c + 50.0)) ** 1.2
    h = np.where(h < 3.0, 0.0, np.minimum(h, 12.0))

    w = b.width_z[None, :]
    d_sym = np.sqrt((w * d_abs ** 2).sum(axis=1))  # L2 over bands
    d_asym = (w * d_abs * h).sum(axis=1)  # weighted L1

    # frame weighting by audible power (quiet frames matter less)
    weight = ((apr + 1e5) / 1e7) ** 0.04
    d_sym = np.minimum(d_sym / weight, 45.0)
    d_asym = np.minimum(d_asym / weight, 45.0)

    def aggregate(fd):
        # L6 within 320 ms intervals (20 frames), L2 across intervals
        step = 20
        pads = (-len(fd)) % step
        v = np.pad(fd, (0, pads)).reshape(-1, step)
        l6 = (np.mean(v ** 6, axis=1)) ** (1 / 6)
        return float(np.sqrt(np.mean(l6 ** 2)))

    return aggregate(d_sym), aggregate(d_asym)


# Published P.862 raw-score slopes.  Our re-derived loudness scale lands in
# the same numeric range as the ITU tables (validated absolute behavior:
# identical -> 4.64 ceiling, AWGN 20 dB -> ~2.5, GAN codecs ~2.2-2.6 —
# plausible ITU-PESQ magnitudes), so the published slopes are kept.  A
# refit against the human MUSHRA means was attempted and REJECTED
# (scripts/validate_pesq.py): the listening-test conditions are all
# generative codecs, for which PESQ-style loudness-difference models are
# documented to misrank ACROSS codec families (the reason the reference
# ran a MUSHRA test at all); fitting to that data degenerates (a -> 0).
# Within each family the disturbances order correctly — see the
# validation artifact docs/artifacts/pesq_validation.json.
_SLOPE_D = 0.1
_SLOPE_DA = 0.0309


def pesq_wb(ref: np.ndarray, deg: np.ndarray, fs: int) -> float:
    """PESQ-WB-style MOS-LQO in [1.02, 4.64] for time-aligned signals.

    ref/deg: 1-D float waveforms at ``fs`` (resampled to 16 kHz here).
    See the module docstring for the conformance caveats.
    """
    d_total, da_total = disturbances(ref, deg, fs)
    raw = 4.5 - _SLOPE_D * d_total - _SLOPE_DA * da_total
    # P.862.2 wideband logistic mapping to MOS-LQO
    return float(0.999 + 4.0 / (1.0 + np.exp(-1.3669 * raw + 3.8224)))
