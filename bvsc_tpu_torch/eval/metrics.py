"""Objective quality metrics (port of ``bvsc_tpu/eval/metrics.py``), the
reference's validation metrics (``third_party/BigVGAN/train.py:150-227``):
L1 mel error, multi-resolution STFT loss, PESQ-WB at 16 kHz (the ITU
``pesq`` wheel when installed, else the self-contained model in
:mod:`bvsc_tpu_torch.eval.pesq`), plus STOI and mel-cepstral distortion.

``mel_l1`` and ``mrstft`` run in torch on whatever device their tensors
(or the frontend) live on; ``snr_db``, ``stoi`` and PESQ are numpy and
scipy on the host, copies of the JAX package's; ``mcd`` takes the
frontend's log-mel on its device and moves it to the host once per clip
for the DCT.  None of them touches the TF32 flags.
"""

from __future__ import annotations

import numpy as np
import torch

from bvsc_tpu_torch.ops.mel import MelFrontend
from bvsc_tpu_torch.ops.stft_loss import multi_resolution_stft_loss


def frontend_for(conf, device=None) -> MelFrontend:
    """The mel frontend of a codec config (``config.CodecConfig``) on
    ``device`` (default the CUDA card): the codec's own, unscaled."""
    return MelFrontend(sampling_rate=conf.fs, n_fft=conf.winsize, num_mels=conf.num_mels,
                       hop_size=conf.hopsize, fmin=conf.fmin, fmax=conf.fmax,
                       padding_left=conf.mel_pad_left, device=device)


def _tensor(x, device) -> torch.Tensor:
    """A waveform (tensor or array) as a float32 tensor on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = np.array(x, np.float32)  # a copy: the caller's array may be read-only
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def mel_l1(frontend: MelFrontend, y, y_hat) -> float:
    """Mean |mel(y) - mel(y_hat)| over (B, L) waveforms (reference
    ``train.py:179-182``), on the frontend's device."""
    dev = frontend.window.device
    with torch.no_grad():
        return float(torch.mean(torch.abs(frontend(_tensor(y, dev)) - frontend(_tensor(y_hat, dev)))))


def mrstft(y_hat, y) -> float:
    """auraloss-style MRSTFT of (B, L) waveforms (reference ``train.py:161,194``),
    on ``y_hat``'s device when it is a tensor."""
    dev = y_hat.device if isinstance(y_hat, torch.Tensor) else "cpu"
    with torch.no_grad():
        return float(multi_resolution_stft_loss(_tensor(y_hat, dev), _tensor(y, dev)))


def snr_db(ref: np.ndarray, test: np.ndarray) -> float:
    ref, test = np.asarray(ref), np.asarray(test)
    err = ref - test
    return float(10 * np.log10((ref**2).mean() / max((err**2).mean(), 1e-20)))


def stoi(ref: np.ndarray, deg: np.ndarray, fs: int = 22050) -> float:
    """Short-Time Objective Intelligibility (Taal et al., ICASSP 2010 /
    IEEE TASLP 2011), implemented from the paper, no external package:
    10 kHz resample, 40 dB silent-frame removal driven by the clean signal,
    512-pt STFT of 256-sample Hann frames (hop 128), 15 one-third-octave
    bands from 150 Hz, 384 ms (N=30 frame) segments, per-band energy
    normalization with a -15 dB signal-distortion-ratio clip, then the mean
    band/segment correlation.

    Returns a value in roughly [0, 1] (1.0 for identical signals); raises
    ValueError if fewer than 30 active frames survive silence removal.

    One documented simplification vs the original MATLAB: silence removal
    keeps the windowed active frames directly for the STFT instead of
    overlap-adding and re-framing (both approximate the signal near the
    removed-frame boundaries; this one is simpler and exactly invariant to
    degraded-signal scaling).
    """
    import scipy.signal

    FS = 10000
    FRAME, HOP, NFFT = 256, 128, 512
    NBANDS, CF0, NSEG = 15, 150.0, 30
    DYN_RANGE, BETA_DB = 40.0, -15.0

    x = np.asarray(ref, np.float64).reshape(-1)
    y = np.asarray(deg, np.float64).reshape(-1)
    if x.shape != y.shape:
        raise ValueError(f"length mismatch {x.shape} vs {y.shape}")
    if fs != FS:
        g = np.gcd(FS, fs)
        x = scipy.signal.resample_poly(x, FS // g, fs // g)
        y = scipy.signal.resample_poly(y, FS // g, fs // g)
    if len(x) < FRAME:
        raise ValueError(
            f"clip too short for STOI: {len(x)} samples at {FS} Hz "
            f"(< one {FRAME}-sample frame)"
        )

    win = np.hanning(FRAME + 2)[1:-1]

    def frame_sig(s):
        n = 1 + max(0, (len(s) - FRAME)) // HOP
        idx = np.arange(FRAME)[None, :] + HOP * np.arange(n)[:, None]
        return s[idx] * win

    xf, yf = frame_sig(x), frame_sig(y)
    # silent-frame removal: keep frames of the CLEAN signal within 40 dB of
    # its loudest frame; apply the same mask to both signals
    energy = 20 * np.log10(np.linalg.norm(xf, axis=1) + 1e-12)
    keep = energy > energy.max() - DYN_RANGE
    xf, yf = xf[keep], yf[keep]
    if xf.shape[0] < NSEG:
        raise ValueError(
            f"only {xf.shape[0]} active frames after silence removal; "
            f"STOI needs >= {NSEG}"
        )

    X = np.abs(np.fft.rfft(xf, NFFT, axis=1)) ** 2  # (M, 257) power
    Y = np.abs(np.fft.rfft(yf, NFFT, axis=1)) ** 2
    freqs = np.arange(NFFT // 2 + 1) * FS / NFFT
    obm = np.zeros((NBANDS, NFFT // 2 + 1))
    for k in range(NBANDS):
        cf = CF0 * 2.0 ** (k / 3.0)
        obm[k] = (freqs >= cf * 2.0 ** (-1 / 6)) & (freqs < cf * 2.0 ** (1 / 6))
    Xb = np.sqrt(X @ obm.T).T  # (15, M) band magnitudes
    Yb = np.sqrt(Y @ obm.T).T

    M = Xb.shape[1]
    # all N=30-frame segments, shape (segments, bands, N)
    seg_idx = np.arange(NSEG)[None, :] + np.arange(M - NSEG + 1)[:, None]
    xs = Xb.T[seg_idx].transpose(0, 2, 1)
    ys = Yb.T[seg_idx].transpose(0, 2, 1)

    eps = np.finfo(np.float64).eps
    alpha = np.linalg.norm(xs, axis=2, keepdims=True) / (
        np.linalg.norm(ys, axis=2, keepdims=True) + eps
    )
    ys = np.minimum(ys * alpha, xs * (1 + 10.0 ** (BETA_DB / 20.0)))

    xs = xs - xs.mean(axis=2, keepdims=True)
    ys = ys - ys.mean(axis=2, keepdims=True)
    num = (xs * ys).sum(axis=2)
    den = np.linalg.norm(xs, axis=2) * np.linalg.norm(ys, axis=2) + eps
    return float((num / den).mean())


def mcd(frontend: MelFrontend, ref, deg, n_coeffs: int = 13) -> float:
    """Mel-cepstral distortion in dB (Kubichek 1993), frame-aligned.

    Mel-cepstra are the orthonormal DCT-II of the log-mel spectrogram (the
    codec's own frontend, on its device; each clip's log-mel comes to the
    host once); coefficients 1..n_coeffs (c0 excluded, so the metric is
    gain-invariant) enter ``(10 sqrt(2) / ln 10) * mean_t ||c_ref(t) -
    c_deg(t)||``.  Signals are assumed time-aligned (a codec's output is
    sample-synchronous with its input), so no DTW is applied.  Lower is
    better, ~0 for identical signals.
    """
    import scipy.fft

    dev = frontend.window.device
    with torch.no_grad():
        x = frontend(_tensor(ref, dev).reshape(1, -1))[0].cpu().numpy()  # (M, T)
        y = frontend(_tensor(deg, dev).reshape(1, -1))[0].cpu().numpy()
    cx = scipy.fft.dct(x, type=2, axis=0, norm="ortho")[1 : n_coeffs + 1]
    cy = scipy.fft.dct(y, type=2, axis=0, norm="ortho")[1 : n_coeffs + 1]
    dist = np.sqrt(((cx - cy) ** 2).sum(axis=0))
    return float((10.0 * np.sqrt(2.0) / np.log(10.0)) * dist.mean())


def pesq_wb_16k(ref_22k: np.ndarray, test_22k: np.ndarray, fs: int = 22050):
    """PESQ wideband at 16 kHz (reference ``train.py:184-191``).

    Prefers the ITU-conformant ``pesq`` wheel when one is installed; falls
    back to the self-contained P.862.2-style model
    (:mod:`bvsc_tpu_torch.eval.pesq`, whose docstring states its
    conformance caveats)."""
    import scipy.signal

    ref16 = scipy.signal.resample_poly(np.asarray(ref_22k, np.float64), 16000, fs)
    test16 = scipy.signal.resample_poly(np.asarray(test_22k, np.float64), 16000, fs)
    try:
        from pesq import pesq as _pesq
    except ImportError:
        from bvsc_tpu_torch.eval.pesq import pesq_wb

        return pesq_wb(ref16, test16, 16000)
    to_i16 = lambda x: (np.clip(x, -1, 1) * 32768.0).astype(np.int16)
    return float(_pesq(16000, to_i16(ref16), to_i16(test16), "wb"))
