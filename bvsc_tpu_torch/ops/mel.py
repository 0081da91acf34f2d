"""Log-mel spectrogram frontend in PyTorch.

Port of ``bvsc_tpu/ops/mel.py``: asymmetric reflect pad (left
``padding_left``, right ``win - left - hop``) -> framed DFT (periodic Hann
window, center=False, onesided) as two float32 matmuls against cos/sin bases
-> magnitude ``sqrt(re^2 + im^2 + 1e-9)`` -> Slaney mel filterbank matmul ->
``log(clamp(x, 1e-5))``.  The filterbank and the window are built in numpy
with the same formulae as the JAX package, so the constants are identical.

Beside the frontend object, the reference's functional API on the same
framed DFT: :func:`stft_magnitude` (an already padded signal ->
``sqrt(re^2 + im^2 + eps)``), :func:`mel_spectrogram` (one-shot, the
counterpart of ``meldataset.mel_spectrogram``) and
:meth:`MelFrontend.stft_and_mel` (``return_stft=True``).
"""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.nn.functional as F

from bvsc_tpu_torch.device import resolve_device
from bvsc_tpu_torch.utils import tracing


def _hz_to_mel_slaney(freq: np.ndarray) -> np.ndarray:
    """Slaney (Auditory Toolbox) Hz->mel: linear below 1 kHz, log above."""
    freq = np.asarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = freq / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        freq >= min_log_hz,
        min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep,
        mels,
    )


def _mel_to_hz_slaney(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        mels >= min_log_mel,
        min_log_hz * np.exp(logstep * (np.maximum(mels, min_log_mel) - min_log_mel)),
        freqs,
    )


def slaney_mel_filterbank(
    sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float
) -> np.ndarray:
    """Triangular mel filterbank (n_mels, 1 + n_fft//2), float32, equal to
    ``librosa.filters.mel`` defaults (Slaney scale and area norm)."""
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2, dtype=np.float64)
    mel_min, mel_max = _hz_to_mel_slaney(np.array([fmin, fmax]))
    hz_pts = _mel_to_hz_slaney(np.linspace(mel_min, mel_max, n_mels + 2))
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def hann_window_periodic(win_size: int) -> np.ndarray:
    """Periodic Hann window; ``torch.hann_window(win_size)`` to float32 rounding."""
    n = np.arange(win_size, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_size)).astype(np.float32)


def dft_real_bases(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real and imaginary DFT bases (n_fft, 1 + n_fft//2), float32."""
    k = np.arange(1 + n_fft // 2)[None, :]
    n = np.arange(n_fft)[:, None]
    ang = 2.0 * np.pi * k * n / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def dynamic_range_compression(x: torch.Tensor, clip_val: float = 1e-5) -> torch.Tensor:
    return torch.log(torch.clamp(x, min=clip_val))


def _framed_magnitude(frames: torch.Tensor, window: torch.Tensor, cos_basis: torch.Tensor,
                      sin_basis: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """(B, F, n_fft) unwindowed frames -> (B, bins, F) magnitude: the
    windowed frames against the cos/sin bases (two float32 products)."""
    frames = frames * window
    re = torch.matmul(frames, cos_basis)
    im = torch.matmul(frames, sin_basis)
    return torch.sqrt(re * re + im * im + eps).transpose(-1, -2)


def stft_magnitude(y: torch.Tensor, n_fft: int, hop_size: int, window, *, eps: float = 1e-9,
                   dft_bases: tuple | None = None) -> torch.Tensor:
    """Framed STFT magnitude ``sqrt(re^2 + im^2 + eps)`` of an already
    padded (B, L) signal (no centring), shape (B, n_fft // 2 + 1, F); the
    DFT is the frontend's, two float32 products against
    :func:`dft_real_bases` (or ``dft_bases``), on ``y``'s device."""
    if dft_bases is None:
        dft_bases = dft_real_bases(n_fft)
    cos_b, sin_b = (torch.as_tensor(b, device=y.device) for b in dft_bases)
    return _framed_magnitude(y.unfold(-1, n_fft, hop_size),
                             torch.as_tensor(window, device=y.device), cos_b, sin_b, eps)


class MelFrontend:
    """(B, L) waveform -> (B, num_mels, F) log-mel, with the constants on
    ``device`` (default CUDA, which raises without a card; pass
    ``device='cpu'`` for the CPU)."""

    def __init__(
        self,
        sampling_rate: int = 22050,
        n_fft: int = 1024,
        num_mels: int = 80,
        hop_size: int = 256,
        fmin: float = 0.0,
        fmax: float | None = 8000.0,
        padding_left: int = 256,
        *,
        device: str | torch.device | None = None,
    ):
        device = resolve_device(device)
        if padding_left == -1:  # symmetric padding (the reference's meldataset.py:72-75)
            if (n_fft - hop_size) % 2:
                raise ValueError(f"no symmetric padding for n_fft {n_fft}, hop {hop_size}")
            padding_left = (n_fft - hop_size) // 2
        self.pad_left = padding_left
        self.pad_right = n_fft - padding_left - hop_size
        self.n_fft = n_fft
        self.hop_size = hop_size
        self.num_mels = num_mels
        fmax = sampling_rate / 2 if fmax is None else fmax
        cos_b, sin_b = dft_real_bases(n_fft)
        self.window = torch.from_numpy(hann_window_periodic(n_fft)).to(device)
        self.mel_basis = torch.from_numpy(
            slaney_mel_filterbank(sampling_rate, n_fft, num_mels, fmin, fmax)
        ).to(device)
        self.cos_basis = torch.from_numpy(cos_b).to(device)
        self.sin_basis = torch.from_numpy(sin_b).to(device)

    TENSORS = ("window", "mel_basis", "cos_basis", "sin_basis")

    def tensors(self) -> dict:
        """The frontend's constants by name (a serving bundle stores them
        as program inputs)."""
        return {k: getattr(self, k) for k in self.TENSORS}

    def with_tensors(self, tensors: dict) -> "MelFrontend":
        """A copy of this frontend that computes with ``tensors`` (the
        layout of :meth:`tensors`) in place of its own."""
        new = copy.copy(self)
        for k in self.TENSORS:
            setattr(new, k, tensors[k])
        return new

    def num_frames(self, length: int) -> int:
        return 1 + (length + self.pad_left + self.pad_right - self.n_fft) // self.hop_size

    def pad(self, y: torch.Tensor) -> torch.Tensor:
        """(B, L) -> (B, pad_left + L + pad_right), reflect-padded."""
        return F.pad(y[:, None, :], (self.pad_left, self.pad_right), mode="reflect")[:, 0]

    def log_mel(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, F, n_fft) unwindowed frames -> (B, num_mels, F) log-mel.  The
        one-shot call and the streaming paths (``streaming.py``) share it, so
        a frame's mel is the same arithmetic on both (and the span ``mel``
        times both)."""
        with tracing.span("mel"):
            return self._mel_and_magnitude(frames)[0]

    def _mel_and_magnitude(self, frames: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, F, n_fft) unwindowed frames -> (log-mel (B, num_mels, F),
        STFT magnitude (B, bins, F))."""
        mag = _framed_magnitude(frames, self.window, self.cos_basis, self.sin_basis)
        return dynamic_range_compression(torch.matmul(self.mel_basis, mag)), mag

    def __call__(self, y: torch.Tensor) -> torch.Tensor:
        return self.log_mel(self.pad(y).unfold(-1, self.n_fft, self.hop_size))

    def stft_and_mel(self, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, L) waveform -> (log-mel, STFT magnitude): the reference's
        ``return_stft=True``."""
        return self._mel_and_magnitude(self.pad(y).unfold(-1, self.n_fft, self.hop_size))


def mel_spectrogram(y: torch.Tensor, n_fft: int, num_mels: int, sampling_rate: int, hop_size: int,
                    win_size: int, fmin: float, fmax: float | None,
                    padding_left: int) -> torch.Tensor:
    """One-shot log-mel, the reference's ``meldataset.mel_spectrogram``
    (reflect pad left ``padding_left``, or symmetric with -1), on ``y``'s
    device: (B, L) -> (B, num_mels, F).  The window is ``n_fft`` long, as
    the JAX package's frontend needs it; another ``win_size`` raises
    ValueError."""
    if win_size != n_fft:
        raise ValueError(f"win_size {win_size} != n_fft {n_fft}: the frontend's Hann window "
                         "spans the whole frame")
    y = torch.as_tensor(y)
    frontend = MelFrontend(sampling_rate=sampling_rate, n_fft=n_fft, num_mels=num_mels,
                           hop_size=hop_size, fmin=fmin, fmax=fmax, padding_left=padding_left,
                           device=y.device)
    return frontend(y)
