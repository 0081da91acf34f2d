"""Plain reference of the bitrate-scalable BVRNN speech codec, in PyTorch.

Written from the published model (BenjSta/bernoulli-var-speech-codec: a
log-mel frontend, a Bernoulli variational RNN whose encoder and decoder
share one GRU state driven by the generated features, and a causal
BigVGAN-tiny generator with log-scale SnakeBeta), for the benchmark's
``correct`` decision.  It imports nothing of the program under test: every
weight it reads is the benchmark's own seeded tree (``lib.weights``), and it
derives everything else (the mel filterbank, the window, linear snake
parameters) itself.

Every product and convolution goes through :func:`mm` / :func:`conv`, whose
operands are rounded to ``kind`` first:

* ``'f32'``: float32 operands and sums (TF32 off);
* ``'tf32'``: operands rounded to TF32's 10-bit mantissa, float32 sums (the
  control of a float32 configuration: what turning TF32 on computes);
* ``'bf16'``: operands rounded to bf16, float32 sums;
* ``'fp8'``: operands rounded to float8 e4m3 (saturating at its largest,
  448), float32 sums (the control of a bf16 configuration's convolutions).

The recurrence can be *judged* instead of run free: given a program's codes,
:func:`encode_decode` advances its state with those codes and returns, beside
them, the probabilities it computes at every frame, so that a code can be
held against the reference's own decision from the same history (a closed
loop turns one flipped code into a different trajectory, so free-running
codes of two implementations part after the first near-0.5 decision).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

SCALING = 10 ** (-10 / 20)  # the codec's -10 dB input scaling, undone after the vocoder
SNAKE_EPS = 1e-9
MAG_EPS = 1e-9
LOG_CLIP = 1e-5
KINDS = ("f32", "tf32", "bf16", "fp8")
FP8_MAX = 448.0


# ---------------------------------------------------------------------------
# Arithmetic
# ---------------------------------------------------------------------------


def round_to(x: torch.Tensor, kind: str) -> torch.Tensor:
    """``x`` (float32) rounded to the operand type of ``kind``, as float32."""
    if kind == "f32":
        return x
    if kind == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    if kind == "fp8":
        return torch.clamp(x, -FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).to(torch.float32)
    if kind == "tf32":
        # round to nearest even on the 13 mantissa bits TF32 drops
        bits = x.contiguous().view(torch.int32)
        lsb = (bits >> 13) & 1
        return ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)
    raise ValueError(f"unknown arithmetic {kind!r}; one of {KINDS}")


@contextlib.contextmanager
def exact_float32():
    """TF32 off for cuBLAS and cuDNN inside the block, restored after."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def mm(x: torch.Tensor, w: torch.Tensor, kind: str) -> torch.Tensor:
    return torch.matmul(round_to(x, kind), round_to(w, kind))


def linear(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    """A Linear layer stored (in, out): ``x @ w + b``."""
    return mm(x, p["w"], kind) + p["b"]


def conv(x: torch.Tensor, p: dict, kind: str, dilation: int = 1, left: int = 0) -> torch.Tensor:
    """Causal Conv1d: ``left`` zeros before the signal, no padding after."""
    x = F.pad(round_to(x, kind), (left, 0))
    return F.conv1d(x, round_to(p["w"], kind), p["b"], dilation=dilation)


def conv_transpose(x: torch.Tensor, p: dict, kind: str, stride: int) -> torch.Tensor:
    """ConvTranspose1d without padding: (T - 1) * stride + k samples."""
    return F.conv_transpose1d(round_to(x, kind), round_to(p["w"], kind), p["b"], stride=stride)


# ---------------------------------------------------------------------------
# Log-mel frontend
# ---------------------------------------------------------------------------


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    """Slaney's mel scale: linear to 1 kHz (200/3 Hz a mel), then log."""
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3)
    log = 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27)
    return np.where(f < 1000.0, lin, log)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float64)
    return np.where(m < 15.0, m * (200.0 / 3), 1000.0 * np.exp((m - 15.0) * (np.log(6.4) / 27)))


def mel_filterbank(fs: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """(n_mels, n_fft // 2 + 1) triangles on Slaney's scale, area-normalised
    (librosa's ``filters.mel`` defaults), float64."""
    bins = np.linspace(0.0, fs / 2, n_fft // 2 + 1)
    edges = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    lo, mid, hi = edges[:-2, None], edges[1:-1, None], edges[2:, None]
    up = (bins[None] - lo) / (mid - lo)
    down = (hi - bins[None]) / (hi - mid)
    tri = np.maximum(0.0, np.minimum(up, down))
    return tri * (2.0 / (hi - lo))


class Frontend:
    """Waveform -> log-mel, the codec's analysis: -10 dB, reflect padding
    (``pad_left`` before, ``n_fft - pad_left - hop`` after), periodic Hann,
    |STFT| with ``sqrt(re^2 + im^2 + 1e-9)``, mel, ``log(max(., 1e-5))``."""

    def __init__(self, conf: dict, device):
        self.fs, self.n_fft, self.hop = conf["fs"], conf["winsize"], conf["hopsize"]
        self.pad_left = conf["mel_pad_left"]
        self.pad_right = self.n_fft - self.pad_left - self.hop
        n = np.arange(self.n_fft)
        self.window = torch.tensor(0.5 - 0.5 * np.cos(2 * np.pi * n / self.n_fft),
                                   dtype=torch.float32, device=device)
        fb = mel_filterbank(self.fs, self.n_fft, conf["num_mels"], conf["fmin"], conf["fmax"])
        self.fb = torch.tensor(fb, dtype=torch.float32, device=device)

    def frames(self, length: int) -> int:
        """Frames of a ``length``-sample signal."""
        return 1 + (length - self.hop) // self.hop

    def __call__(self, x: torch.Tensor, kind: str = "f32") -> torch.Tensor:
        """(B, L) waveform -> (B, frames(L), num_mels) log-mel."""
        x = F.pad((x * SCALING)[:, None], (self.pad_left, self.pad_right), mode="reflect")[:, 0]
        fr = round_to(x.unfold(-1, self.n_fft, self.hop) * self.window, kind)
        spec = torch.fft.rfft(fr, dim=-1)
        mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + MAG_EPS)
        return torch.log(torch.clamp(mm(mag, self.fb.T, kind), min=LOG_CLIP))


# ---------------------------------------------------------------------------
# BVRNN
# ---------------------------------------------------------------------------


def _mlp(layers: list, x: torch.Tensor, kind: str, last=None) -> torch.Tensor:
    """Linear + ELU layers; the last Linear followed by ``last`` (None: no
    activation)."""
    for p in layers[:-1]:
        x = F.elu(linear(p, x, kind))
    x = linear(layers[-1], x, kind)
    return x if last is None else last(x)


def _gru(p: dict, x: torch.Tensor, h: torch.Tensor, kind: str) -> torch.Tensor:
    """torch.nn.GRUCell with gates packed [r | z | n], weights stored (in, out)."""
    gi = mm(x, p["w_ih"], kind) + p["b_ih"]
    gh = mm(h, p["w_hh"], kind) + p["b_hh"]
    H = h.shape[-1]
    r = torch.sigmoid(gi[:, :H] + gh[:, :H])
    z = torch.sigmoid(gi[:, H:2 * H] + gh[:, H:2 * H])
    n = torch.tanh(gi[:, 2 * H:] + r * gh[:, 2 * H:])
    return (1 - z) * n + z * h


def bit_mask(bits: torch.Tensor, z_dim: int) -> torch.Tensor:
    """(..., ) bits/frame -> (..., z_dim): 1 on the first ``bits`` bits."""
    return (torch.arange(z_dim, device=bits.device) < bits[..., None]).float()


def masked(z: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Bits outside the mask carry the midpoint 0.5."""
    return torch.where(mask > 0, z, torch.full_like(z, 0.5))


def _normalise(p: dict, y: torch.Tensor) -> torch.Tensor:
    return (y - p["mean_mel"]) / p["std_mel"]


def _advance(p: dict, z: torch.Tensor, h: torch.Tensor, kind: str):
    """The decoder half of a step: codes -> (decoded frame, next state).  The
    state advances on the *generated* frame, so both ends follow the codes."""
    pz = _mlp(p["phi_z"], z, kind, F.elu)
    dec = _mlp(p["dec"], torch.cat([pz, h], -1), kind)
    px = _mlp(p["phi_x"], _normalise(p, dec), kind, F.elu)
    return dec, _gru(p["gru"], torch.cat([px, pz], -1), h, kind)


def encode_decode(p: dict, mel: torch.Tensor, mask: torch.Tensor, kind: str = "f32",
                  codes: torch.Tensor | None = None):
    """The closed loop over (B, T, M) mel with a (B, T, z) bit mask.

    Free (``codes`` None): each frame's codes are the rounded encoder
    probabilities (half to even), masked.  Judged: the state advances with
    the given ``codes``.  Returns (probabilities (B, T, z), the codes the
    loop used (B, T, z), decoded mel (B, T, M))."""
    B, T, _ = mel.shape
    h = torch.zeros(B, p["gru"]["w_hh"].shape[0], device=mel.device)
    phi_x = _mlp(p["phi_x"], _normalise(p, mel), kind, F.elu)
    probs, used, dec = [], [], []
    for t in range(T):
        prob = _mlp(p["enc"], torch.cat([phi_x[:, t], h], -1), kind, torch.sigmoid)
        z = masked(torch.round(prob), mask[:, t]) if codes is None else codes[:, t]
        d, h = _advance(p, z, h, kind)
        probs.append(prob)
        used.append(z)
        dec.append(d)
    return torch.stack(probs, 1), torch.stack(used, 1), torch.stack(dec, 1)


def decode_concealed(p: dict, codes: torch.Tensor, lost: torch.Tensor, conceal_mask: torch.Tensor,
                     kind: str = "f32") -> torch.Tensor:
    """Decode (B, T, z) codes; on frames flagged in ``lost`` (B, T) the codes
    are the prior's probabilities P(z_t | h_t), masked by ``conceal_mask``
    (B, T, z).  Returns the decoded mel (B, T, M)."""
    B, T, _ = codes.shape
    h = torch.zeros(B, p["gru"]["w_hh"].shape[0], device=codes.device)
    dec = []
    for t in range(T):
        z = codes[:, t]
        if bool(lost[:, t].any()):
            prior = _mlp(p["prior"], h, kind, torch.sigmoid)
            z = torch.where(lost[:, t, None] > 0, masked(prior, conceal_mask[:, t]), z)
        d, h = _advance(p, z, h, kind)
        dec.append(d)
    return torch.stack(dec, 1)


# ---------------------------------------------------------------------------
# Vocoder
# ---------------------------------------------------------------------------


def snake_beta(x: torch.Tensor, a: dict) -> torch.Tensor:
    """Log-scale SnakeBeta: x + sin^2(e^alpha x) / (e^beta + eps)."""
    alpha = torch.exp(a["alpha"])[None, :, None]
    beta = torch.exp(a["beta"])[None, :, None]
    return x + torch.sin(alpha * x) ** 2 / (beta + SNAKE_EPS)


def resblock(x: torch.Tensor, p: dict, k: int, dilations, kind: str) -> torch.Tensor:
    """AMP block: per dilation, snake -> conv (k, d) -> snake -> conv (k, 1),
    added to the input; causal padding."""
    for j, d in enumerate(dilations):
        t = conv(snake_beta(x, p["acts"][2 * j]), p["convs1"][j], kind, d, (k - 1) * d)
        t = conv(snake_beta(t, p["acts"][2 * j + 1]), p["convs2"][j], kind, 1, k - 1)
        x = x + t
    return x


def vocoder(p: dict, vcfg: dict, mel: torch.Tensor, length: int, kind: str = "f32") -> torch.Tensor:
    """(B, M, T) mel -> (B, length) waveform with the -10 dB undone."""
    ks, dils = vcfg["resblock_kernel_sizes"], vcfg["resblock_dilation_sizes"]
    x = conv(mel, p["conv_pre"], kind, 1, 6)
    for i, u in enumerate(vcfg["upsample_rates"]):
        x = conv_transpose(x, p["ups"][i], kind, u)
        outs = [resblock(x, p["resblocks"][i * len(ks) + j], k, d, kind)
                for j, (k, d) in enumerate(zip(ks, dils))]
        x = sum(outs[1:], outs[0]) / len(outs)
    x = conv(snake_beta(x, p["act_post"]), p["conv_post"], kind, 1, 6)
    return torch.tanh(x[:, 0, :length]) / SCALING
