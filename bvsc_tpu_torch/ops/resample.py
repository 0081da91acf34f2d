"""Alias-free resampling: a kaiser-windowed sinc low-pass and 2x up- and
down-sampling around an activation (port of ``bvsc_tpu/ops/resample.py``,
the reference's vendored alias-free-torch).

The anti-aliased vocoder variants (``layers_antialias``, ``antialias_post``)
wrap each snake in :class:`Activation1d`: up 2x -> activation -> down 2x.
The filters look ahead, so the causal configs (``configs/varbitrate.toml``,
``fixed64.toml``) leave them off; the full BigVGAN
(``configs/varbitrate_bigvgan.toml``) turns every one on.  They run on the
direct vocoder path only.

Each filter is a depthwise ``conv1d`` / ``conv_transpose1d`` (groups = C)
with replicate padding, in the input's dtype and on its device, with the
JAX package's pads and trims.  The filter taps are numpy float32, as the
JAX package computes them (:func:`kaiser_sinc_filter1d` is a copy); their
copy on each (device, dtype) a filter meets is made once and kept
(:func:`_depthwise`), so a call makes no host-to-device copy and no stream
synchronisation.  :class:`Activation1d` is the plain version.

:func:`activation1d` is the vocoder's anti-aliased Snake or SnakeBeta
(``ops.snake.snake_linear``'s linear ``alpha`` and ``inv_beta``), the
custom op ``bvsc_torch::antialias_act`` (:data:`OP`), as K1 is one
(``ops.amp_resblock``): on a CUDA tensor, float32 or bf16, it is one
launch of ``csrc/antialias_act.cu`` (:func:`activation1d_kernel`; bf16
through ``csrc/antialias_act_io_bf16.cu``), x read once, y written once,
the 2x signal kept on the chip, float32 arithmetic; its gradient is the
plain chain's, recomputed; a CPU tensor takes the plain chain
(:func:`plain_act`), and anything else raises.  torch.compile and
torch.export record the op, so a compiled or exported program launches
the kernel on a card too.  Each launch counts in the tracing counter
``vocoder.aa_kernel``; each library builds on its first launch, never at
import.  The taps the kernel is handed are :func:`kernel_taps`, the two
filters as :func:`kaiser_sinc_filter1d` makes them, made once.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from bvsc_tpu_torch.ops import _build
from bvsc_tpu_torch.ops.snake import snake_linear
from bvsc_tpu_torch.utils import tracing


def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """Kaiser-windowed sinc low-pass of unity DC gain, (1, 1, kernel_size)
    float32."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    A = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if A > 50.0:
        beta = 0.1102 * (A - 8.7)
    elif A >= 21.0:
        beta = 0.5842 * (A - 21) ** 0.4 + 0.07886 * (A - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    if even:
        time = np.arange(-half_size, half_size) + 0.5
    else:
        time = np.arange(kernel_size) - half_size
    if cutoff == 0:
        return np.zeros((1, 1, kernel_size), np.float32)
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    filt /= filt.sum()
    return filt.reshape(1, 1, kernel_size).astype(np.float32)


# (taps' bytes, device, dtype) -> the (1, 1, K) taps there
_device_taps: dict = {}


def _depthwise(filt: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """The (1, 1, K) taps as a (C, 1, K) depthwise weight for ``x``: their
    copy on ``x``'s device in its dtype, made on first use and kept (a
    ``torch.compile`` or ``torch.export`` trace takes a fresh one, so no
    traced tensor is kept)."""
    key = (filt.tobytes(), x.device, x.dtype)
    w = _device_taps.get(key)
    if w is None:
        w = torch.as_tensor(filt, device=x.device).to(x.dtype)
        if not (torch.compiler.is_compiling() or torch.compiler.is_exporting()):
            _device_taps[key] = w
    return w.expand(x.shape[1], 1, filt.shape[-1])


def _replicate(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    return F.pad(x, (left, right), mode="replicate") if left or right else x


class LowPassFilter1d:
    def __init__(self, cutoff=0.5, half_width=0.6, stride=1, padding=True, kernel_size=12):
        if not 0.0 <= cutoff <= 0.5:
            raise ValueError("cutoff must be in [0, 0.5]")
        self.kernel_size = kernel_size
        even = kernel_size % 2 == 0
        self.pad_left = kernel_size // 2 - int(even)
        self.pad_right = kernel_size // 2
        self.stride = stride
        self.padding = padding
        self.filter = kaiser_sinc_filter1d(cutoff, half_width, kernel_size)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding:
            x = _replicate(x, self.pad_left, self.pad_right)
        return F.conv1d(x, _depthwise(self.filter, x), stride=self.stride, groups=x.shape[1])


class UpSample1d:
    """Zero-stuffing and sinc interpolation: (B, C, T) -> (B, C, ratio * T)."""

    def __init__(self, ratio=2, kernel_size=None):
        self.ratio = ratio
        self.kernel_size = int(6 * ratio // 2) * 2 if kernel_size is None else kernel_size
        self.stride = ratio
        self.pad = self.kernel_size // ratio - 1
        self.pad_left = self.pad * self.stride + (self.kernel_size - self.stride) // 2
        self.pad_right = self.pad * self.stride + (self.kernel_size - self.stride + 1) // 2
        self.filter = kaiser_sinc_filter1d(0.5 / ratio, 0.6 / ratio, self.kernel_size)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = _replicate(x, self.pad, self.pad)
        y = self.ratio * F.conv_transpose1d(x, _depthwise(self.filter, x), stride=self.stride,
                                            groups=x.shape[1])
        return y[..., self.pad_left: y.shape[-1] - self.pad_right]


class DownSample1d:
    """Low-pass and decimate: (B, C, T) -> (B, C, T / ratio)."""

    def __init__(self, ratio=2, kernel_size=None):
        kernel_size = int(6 * ratio // 2) * 2 if kernel_size is None else kernel_size
        self.lowpass = LowPassFilter1d(cutoff=0.5 / ratio, half_width=0.6 / ratio,
                                       stride=ratio, kernel_size=kernel_size)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.lowpass(x)


class Activation1d:
    """up 2x -> ``activation`` -> down 2x."""

    def __init__(self, activation, up_ratio=2, down_ratio=2, up_kernel_size=12,
                 down_kernel_size=12):
        self.act = activation
        self.upsample = UpSample1d(up_ratio, up_kernel_size)
        self.downsample = DownSample1d(down_ratio, down_kernel_size)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.downsample(self.act(self.upsample(x)))


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------


def kernel_taps() -> np.ndarray:
    """The (24,) float32 taps :func:`activation1d_kernel` hands its kernel:
    :class:`Activation1d`'s up filter, then its down filter."""
    act = Activation1d(None)
    return np.concatenate([act.upsample.filter.ravel(), act.downsample.lowpass.filter.ravel()])


@functools.cache
def _taps_arg() -> ctypes.Array:
    return (ctypes.c_float * 24).from_buffer_copy(kernel_taps().tobytes())


# activations' dtype -> (library under csrc/, entry point): float32 arithmetic in both
_ENTRIES = {torch.float32: ("antialias_act", "antialias_act_f32"),
            torch.bfloat16: ("antialias_act_io_bf16", "antialias_act_f32_io_bf16")}


@functools.cache
def _kernel(dtype: torch.dtype):
    lib, entry = _ENTRIES[dtype]
    fn = getattr(_build.load(lib), entry)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def plain_act(x: torch.Tensor, alpha: torch.Tensor, inv_beta: torch.Tensor,
              approx: bool = False) -> torch.Tensor:
    """:class:`Activation1d` around ``ops.snake.snake_linear``: the plain
    chain the kernel computes in one pass, on any device, differentiable."""
    return Activation1d(lambda v: snake_linear(v, alpha, inv_beta, approx))(x)


def activation1d_kernel(x: torch.Tensor, alpha: torch.Tensor, inv_beta: torch.Tensor,
                        approx: bool = False) -> torch.Tensor:
    """:func:`plain_act` in one kernel launch on the current stream: ``x`` a
    float32 or bf16 (B, C, T) CUDA tensor, read in place where its rows are
    evenly strided (a contiguous tensor, or a view trimmed along T) and made
    contiguous otherwise; ``alpha`` and ``inv_beta`` (C,) linear parameters
    on its device (widened to float32, the kernel's arithmetic); the output
    contiguous in ``x``'s dtype.  Counts the launch in the tracing counter
    ``vocoder.aa_kernel``.  The op's CUDA implementation."""
    if x.device.type != "cuda" or x.dtype not in _ENTRIES or x.dim() != 3:
        raise ValueError(f"the kernel takes a float32 or bf16 (B, C, T) CUDA tensor, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    B, C, T = x.shape
    if x.stride(2) != 1 or x.stride(0) != C * x.stride(1) or x.stride(1) < T:
        x = x.contiguous()
    alpha, inv_beta = (p.to(torch.float32).contiguous() for p in (alpha, inv_beta))
    for p in (alpha, inv_beta):
        if tuple(p.shape) != (C,) or p.device != x.device:
            raise ValueError(f"snake parameters must be ({C},) on {x.device}, got "
                             f"{tuple(p.shape)} on {p.device}")
    y = torch.empty(B, C, T, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernel(x.dtype)(x.data_ptr(), y.data_ptr(), alpha.data_ptr(), inv_beta.data_ptr(),
                               ctypes.addressof(_taps_arg()), B * C, x.stride(1), C, T,
                               int(approx), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"antialias_act kernel launch failed for {x.dtype} "
                           f"{tuple(x.shape)}: CUDA error {err}")
    tracing.count("vocoder.aa_kernel")
    return y


def _plain_op(x, alpha, inv_beta, approx):
    """The op's CPU implementation: :func:`plain_act` in ``x``'s dtype,
    contiguous, as the kernel's output and the fake function's are."""
    return plain_act(x, alpha, inv_beta, approx).to(x.dtype).contiguous()


# A traced program calls it as torch.ops.bvsc_torch.antialias_act.
OP = torch.library.custom_op(
    "bvsc_torch::antialias_act", _plain_op, mutates_args=(), device_types="cpu",
    schema="(Tensor x, Tensor alpha, Tensor inv_beta, bool approx) -> Tensor")
OP.register_kernel("cuda")(activation1d_kernel)


@OP.register_fake
def _fake(x, alpha, inv_beta, approx):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _setup_context(ctx, inputs, output):
    x, alpha, inv_beta, approx = inputs
    ctx.save_for_backward(x, alpha, inv_beta)
    ctx.approx = approx


def _backward(ctx, gy):
    """The op's gradient: :func:`plain_act`'s, recomputed from the saved
    input (the kernel has no backward; the GAN trainer's activations take
    this route on a card)."""
    x, alpha, inv_beta = ctx.saved_tensors
    _, vjp = torch.func.vjp(lambda *t: _plain_op(*t, ctx.approx), x, alpha, inv_beta)
    return (*vjp(gy), None)


OP.register_autograd(_backward, setup_context=_setup_context)


def activation1d(x: torch.Tensor, alpha: torch.Tensor, inv_beta: torch.Tensor,
                 approx: bool = False) -> torch.Tensor:
    """:func:`plain_act`, through the op :data:`OP`: a CUDA tensor (float32
    or bf16) launches the kernel (:func:`activation1d_kernel`), its
    gradient, where one is wanted, the plain chain's (:func:`_backward`); a
    CPU tensor takes the plain chain; anything else raises.  A trace
    (torch.compile, torch.export) records the op."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"activation1d runs on cuda or cpu, not {x.device}")
    if (torch.compiler.is_compiling() or torch.compiler.is_exporting()
            or type(x) is not torch.Tensor
            or x.is_cuda and torch.is_grad_enabled()
            and any(t.requires_grad for t in (x, alpha, inv_beta))):
        return OP(x, alpha, inv_beta, approx)
    # Eager calls that want no gradient skip the dispatcher, as K1's do
    # (ops.amp_resblock), and run the op's implementation itself; a CPU one
    # the plain chain, which autograd differentiates as it is.
    return (activation1d_kernel if x.is_cuda else plain_act)(x, alpha, inv_beta, approx)
