"""Frozen operation and byte counts of the codec's work, and the H100's peaks.

Counts come from the configuration's shapes alone, never from the program's
prepared tensors, so the kernel path and the direct path of one
configuration get the same counts.  A multiply-add is 2 operations; only
products and convolutions are counted (elementwise work is left out).

Peaks are NVIDIA's published figures for one H100 SXM (dense, 700 W):
989 TFLOP/s bf16, 495 TF32, 67 float32 on the CUDA cores, 3.35 TB/s HBM3.
"""

from __future__ import annotations

PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
PEAK_BYTES_S = 3.35e12
BYTES = {"float32": 4, "bfloat16": 2}


def _mlp(dims) -> int:
    return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))


def bvrnn_frame_flops(x: int, h: int, z: int, *, encode: bool = True) -> int:
    """One frame of the closed loop for one stream: with ``encode``, phi_x
    of the input frame and the encoder; always phi_z, the decoder, phi_x of
    the generated frame and the GRU (input 2h, state h, three gates)."""
    decode = _mlp([z, h, h, h]) + _mlp([2 * h, h, h, h, x]) + _mlp([x, h, h, h]) \
        + 2 * (2 * h) * (3 * h) + 2 * h * (3 * h)
    return decode + (_mlp([x, h, h, h]) + _mlp([2 * h, h, h, z]) if encode else 0)


def prior_flops(h: int, z: int) -> int:
    """The prior P(z | h) for one concealed frame of one stream."""
    return _mlp([h, h, h, z])


def stage_flops_per_sample(channels: int, kernel_sizes, dilations) -> int:
    """One vocoder stage's residual blocks at one output sample: per block
    and dilation two convolutions of (channels, channels, k)."""
    return sum(2 * len(d) * 2 * channels * channels * k for k, d in zip(kernel_sizes, dilations))


def vocoder_frame_flops(vcfg: dict, mels: int) -> int:
    """The generator's operations a mel frame: conv_pre (k 7), each
    transposed upsampler a frame of its input, each stage at its rate, and
    conv_post (k 7) at the output rate."""
    c = vcfg["upsample_initial_channel"]
    flops = 2 * mels * c * 7
    rate = 1
    for u, k in zip(vcfg["upsample_rates"], vcfg["upsample_kernel_sizes"]):
        flops += rate * 2 * c * (c // 2) * k
        c //= 2
        rate *= u
        flops += rate * stage_flops_per_sample(c, vcfg["resblock_kernel_sizes"],
                                               vcfg["resblock_dilation_sizes"])
    return flops + rate * 2 * c * 7


def stage_bound_s(channels: int, kernel_sizes, dilations, rows: int, samples: int,
                  compute: str, io: str = "float32") -> tuple[float, str]:
    """Least time of one stage call on (rows, channels, samples): its
    operations at the compute type's peak, or its bytes at HBM bandwidth,
    whichever is longer, with the input read once, the output written once
    (``io`` elements) and each weight read once at the compute type
    (biases and snake parameters in float32).  Returns (seconds, which)."""
    work = rows * samples
    flops = stage_flops_per_sample(channels, kernel_sizes, dilations) * work
    convs = [(2 * len(d), k) for k, d in zip(kernel_sizes, dilations)]
    weights = sum(n * (channels * channels * k * BYTES[compute] + channels * 4) for n, k in convs)
    weights += sum(n * 2 * channels * 4 for n, _ in convs)  # two snake parameters a conv
    nbytes = 2 * BYTES[io] * channels * work + weights
    t_ops, t_bytes = flops / PEAK_FLOPS[compute], nbytes / PEAK_BYTES_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
