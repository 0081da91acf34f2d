#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds:

1. ``device``: the card's name and ``nvidia-smi``'s name and power limit
   (also printed raw on a line of its own).  Without a card the script
   exits non-zero and prints no result.
2. ``build``: nvcc builds every CUDA source of ``bvsc_tpu_torch/csrc``
   into the gitignored ``bvsc_tpu_torch/_build``; ``cuobjdump`` counts the
   float32-pipe instructions of one snake on its fast path in the bf16
   build's SASS (``k1_tiles.snake_instructions``).
3. ``main_path``: ``BVRNNCodecModel`` at full width (the shipped BVRNN
   checkpoint, a seeded full-width vocoder) resynthesises a batch of 4
   waveforms at 3 kbps; the kernels' launch counts are read around that
   one call, which also keeps every vocoder stage's input and kernel
   output.  Checks shape, finiteness, codes in {0, 0.5, 1}, each stage's
   kernel output against the plain version on the same input, and the
   kernel vocoder against the plain generator on the same decoded mel.
4. ``fast_path``: the same batch, checkpoint and vocoder at
   ``precision='default'`` (fast serving) in four forms: ``fused_cell``
   ``'auto'`` (fused at B=4), ``fused_cell=False``, ``quantize='int8'`` and
   ``quantize='int8_mixed'``.  The launch counts are read around the
   ``'auto'`` call (12 bf16-kernel launches, 0 float32), which keeps each
   stage's input and bf16-kernel output.  Checks shape, finiteness, codes
   in {0, 0.5, 1}, each stage's kernel output against the plain bf16
   version (1e-3), ``decode`` of the parity codes against the parity
   ``decode`` (2e-2, the reference's fast-serving contract), and each
   form's code agreement with the parity path (>= 99.5 %): chaos-free on
   the trained checkpoint (every frame encoded from the parity path's own
   state), and free-running on a seeded random-init BVRNN, whose dynamics
   do not amplify a flip (the reference's documented figures come from
   these two measurements).  The free-running agreement on the trained
   checkpoint is printed too.
5. ``kernel``: each kernel's wrapper against its plain PyTorch version on
   the card, at the shapes the main path gave it (float32 with TF32 off,
   and bf16 mode), on seeded inputs, timed with CUDA events (``ms``, host
   launches included; ``device_ms`` from a replayed CUDA graph), beside its
   least possible time on an H100; each stage line also carries the grid
   (``blocks``), ``threads`` and ``smem_bytes`` per resblock as the
   kernel's build reports them (the shared memory checked against the
   limit), the micro-tile (float32) or warp tile and weight buffers (bf16),
   and the useful ``tflops``; bf16 lines add ``snake_floor_ms``, the
   stage's snakes at the count from ``build`` over 128 lanes of every SM at
   the SM clock's maximum.  A ``kernel_total`` line per mode sums them.
6. ``probes``: the two benchmark probes (``bvsc_tpu_torch.benchmarks``)
   run through their ``run()`` entry points with the kernels' launch counts
   read around them; then the persistent GRU (bf16 and int8, H = 1024,
   T = 512, 8 rows), the dot chain (M = 128, 256, 512) and the gridded dot
   (128 x 128 x 32 768, and three shapes that cut its tiles) against their
   plain versions on the probes' own inputs, and timed beside their bounds;
   the persistent GRU also at T = 64 (``us_per_step``: the slope from 64
   to 512 steps) with its plan as its build reports it; the dot chain also
   at three shapes that cut its tiles and with 1 and 3 products, with its
   plan as its build reports it, each M's share of its bound, and
   ``torch.mm`` over the stacked contraction as its yardstick; the gridded dot
   also beside ``torch.mm``, with the L2 warm (replayed
   back-to-back calls) and cold (flushed before each call), and its plan
   as its build reports it: one block on each of the card's SMs.

Then a ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``.  Any failure raises: exit code non-zero
and no ``ok`` line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from bvsc_tpu_torch import BVRNNCodecModel, load_config
from bvsc_tpu_torch.benchmarks import (chain_steps, cold_ms, cuda_ms, graph_ms, gru_steps, k1_tiles,
                                        seeded_vocoder)
from bvsc_tpu_torch.benchmarks import probe_persistent_gru as probe_gru
from bvsc_tpu_torch.benchmarks import probe_roofline as probe_roof
from bvsc_tpu_torch.codec import DEFAULT_CONFIG, SCALING
from bvsc_tpu_torch.device import set_parity_mode
from bvsc_tpu_torch.models import bvrnn as bvrnn_mod
from bvsc_tpu_torch.models import vocoder as voc_mod
from bvsc_tpu_torch.ops import _build
from bvsc_tpu_torch.ops import amp_resblock as AR
from bvsc_tpu_torch.ops import dot_probe as DP
from bvsc_tpu_torch.ops import persistent_gru as PG

REPO = os.path.dirname(os.path.abspath(__file__))
NPZ = os.path.join(REPO, "chkpts", "bvsc_bvrnn_demo_augfull_step1800_f16.npz")
WAV = os.path.join(REPO, "docs", "artifacts", "demo_stim15_3kbps.wav")
DEV = torch.device("cuda")
BATCH = 4
BITRATE = 3000
SEED = 0

# Published H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor
# cores, bf16 on the tensor cores, and HBM bandwidth.  The least time of a
# function is the larger of its FLOPs over the peak for their type and its
# bytes over the bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
KERNEL_TOL = 1e-4  # float32, summation order differs over 6 chained convs
# bf16 mode: the same bf16 products, float32 sums in another order; where a
# conv output lies within that noise of a bf16 rounding boundary the next
# operand rounds the other way (~1e-5 moves, measured 3e-5 on the CPU
# against the JAX kernel).
BF16_KERNEL_TOL = 1e-3
FAST_WAVE_TOL = 2e-2  # the reference's fast-serving waveform contract
AGREE_MIN = 0.995  # code agreement of every fast form with the parity path
FAST_FORMS = {"auto": {}, "unfused": {"fused_cell": False},
              "int8": {"quantize": "int8"}, "int8_mixed": {"quantize": "int8_mixed"}}
# Persistent GRU, one step: the same bf16 operands, only the order of the
# float32 sums differs.
GRU_STEP_TOL = 1e-5
# Persistent GRU over 512 steps in bf16: a 1e-7 gap in h can flip one bf16
# rounding of h (~2e-3) and feed back.  Also the int8 one-step bound: the
# probe's int8 weights carry no scale, so gate sums reach ~1e4, whose float32
# rounding (~1e-3) moves the gates that are not saturated.
GRU_TOL = 2e-2
CHAIN_RTOL = 1e-5  # of max |out|: 64 float32 additions in another order
# Shapes that cut K3's 64-row tiles and its column tiles, by one row and 8
# columns, and fit inside one tile; products that fill no pass of its loop.
CHAIN_RAGGED = ((40, 200), (65, 1032), (1, 8))
CHAIN_REPS = (1, 3)
GRIDDED_TOL = 1e-4  # one product, K = 128 in float32
# Shapes that cut K4's 128-row tiles and its column tiles at both edges, by
# one row and 8 columns, and fit inside one tile.
GRIDDED_RAGGED = ((200, 1000), (129, 4104), (40, 8))


def emit(phase: str, t0: float, **fields) -> None:
    print(json.dumps({"phase": phase, **fields, "seconds": time.time() - t0}), flush=True)


def load_batch() -> np.ndarray:
    """The demo utterance plus three seeded noisy copies, (4, samples)."""
    from scipy.io import wavfile

    fs, data = wavfile.read(WAV)
    if fs != 22050:
        raise ValueError(f"{WAV} is {fs} Hz, expected 22050")
    speech = data.astype(np.float32) / 32768.0
    rng = np.random.default_rng(SEED)
    noisy = [speech + 0.01 * rng.standard_normal(speech.shape).astype(np.float32)
             for _ in range(BATCH - 1)]
    return np.stack([speech, *noisy])


def stage_bound_ms(stage_blocks, B: int, T: int,
                   compute_dtype: torch.dtype = torch.float32) -> tuple[float, str]:
    """Least time of one vocoder stage (its resblocks and their average):
    conv FLOPs (2 C^2 k per output sample, 6 convs per block) at the peak of
    their type (float32 on the CUDA cores, or bf16 on the tensor cores)
    against the input read once, the output written once and the weights
    the mode reads (float32, or the packed bf16 ones) read once."""
    C = stage_blocks[0].channels
    flops = sum(6 * 2 * C * C * rb.kernel_size for rb in stage_blocks) * B * T
    bf16 = compute_dtype == torch.bfloat16
    weights = sum(t.numel() * t.element_size() for rb in stage_blocks
                  for t in ((rb.wk1, rb.wk2) if bf16 else (rb.w1, rb.w2))
                  + (rb.b1, rb.b2, rb.alpha, rb.inv_beta))
    nbytes = 4 * 2 * B * C * T + weights
    peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def device_phase() -> tuple[str, float]:
    t0 = time.time()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(1)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit("device", t0, name=name, nvidia_smi=smi, count=torch.cuda.device_count(),
         sm_clock_max_mhz=float(clock), torch=torch.__version__, cuda=torch.version.cuda)
    return name, float(clock)


def build_phase(clock_mhz: float) -> dict:
    """Builds every kernel; returns one snake's float32-pipe instruction
    count in the bf16 build's SASS and the SM clock, for the snake floor."""
    t0 = time.time()
    _build.load_all()
    snake = {**k1_tiles.snake_instructions(), "clock_mhz": clock_mhz}
    emit("build", t0, libraries=[os.path.relpath(_build.library_path(name), REPO)
                                 for name in _build.sources()], snake=snake)
    return snake


def launch_fields(blocks, B: int, T: int, tile: int, ms: float,
                  compute_dtype: torch.dtype = torch.float32) -> dict:
    """The mode's kernel launch shape at one stage (per resblock, as its
    build reports it; its shared memory within one block's limit) and the
    stage's useful TFLOP/s at ``ms``.  float32: the micro-tile (R_co, R_t);
    bf16: the warp tile (m16 tiles, output channels), and per resblock the
    weight buffers and the blocks an SM holds (at least what ``tile_for``
    counts on)."""
    bf16 = compute_dtype == torch.bfloat16
    plans = [(AR.bf16_plan if bf16 else AR.f32_plan)(rb, tile) for rb in blocks]
    for rb, plan in zip(blocks, plans):
        if plan["smem_bytes"] > AR.SMEM_LIMIT:
            raise AssertionError(f"k={rb.kernel_size}: the kernel takes {plan['smem_bytes']} B of "
                                 f"shared memory, more than {AR.SMEM_LIMIT}")
        if bf16 and plan["blocks_per_sm"] < AR.BF16_BLOCKS_PER_SM[rb.channels]:
            raise AssertionError(f"k={rb.kernel_size}: an SM holds {plan['blocks_per_sm']} blocks, "
                                 f"tile_for counts on {AR.BF16_BLOCKS_PER_SM[rb.channels]}")
    flops = sum(6 * 2 * rb.channels ** 2 * rb.kernel_size for rb in blocks) * B * T
    shape = ({"warp_tile": [plans[0]["rm"], plans[0]["channels"]],
              "weight_buffers": [p["weight_buffers"] for p in plans],
              "blocks_per_sm": [p["blocks_per_sm"] for p in plans]} if bf16 else
             {"micro_tile": [plans[0]["rco"], plans[0]["rt"]]})
    return {"blocks": -(-T // tile) * B, "threads": [p["threads"] for p in plans],
            "smem_bytes": [p["smem_bytes"] for p in plans], **shape, "tflops": flops / ms / 1e9}


def snake_floor_ms(stage_blocks, B: int, T: int, snake_fp32: int, clock_mhz: float) -> float:
    """Least time of a stage's snakes on the CUDA cores: 6 per unit chain
    (3 units, 2 each) per resblock, channel and sample, each ``snake_fp32``
    float32-pipe instructions, over 128 lanes per SM on every SM at
    ``clock_mhz``."""
    C = stage_blocks[0].channels
    evals = 2 * AR.N_UNITS * len(stage_blocks) * B * C * T
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    return evals * snake_fp32 / (sms * 128 * clock_mhz * 1e6) * 1e3


def kernel_phase(codec: BVRNNCodecModel, stage_shapes,
                 compute_dtype: torch.dtype = torch.float32, snake: dict | None = None) -> dict:
    """Kernel against plain at each stage's (B, C, T) from the main path,
    on seeded inputs, in ``compute_dtype``'s mode; returns the summed
    numbers for the kernels line.  ``ms`` is a stage call as the caller sees
    it (CUDA events around 20 calls, host launches included), ``device_ms``
    the device's time alone (a CUDA graph of 20 calls, replayed).  With
    ``snake`` (the fp32 instruction count of one snake and the SM clock),
    each line also carries the stage's snake floor."""
    total = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": set(),
             "device_ms": 0.0, "snake_floor_ms": 0.0}
    bf16 = compute_dtype == torch.bfloat16
    name, tol = ("amp_resblock_bf16", BF16_KERNEL_TOL) if bf16 else ("amp_resblock", KERNEL_TOL)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    for stage, (B, C, T) in enumerate(stage_shapes):
        t0 = time.time()
        blocks = codec.kernel_blocks[stage]
        x = 0.3 * torch.randn(B, C, T, device=DEV, generator=gen)
        got = AR.amp_stack(x, blocks, compute_dtype)
        ref = AR.amp_stack_plain(x, blocks, compute_dtype)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        if not err <= tol:
            raise AssertionError(f"stage {stage}: {name} vs plain {err} > {tol}")
        ms = cuda_ms(lambda: AR.amp_stack(x, blocks, compute_dtype))
        device_ms = graph_ms(lambda: AR.amp_stack(x, blocks, compute_dtype))
        plain_ms = cuda_ms(lambda: AR.amp_stack_plain(x, blocks, compute_dtype))
        bound, bound_by = stage_bound_ms(blocks, B, T, compute_dtype)
        tile = AR.launch_tile(x, compute_dtype)
        floor = {}
        if snake:
            floor["snake_floor_ms"] = snake_floor_ms(blocks, B, T, snake["fp32"], snake["clock_mhz"])
            total["snake_floor_ms"] += floor["snake_floor_ms"]
        emit("kernel", t0, kernel=name, stage=stage, shape=[B, C, T], tile=tile,
             last_tile=T % tile or tile, launches_per_stage=len(blocks), max_abs_err=err, tol=tol,
             ms=ms, device_ms=device_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
             roofline_share=bound / ms, **floor,
             **launch_fields(blocks, B, T, tile, ms, compute_dtype))
        total["max_abs_err"] = max(total["max_abs_err"], err)
        total["ms"] += ms
        total["device_ms"] += device_ms
        total["plain_ms"] += plain_ms
        total["bound_ms"] += bound
        total["bound_by"].add(bound_by)
    return total


def timed(fn):
    """(result, host milliseconds) of ``fn``, synchronised on both sides."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def recorded_call(codec: BVRNNCodecModel, x: torch.Tensor):
    """``codec(x, BITRATE)`` with the vocoder's stage function wrapped to
    keep each stage's input and kernel output, in stage order."""
    stages = []

    def stage(xs, blocks, compute_dtype=torch.float32):
        ys = AR.amp_stack(xs, blocks, compute_dtype)
        stages.append((xs, ys))
        return ys

    voc_mod.amp_stack = stage
    try:
        return codec(x, BITRATE), stages
    finally:
        voc_mod.amp_stack = AR.amp_stack


def main_path_phase(codec: BVRNNCodecModel, wav: np.ndarray) -> tuple[int, list]:
    """One resynthesis call through the entry point, with the kernel's
    launch count read around it and each stage's kernel output held against
    the plain version; then a second, warm call for its time, and the
    call's phases one at a time.  Returns the launches of the first call
    and the (B, C, T) it gave each stage."""
    t0 = time.time()
    B, L = wav.shape
    x = torch.from_numpy(wav).to(DEV)
    AR.amp_resblock.launches = AR.amp_resblock.launches_bf16 = 0
    (y, stages), first_ms = timed(lambda: recorded_call(codec, x))
    launches = AR.amp_resblock.launches
    n_blocks = sum(len(blocks) for blocks in codec.kernel_blocks)
    if launches < n_blocks or AR.amp_resblock.launches_bf16:
        raise AssertionError(f"amp_resblock launched {launches} times (bf16: "
                             f"{AR.amp_resblock.launches_bf16}) in the main path, "
                             f"expected at least {n_blocks} (bf16: 0)")
    if tuple(y.shape) != (B, L) or not torch.isfinite(y).all():
        raise AssertionError(f"output shape {tuple(y.shape)}, finite {torch.isfinite(y).all()}")
    if len(stages) != len(codec.kernel_blocks):
        raise AssertionError(f"{len(stages)} vocoder stages ran, expected {len(codec.kernel_blocks)}")
    stage_errs, stage_scale = [], []
    for i, (xs, ys) in enumerate(stages):
        err = (ys - AR.amp_stack_plain(xs, codec.kernel_blocks[i])).abs().max().item()
        if not err <= KERNEL_TOL:
            raise AssertionError(f"main path stage {i}: kernel vs plain {err} > {KERNEL_TOL}")
        stage_errs.append(err)
        stage_scale.append(ys.abs().max().item())
    shapes = [tuple(xs.shape) for xs, _ in stages]
    y2, call_ms = timed(lambda: codec(x, BITRATE))
    repeat_err = (y2 - y).abs().max().item()

    codes = codec.encode(x, BITRATE)
    values = sorted(torch.unique(codes).tolist())
    if not set(values) <= {0.0, 0.5, 1.0}:
        raise AssertionError(f"codes take values {values}")

    # the phases of the call one at a time, and the kernel vocoder against
    # the plain generator on the same decoded mel
    Lp = codec._pad_length(L)
    n_frames = codec.frontend.num_frames(L)
    with torch.no_grad():
        mel, mel_ms = timed(lambda: codec._mel(torch.nn.functional.pad(x, (0, Lp - L))))
        T = mel.shape[1]
        bits = codec._frame_bits(BITRATE, B, L, Lp, n_frames)
        valid = (torch.arange(T, device=DEV) < n_frames).float().expand(B, T)
        (_, dec, _), scan_ms = timed(lambda: bvrnn_mod.encode_decode(
            codec.scan_params, codec.bvrnn_cfg, mel, bits, codec._h0(B), frame_valid=valid))
        dec = dec.transpose(1, 2).contiguous()
        wav_kernel, voc_ms = timed(lambda: codec._vocode(dec, Lp))
        vcfg = codec.conf.vocoder_config
        wav_plain = voc_mod.generator_apply(codec.vocoder_params, vcfg, dec, Lp)[:, 0] / SCALING
        voc_err = ((wav_kernel - wav_plain) * SCALING).abs().max().item()
        phases_err = (wav_kernel[:, :L] - y).abs().max().item()
    if not voc_err <= KERNEL_TOL:
        raise AssertionError(f"kernel vocoder vs plain generator {voc_err} > {KERNEL_TOL}")
    audio_s = B * L / codec.conf.fs
    emit("main_path", t0, batch=B, samples=L, frames=T, bitrate=BITRATE, launches=launches,
         stage_shapes=shapes, stage_kernel_vs_plain=stage_errs, stage_max_abs=stage_scale,
         first_call_ms=first_ms, call_ms=call_ms, audio_s_per_s=audio_s / call_ms * 1e3,
         mel_ms=mel_ms, scan_ms=scan_ms, vocoder_ms=voc_ms, repeat_vs_first=repeat_err,
         vocoder_kernel_vs_plain=voc_err, phases_vs_call=phases_err, code_values=values,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return launches, shapes, {"call_ms": call_ms, "audio_s_per_s": audio_s / call_ms * 1e3,
                              "scan_ms": scan_ms, "vocoder_ms": voc_ms}


def call_phases(codec: BVRNNCodecModel, x: torch.Tensor):
    """A warm call's scan and vocoder, timed one at a time: (ms, ms)."""
    B, L = x.shape
    Lp = codec._pad_length(L)
    n_frames = codec.frontend.num_frames(L)
    with torch.no_grad():
        mel = codec._mel(torch.nn.functional.pad(x, (0, Lp - L)))
        T = mel.shape[1]
        bits = codec._frame_bits(BITRATE, B, L, Lp, n_frames)
        valid = (torch.arange(T, device=DEV) < n_frames).float().expand(B, T)
        (_, dec, _), scan_ms = timed(lambda: bvrnn_mod.encode_decode(
            codec.scan_params, codec.bvrnn_cfg, mel, bits, codec._h0(B), frame_valid=valid))
        _, voc_ms = timed(lambda: codec._vocode(dec.transpose(1, 2).contiguous(), Lp))
    return scan_ms, voc_ms


def parity_states(codec: BVRNNCodecModel, x: torch.Tensor):
    """The parity path's encode inputs and its states before each frame:
    (mel, bits, h_seq, valid frames)."""
    B, L = x.shape
    Lp = codec._pad_length(L)
    n_frames = codec.frontend.num_frames(L)
    with torch.no_grad():
        mel = codec._mel(torch.nn.functional.pad(x, (0, Lp - L)))
        bits = codec._frame_bits(BITRATE, B, L, Lp, n_frames)
        _, h_seq = bvrnn_mod.encode(codec.scan_params, codec.bvrnn_cfg, mel, bits, codec._h0(B))
    return mel, bits, h_seq, n_frames


def agreement(codes: torch.Tensor, ref: torch.Tensor, bits_per_frame: int) -> dict:
    """Code agreement over every entry of the valid frames (the reference's
    measure, masked bits included) and over the transmitted bits only."""
    if tuple(codes.shape) != tuple(ref.shape):
        raise AssertionError(f"codes {tuple(codes.shape)} vs {tuple(ref.shape)}")
    values = set(torch.unique(codes).tolist())
    if not values <= {0.0, 0.5, 1.0}:
        raise AssertionError(f"codes take values {sorted(values)}")
    eq = codes == ref
    return {"all": eq.float().mean().item(), "sent": eq[..., :bits_per_frame].float().mean().item()}


def fast_path_phase(parity: BVRNNCodecModel, wav: np.ndarray, parity_times: dict):
    """The fast-serving forms on the main path's batch, checkpoint and
    vocoder; returns the bf16 kernel's launches in the 'auto' call and the
    (B, C, T) it gave each stage."""
    t0 = time.time()
    B, L = wav.shape
    x = torch.from_numpy(wav).to(DEV)
    bits_per_frame = int(parity.bits_per_frame(BITRATE))
    ref_codes = parity.encode(x, BITRATE)
    mel, bits, h_seq, n_frames = parity_states(parity, x)
    ref_wav = parity.decode(ref_codes, L)
    forms, report = {}, {}
    for name, kw in FAST_FORMS.items():
        forms[name] = BVRNNCodecModel(config=parity.conf, bvrnn_params=parity.bvrnn_params,
                                      vocoder_params=parity.vocoder_params, precision="default",
                                      length_bucket=parity.length_bucket, device=DEV, **kw)
    auto = forms["auto"]
    if not bvrnn_mod._use_fused(auto.bvrnn_cfg, B):
        raise AssertionError(f"fused_cell='auto' did not pick the fused cell at B={B}")

    AR.amp_resblock.launches = AR.amp_resblock.launches_bf16 = 0
    (y, stages), first_ms = timed(lambda: recorded_call(auto, x))
    launches = {"bf16": AR.amp_resblock.launches_bf16, "f32": AR.amp_resblock.launches}
    n_blocks = sum(len(blocks) for blocks in auto.kernel_blocks)
    if launches != {"bf16": n_blocks, "f32": 0}:
        raise AssertionError(f"fast call launches {launches}, expected bf16 {n_blocks}, f32 0")
    if tuple(y.shape) != (B, L) or not torch.isfinite(y).all():
        raise AssertionError(f"fast output shape {tuple(y.shape)}, finite {torch.isfinite(y).all()}")
    stage_errs = []
    for i, (xs, ys) in enumerate(stages):
        err = (ys - AR.amp_stack_plain(xs, auto.kernel_blocks[i], torch.bfloat16)).abs().max().item()
        if not err <= BF16_KERNEL_TOL:
            raise AssertionError(f"fast path stage {i}: bf16 kernel vs plain {err} > {BF16_KERNEL_TOL}")
        stage_errs.append(err)
    shapes = [tuple(xs.shape) for xs, _ in stages]
    decode_err = (auto.decode(ref_codes, L) - ref_wav).abs().max().item()
    if not decode_err <= FAST_WAVE_TOL:
        raise AssertionError(f"fast decode vs parity decode {decode_err} > {FAST_WAVE_TOL}")

    for name, codec in forms.items():
        yw, call_ms = timed(lambda: codec(x, BITRATE))
        if tuple(yw.shape) != (B, L) or not torch.isfinite(yw).all():
            raise AssertionError(f"{name}: output shape {tuple(yw.shape)}, finite {torch.isfinite(yw).all()}")
        codes = codec.encode(x, BITRATE)
        with torch.no_grad():
            step = bvrnn_mod.codes_from_states(codec.scan_params, codec.bvrnn_cfg, mel, bits, h_seq)
        scan_ms, voc_ms = call_phases(codec, x)
        report[name] = {"call_ms": call_ms, "audio_s_per_s": B * L / parity.conf.fs / call_ms * 1e3,
                        "scan_ms": scan_ms, "vocoder_ms": voc_ms,
                        "free_running": agreement(codes, ref_codes, bits_per_frame),
                        "per_step": agreement(step[:, :n_frames], ref_codes, bits_per_frame)}

    # the reference's bench conditions: a random-init BVRNN (seeded), whose
    # dynamics do not amplify a flip, free-running
    rand = BVRNNCodecModel(config=parity.conf, vocoder_params=parity.vocoder_params, seed=SEED,
                           length_bucket=parity.length_bucket, device=DEV)
    rand_codes = rand.encode(x, BITRATE)
    for name, kw in FAST_FORMS.items():
        codec = BVRNNCodecModel(config=parity.conf, bvrnn_params=rand.bvrnn_params,
                                vocoder_params=parity.vocoder_params, precision="default",
                                length_bucket=parity.length_bucket, device=DEV, **kw)
        report[name]["random_init"] = agreement(codec.encode(x, BITRATE), rand_codes, bits_per_frame)
    for name, r in report.items():
        for measure in ("per_step", "random_init"):
            if not r[measure]["all"] >= AGREE_MIN:
                raise AssertionError(f"{name}: {measure} code agreement {r[measure]} < {AGREE_MIN}")
    emit("fast_path", t0, batch=B, samples=L, bitrate=BITRATE, bits_per_frame=bits_per_frame,
         launches=launches, stage_shapes=shapes, stage_kernel_vs_plain=stage_errs,
         first_call_ms=first_ms, decode_vs_parity=decode_err, parity=parity_times,
         forms=report, agree_min=AGREE_MIN, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return launches["bf16"], shapes


def bound(flops: float, nbytes: float, peak_flops: float) -> tuple[float, str]:
    """Least milliseconds on an H100, and what bounds them."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check(name: str, err: float, tol: float) -> float:
    if not err <= tol:
        raise AssertionError(f"{name}: kernel vs plain {err} > {tol}")
    return err


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a - b).abs().max().item()


def gru_f64(wi, wh, bi, bh, xc, h0, steps: int) -> torch.Tensor:
    """The plain GRU steps with float64 sums, to measure how far a change of
    rounding alone moves the trajectory."""
    wid, whd = wi.double(), wh.double()
    xcb = xc.to(torch.bfloat16).double()
    h = h0.double()
    for _ in range(steps):
        hb = h.float().to(torch.bfloat16).double()
        h = PG.gru_math(torch.cat([hb, xcb], -1) @ wid + bi.double(), hb @ whd + bh.double(), h)
    return h.float()


def gru_checks(name: str, w, rest, dequant: bool) -> dict:
    """The persistent GRU against its plain version at T = 1 and T = 512,
    and its T = 512 trajectory step by step: the one launch equals 512
    chained one-step launches bit for bit, and each of those steps is
    within the one-step bound of the plain step from the same state.  With
    the probe's int8 weights, which carry no scale, the gates saturate and
    the recurrence parts between any two summation orders (the plain
    version in float32 against float64 shows it), so int8 at T = 512 is
    held by the step-by-step checks alone."""
    T = probe_gru.T
    step_tol = GRU_TOL if dequant else GRU_STEP_TOL
    out = {"step1": check(f"{name} T=1", max_err(
        PG.persistent_gru(*w, *rest, 1, dequant=dequant),
        PG.persistent_gru_plain(*w, *rest, 1, dequant=dequant)), step_tol)}
    got = PG.persistent_gru(*w, *rest, T, dequant=dequant)
    out["direct"] = max_err(got, PG.persistent_gru_plain(*w, *rest, T, dequant=dequant))
    out["plain_f32_vs_f64"] = max_err(PG.persistent_gru_plain(*w, *rest, T, dequant=dequant),
                                      gru_f64(*w, *rest, T))
    h, worst = rest[-1], 0.0
    for _ in range(T):
        nxt = PG.persistent_gru(*w, *rest[:-1], h, 1, dequant=dequant)
        worst = max(worst, max_err(nxt, PG.persistent_gru_plain(*w, *rest[:-1], h, 1,
                                                                dequant=dequant)))
        h = nxt
    out["chained_vs_one_launch"] = check(f"{name} one launch vs chained steps", max_err(got, h), 0.0)
    out["worst_step"] = check(f"{name} steps of the T={T} trajectory", worst, step_tol)
    return out


def probes_phase() -> list[dict]:
    """Both probes through their entry points, with the three kernels'
    launch counts read around them; then each kernel against its plain
    version on the probes' inputs, timed beside its bound.  Returns the
    kernels' entries of the kernels line."""
    t0 = time.time()
    counted = {"persistent_gru": PG.persistent_gru, "dot_chain": DP.dot_chain,
               "gridded_dot": DP.gridded_dot}
    for fn in counted.values():
        fn.launches = 0
    gru_ms = probe_gru.run()
    roof = probe_roof.run()
    launches = {name: fn.launches for name, fn in counted.items()}
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the probes did not launch: {launches}")
    emit("probes", t0, launches=launches, persistent_gru_ms=gru_ms, roofline=roof)
    shapes = probe_roof.make_inputs(DEV)
    return [gru_kernel(launches["persistent_gru"]),
            chain_kernel(launches["dot_chain"], shapes["chain"]),
            gridded_kernel(launches["gridded_dot"], shapes["gridded"])]


def gru_kernel(launches: int) -> dict:
    """K2 against its plain version on the probe's seeded inputs, bf16 and
    int8, and timed; returns its entry of the kernels line."""
    t0 = time.time()
    inputs = probe_gru.make_inputs()
    a = {k: torch.from_numpy(v).to(DEV) for k, v in inputs.items()}
    rest = (a["b_ih"], a["b_hh"], a["xc"], a["h0"])
    weights = {"bf16": (a["w_ih"].to(torch.bfloat16), a["w_hh"].to(torch.bfloat16)),
               "int8": (PG.quantize(inputs["w_ih"])[0].to(DEV),
                        PG.quantize(inputs["w_hh"])[0].to(DEV))}
    H, T, L = probe_gru.H, probe_gru.T, probe_gru.LANES
    plan = PG.kernel_plan(DEV, H)
    n_sm = torch.cuda.get_device_properties(DEV).multi_processor_count
    if plan != PG.plan(H, n_sm):
        raise AssertionError(f"kernel plan {plan} != {PG.plan(H, n_sm)} for {n_sm} SMs")
    flops = 2 * L * 3 * H * 3 * H * T
    fields = {}
    for dt, w in weights.items():
        dequant = dt == "int8"
        checks = gru_checks(f"persistent_gru {dt}", w, rest, dequant)
        if not dequant:  # int8: see gru_checks
            check("persistent_gru bf16 T=512", checks["direct"], GRU_TOL)
        run = lambda: PG.persistent_gru(*w, *rest, T, dequant=dequant)  # noqa: E731
        plain = lambda: PG.persistent_gru_plain(*w, *rest, T, dequant=dequant)  # noqa: E731
        nbytes = sum(t.numel() * t.element_size() for t in (*w, *rest)) + 4 * L * H
        ms = {T: cuda_ms(run, reps=10, warmup=2),
              64: cuda_ms(lambda: PG.persistent_gru(*w, *rest, 64, dequant=dequant), reps=20, warmup=2)}
        fields[dt] = {**checks, "ms": ms[T], "ms_T64": ms[64], **gru_steps.per_step(ms),
                      "bound_us_per_step": gru_steps.step_bound_us(H),
                      "plain_ms": cuda_ms(plain, reps=3, warmup=1),
                      "plain_graph_ms": graph_ms(plain, reps=1),
                      "bound": bound(flops, nbytes, PEAK_BF16_FLOPS)}
    emit("probe_kernel", t0, kernel="persistent_gru", H=H, T=T, lanes=L, plan=plan._asdict(),
         sms=n_sm, step_tol=GRU_STEP_TOL, tol=GRU_TOL, **fields)
    bf = fields["bf16"]
    return {"name": "persistent_gru", "route": "cuda", "source": "bvsc_tpu_torch/csrc/persistent_gru.cu",
            "replaces": "benchmarks/probe_persistent_gru.py:135", "launches": launches,
            "max_abs_err": bf["direct"], "ms": bf["ms"], "plain_ms": bf["plain_ms"],
            "bound_ms": bf["bound"][0], "bound_by": bf["bound"][1], "library_ms": None}


def ragged_bf16(M: int, N: int, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Seeded (M, 128) and (128, N) bf16 operands whose shapes cut tiles."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    return (torch.randn(M, DP.K, device=DEV, generator=gen).to(torch.bfloat16),
            torch.randn(DP.K, N, device=DEV, generator=gen).to(torch.bfloat16))


def chain_kernel(launches: int, chain: dict) -> dict:
    """K3 at M = 128, 256, 512 and at shapes that cut its tiles, with the
    probe's 64 products and with 1 and 3, against its plain version; its
    plan, as its build reports it, equal to ``DP.chain_plan``; timed on the
    device beside ``torch.mm`` over the stacked contraction (K = 128 x 64,
    the same sum in one call).  Returns its kernels entry."""
    t0 = time.time()
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    per_m = {}
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "err": 0.0}
    ragged = {f"{M}x{N}": ragged_bf16(M, N, SEED + i) for i, (M, N) in enumerate(CHAIN_RAGGED)}
    for M, (w, x) in [*chain.items(), *ragged.items()]:
        rel = {}
        for reps in (DP.REPS, *CHAIN_REPS):
            ref = DP.dot_chain_plain(w, x, reps)
            rel[reps] = check(f"dot_chain M={M} reps={reps}",
                              max_err(DP.dot_chain(w, x, reps), ref) / ref.abs().max().item(),
                              CHAIN_RTOL)
        if isinstance(M, str):
            per_m[M] = {"rel_err": rel}
            continue
        N = x.shape[1]
        plan = DP.dot_chain_plan(M, N)
        if plan != DP.chain_plan(M, N, sms):
            raise AssertionError(f"dot_chain plan {plan} != {DP.chain_plan(M, N, sms)} "
                                 f"for {sms} SMs")
        ref = DP.dot_chain_plain(w, x)
        library = chain_steps.library(w, x)
        nbytes = 2 * (w.numel() + x.numel()) + 4 * M * N
        b = bound(probe_roof.chain_flops(M, N), nbytes, PEAK_BF16_FLOPS)
        per_m[M] = {"rel_err": rel, "abs_err": rel[DP.REPS] * ref.abs().max().item(), "plan": plan,
                    "ms": graph_ms(lambda: DP.dot_chain(w, x)),
                    "call_ms": cuda_ms(lambda: DP.dot_chain(w, x)),
                    "plain_ms": graph_ms(lambda: DP.dot_chain_plain(w, x)),
                    "plain_call_ms": cuda_ms(lambda: DP.dot_chain_plain(w, x)),
                    "library_ms": graph_ms(library),
                    "library_rel_err": max_err(library(), ref) / ref.abs().max().item(),
                    "bound_ms": b[0], "bound_by": b[1]}
        per_m[M]["share_of_bound"] = b[0] / per_m[M]["ms"]
        for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
            tot[key] += per_m[M][key]
        tot["err"] = max(tot["err"], per_m[M]["abs_err"])
    emit("probe_kernel", t0, kernel="dot_chain", rtol=CHAIN_RTOL, sms=sms,
         share_of_bound=tot["bound_ms"] / tot["ms"], **{str(k): v for k, v in per_m.items()})
    return {"name": "dot_chain", "route": "cuda", "source": "bvsc_tpu_torch/csrc/dot_probe.cu",
            "replaces": "benchmarks/probe_roofline.py:20", "launches": launches,
            "max_abs_err": tot["err"], "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": "operations", "library_ms": tot["library_ms"]}


def gridded_kernel(launches: int, operands) -> dict:
    """K4 at the probe's shape and at shapes that cut its tiles against its
    plain version; its plan, as its build reports it, held to one block on
    each SM; timed on the device beside ``torch.mm`` (bf16 in, float32
    out) with the L2 warm (``graph_ms``) and cold (``cold_ms``).  Returns
    its kernels entry (``ms`` is the warm time)."""
    t0 = time.time()
    w, x = operands
    M, N = w.shape[0], x.shape[1]
    err = check("gridded_dot", max_err(DP.gridded_dot(w, x), DP.gridded_dot_plain(w, x)), GRIDDED_TOL)
    ragged = {}
    for i, (Mr, Nr) in enumerate(GRIDDED_RAGGED):
        wr, xr = ragged_bf16(Mr, Nr, SEED + 1 + i)
        ragged[f"{Mr}x{Nr}"] = check(f"gridded_dot {Mr}x{Nr}", max_err(
            DP.gridded_dot(wr, xr), DP.gridded_dot_plain(wr, xr)), GRIDDED_TOL)
    plan = DP.gridded_plan(M, N)
    if plan["grid"] != torch.cuda.get_device_properties(w.device).multi_processor_count:
        raise AssertionError(f"gridded_dot plan {plan}: the probe's {M} x {N} should launch one "
                             "block on each SM (its shared memory holds one block an SM)")
    library = lambda: torch.mm(w, x, out_dtype=torch.float32)  # noqa: E731
    lib_err = max_err(library(), DP.gridded_dot_plain(w, x))
    nbytes = 2 * (w.numel() + x.numel()) + 4 * M * N
    b = bound(probe_roof.gridded_flops(N), nbytes, PEAK_BF16_FLOPS)
    kernel = lambda: DP.gridded_dot(w, x)  # noqa: E731
    k4 = {"max_abs_err": err, "ragged_err": ragged, "library_err": lib_err,
          "ms": graph_ms(kernel), "cold_ms": cold_ms(kernel), "call_ms": cuda_ms(kernel),
          "plain_ms": graph_ms(lambda: DP.gridded_dot_plain(w, x)),
          "plain_call_ms": cuda_ms(lambda: DP.gridded_dot_plain(w, x)),
          "library_ms": graph_ms(library), "library_cold_ms": cold_ms(library),
          "library_call_ms": cuda_ms(library),
          "bound_ms": b[0], "bound_by": b[1], "bytes": nbytes}
    emit("probe_kernel", t0, kernel="gridded_dot", shape=[M, DP.K, N], tol=GRIDDED_TOL, plan=plan,
         **k4)
    return {"name": "gridded_dot", "route": "cuda", "source": "bvsc_tpu_torch/csrc/dot_probe.cu",
            "replaces": "benchmarks/probe_roofline.py:45", "launches": launches,
            **{k: k4[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}


def main() -> None:
    name, clock_mhz = device_phase()
    snake = build_phase(clock_mhz)
    set_parity_mode()
    torch.matmul(torch.ones(8, 8, device=DEV), torch.ones(8, 8, device=DEV))  # cuBLAS set-up
    wav = load_batch()

    t0 = time.time()
    conf = load_config(DEFAULT_CONFIG)
    codec = BVRNNCodecModel(config=conf, bvrnn_chkpt_path=NPZ,
                            vocoder_params=seeded_vocoder(conf.vocoder_config, SEED), device=DEV)
    emit("model", t0, h_dim=codec.conf.h_dim, z_dim=codec.conf.z_dim,
         vocoder_channels=codec.conf.vocoder_config.upsample_initial_channel)

    launches, shapes, parity_times = main_path_phase(codec, wav)
    launches_bf16, shapes_bf16 = fast_path_phase(codec, wav, parity_times)
    totals = kernel_phase(codec, shapes)
    totals_bf16 = kernel_phase(codec, shapes_bf16, torch.bfloat16, snake)
    for kernel, tot in (("amp_resblock", totals), ("amp_resblock_bf16", totals_bf16)):
        emit("kernel_total", time.time(), kernel=kernel,
             **{key: v for key, v in tot.items() if key != "bound_by"})
    probe_entries = probes_phase()

    def k1_entry(name, source, replaces, n, tot):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n, "max_abs_err": tot["max_abs_err"], "ms": tot["ms"],
                "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
                "bound_by": "/".join(sorted(tot["bound_by"])), "library_ms": None}

    print(json.dumps({"kernels": [
        k1_entry("amp_resblock", "bvsc_tpu_torch/csrc/amp_resblock.cu",
                 "bvsc_tpu/ops/pallas_voc.py:240", launches, totals),
        k1_entry("amp_resblock_bf16", "bvsc_tpu_torch/csrc/amp_resblock_bf16.cu",
                 "bvsc_tpu/ops/pallas_voc.py:240 (compute_dtype=bfloat16)", launches_bf16,
                 totals_bf16),
        *probe_entries]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
