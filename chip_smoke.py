#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds:

1. ``device``: the card's name and ``nvidia-smi``'s name and power limit
   (also printed raw on a line of its own).  Without a card the script
   exits non-zero and prints no result.
2. ``build``: nvcc builds every CUDA source of ``bvsc_tpu_torch/csrc``
   into the gitignored ``bvsc_tpu_torch/_build``.
3. ``main_path``: ``BVRNNCodecModel`` at full width (the shipped BVRNN
   checkpoint, a seeded full-width vocoder) resynthesises a batch of 4
   waveforms at 3 kbps; the kernels' launch counts are read around that
   one call, which also keeps every vocoder stage's input and kernel
   output.  Checks shape, finiteness, codes in {0, 0.5, 1}, each stage's
   kernel output against the plain version on the same input, and the
   kernel vocoder against the plain generator on the same decoded mel.
4. ``kernel``: each kernel's wrapper against its plain PyTorch version on
   the card, at the shapes the main path gave it (float32, TF32 off), on
   seeded inputs, timed with CUDA events, beside its least possible time
   on an H100.

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
from bvsc_tpu_torch.codec import DEFAULT_CONFIG, SCALING
from bvsc_tpu_torch.device import set_parity_mode
from bvsc_tpu_torch.models import bvrnn as bvrnn_mod
from bvsc_tpu_torch.models import vocoder as voc_mod
from bvsc_tpu_torch.ops import _build
from bvsc_tpu_torch.ops import amp_resblock as AR

REPO = os.path.dirname(os.path.abspath(__file__))
NPZ = os.path.join(REPO, "chkpts", "bvsc_bvrnn_demo_augfull_step1800_f16.npz")
WAV = os.path.join(REPO, "docs", "artifacts", "demo_stim15_3kbps.wav")
DEV = torch.device("cuda")
BATCH = 4
BITRATE = 3000
SEED = 0

# Published H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor
# cores, and HBM bandwidth.  The least time of a function is the larger of
# its FLOPs over the first and its bytes over the second.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
KERNEL_TOL = 1e-4  # float32, summation order differs over 6 chained convs
REPS, WARMUP = 20, 3


def emit(phase: str, t0: float, **fields) -> None:
    print(json.dumps({"phase": phase, **fields, "seconds": time.time() - t0}), flush=True)


def cuda_ms(fn, reps: int = REPS, warmup: int = WARMUP) -> float:
    """Mean milliseconds of ``fn`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def seeded_vocoder(vcfg) -> dict:
    """A random full-width vocoder from SEED, with per-channel snake
    parameters drawn too (the init sets them all to 0), so that the kernel's
    channel indexing is exercised."""
    params = voc_mod.init_generator_params(SEED, vcfg)
    rng = np.random.default_rng(SEED + 1)
    for act in [a for block in params["resblocks"] for a in block["acts"]] + [params["act_post"]]:
        for key in ("alpha", "beta"):
            act[key] = (0.3 * rng.standard_normal(act[key].shape)).astype(np.float32)
    return params


def stage_bound_ms(stage_blocks, B: int, T: int) -> tuple[float, str]:
    """Least time of one vocoder stage (its resblocks and their average):
    conv FLOPs (2 C^2 k per output sample, 6 convs per block) against the
    input read once, the output written once and the weights read once."""
    C = stage_blocks[0].channels
    flops = sum(6 * 2 * C * C * rb.kernel_size for rb in stage_blocks) * B * T
    weights = sum(t.numel() for rb in stage_blocks
                  for t in (rb.w1, rb.b1, rb.w2, rb.b2, rb.alpha, rb.inv_beta))
    nbytes = 4 * (2 * B * C * T + weights)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def device_phase() -> str:
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
    emit("device", t0, name=name, nvidia_smi=smi, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    return name


def build_phase() -> None:
    t0 = time.time()
    for name in _build.sources():
        _build.load(name)
    emit("build", t0, libraries=[os.path.relpath(_build.library_path(name), REPO)
                                 for name in _build.sources()])


def kernel_phase(codec: BVRNNCodecModel, stage_shapes) -> dict:
    """Kernel against plain at each stage's (B, C, T) from the main path,
    on seeded inputs; returns the summed numbers for the kernels line."""
    total = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": set()}
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    for stage, (B, C, T) in enumerate(stage_shapes):
        t0 = time.time()
        blocks = codec.kernel_blocks[stage]
        x = 0.3 * torch.randn(B, C, T, device=DEV, generator=gen)
        got = AR.amp_stack(x, blocks)
        ref = AR.amp_stack_plain(x, blocks)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        if not err <= KERNEL_TOL:
            raise AssertionError(f"stage {stage}: kernel vs plain {err} > {KERNEL_TOL}")
        ms = cuda_ms(lambda: AR.amp_stack(x, blocks))
        plain_ms = cuda_ms(lambda: AR.amp_stack_plain(x, blocks))
        bound, bound_by = stage_bound_ms(blocks, B, T)
        emit("kernel", t0, kernel="amp_resblock", stage=stage, shape=[B, C, T],
             last_tile=T % AR.tile_for(C) or AR.tile_for(C), launches_per_stage=len(blocks), max_abs_err=err, tol=KERNEL_TOL, ms=ms,
             plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
             roofline_share=bound / ms)
        total["max_abs_err"] = max(total["max_abs_err"], err)
        total["ms"] += ms
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

    def stage(xs, blocks):
        ys = AR.amp_stack(xs, blocks)
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
    AR.amp_resblock.launches = 0
    (y, stages), first_ms = timed(lambda: recorded_call(codec, x))
    launches = AR.amp_resblock.launches
    n_blocks = sum(len(blocks) for blocks in codec.kernel_blocks)
    if launches < n_blocks:
        raise AssertionError(f"amp_resblock launched {launches} times in the main path, "
                             f"expected at least {n_blocks}")
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
            codec.bvrnn_params, codec.bvrnn_cfg, mel, bits, codec._h0(B), frame_valid=valid))
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
    return launches, shapes


def main() -> None:
    name = device_phase()
    build_phase()
    set_parity_mode()
    torch.matmul(torch.ones(8, 8, device=DEV), torch.ones(8, 8, device=DEV))  # cuBLAS set-up
    wav = load_batch()

    t0 = time.time()
    conf = load_config(DEFAULT_CONFIG)
    codec = BVRNNCodecModel(config=conf, bvrnn_chkpt_path=NPZ,
                            vocoder_params=seeded_vocoder(conf.vocoder_config), device=DEV)
    emit("model", t0, h_dim=codec.conf.h_dim, z_dim=codec.conf.z_dim,
         vocoder_channels=codec.conf.vocoder_config.upsample_initial_channel)

    launches, shapes = main_path_phase(codec, wav)
    totals = kernel_phase(codec, shapes)

    print(json.dumps({"kernels": [{
        "name": "amp_resblock",
        "route": "cuda",
        "source": "bvsc_tpu_torch/csrc/amp_resblock.cu",
        "replaces": "bvsc_tpu/ops/pallas_voc.py:240",
        "launches": launches,
        "max_abs_err": totals["max_abs_err"],
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": "/".join(sorted(totals["bound_by"])),
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
