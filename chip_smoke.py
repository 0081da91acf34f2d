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
5. ``probes``: the two benchmark probes (``bvsc_tpu_torch.benchmarks``)
   run through their ``run()`` entry points with the kernels' launch counts
   read around them; then the persistent GRU (bf16 and int8, H = 1024,
   T = 512, 8 rows), the dot chain (M = 128, 256, 512) and the gridded dot
   (128 x 128 x 32 768) against their plain versions on the probes' own
   inputs, and timed beside their bounds and, for the gridded dot,
   ``torch.mm``.

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
from bvsc_tpu_torch.benchmarks import cuda_ms, graph_ms
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
# Persistent GRU, one step: the same bf16 operands, only the order of the
# float32 sums differs.
GRU_STEP_TOL = 1e-5
# Persistent GRU over 512 steps in bf16: a 1e-7 gap in h can flip one bf16
# rounding of h (~2e-3) and feed back.  Also the int8 one-step bound: the
# probe's int8 weights carry no scale, so gate sums reach ~1e4, whose float32
# rounding (~1e-3) moves the gates that are not saturated.
GRU_TOL = 2e-2
CHAIN_RTOL = 1e-5  # of max |out|: 64 float32 additions in another order
GRIDDED_TOL = 1e-4  # one product, K = 128 in float32


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
    _build.load_all()
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
        fields[dt] = {**checks, "ms": cuda_ms(run, reps=10, warmup=2),
                      "plain_ms": cuda_ms(plain, reps=3, warmup=1),
                      "plain_graph_ms": graph_ms(plain, reps=1),
                      "bound": bound(flops, nbytes, PEAK_BF16_FLOPS)}
    emit("probe_kernel", t0, kernel="persistent_gru", H=H, T=T, lanes=L, plan=plan, sms=n_sm,
         step_tol=GRU_STEP_TOL, tol=GRU_TOL, **fields)
    bf = fields["bf16"]
    return {"name": "persistent_gru", "route": "cuda", "source": "bvsc_tpu_torch/csrc/persistent_gru.cu",
            "replaces": "benchmarks/probe_persistent_gru.py:133", "launches": launches,
            "max_abs_err": bf["direct"], "ms": bf["ms"], "plain_ms": bf["plain_ms"],
            "bound_ms": bf["bound"][0], "bound_by": bf["bound"][1], "library_ms": None}


def ragged_bf16(M: int, N: int, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Seeded (M, 128) and (128, N) bf16 operands whose shapes cut tiles."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    return (torch.randn(M, DP.K, device=DEV, generator=gen).to(torch.bfloat16),
            torch.randn(DP.K, N, device=DEV, generator=gen).to(torch.bfloat16))


def chain_kernel(launches: int, chain: dict) -> dict:
    """K3 at M = 128, 256, 512 (and a ragged shape for the masks) against
    its plain version, timed on the device; returns its kernels entry."""
    t0 = time.time()
    per_m, tot = {}, {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "err": 0.0}
    for M, (w, x) in [*chain.items(), ("ragged", ragged_bf16(40, 200, SEED))]:
        ref = DP.dot_chain_plain(w, x)
        rel = max_err(DP.dot_chain(w, x), ref) / ref.abs().max().item()
        check(f"dot_chain M={M}", rel, CHAIN_RTOL)
        if M == "ragged":
            per_m[M] = {"shape": [w.shape[0], x.shape[1]], "rel_err": rel}
            continue
        nbytes = 2 * (w.numel() + x.numel()) + 4 * M * x.shape[1]
        b = bound(probe_roof.chain_flops(M, x.shape[1]), nbytes, PEAK_BF16_FLOPS)
        per_m[M] = {"rel_err": rel, "abs_err": rel * ref.abs().max().item(),
                    "ms": graph_ms(lambda: DP.dot_chain(w, x)),
                    "call_ms": cuda_ms(lambda: DP.dot_chain(w, x)),
                    "plain_ms": graph_ms(lambda: DP.dot_chain_plain(w, x)),
                    "plain_call_ms": cuda_ms(lambda: DP.dot_chain_plain(w, x)),
                    "bound_ms": b[0], "bound_by": b[1]}
        tot["ms"] += per_m[M]["ms"]
        tot["plain_ms"] += per_m[M]["plain_ms"]
        tot["bound_ms"] += b[0]
        tot["err"] = max(tot["err"], per_m[M]["abs_err"])
    emit("probe_kernel", t0, kernel="dot_chain", rtol=CHAIN_RTOL, **{str(k): v for k, v in per_m.items()})
    return {"name": "dot_chain", "route": "cuda", "source": "bvsc_tpu_torch/csrc/dot_probe.cu",
            "replaces": "benchmarks/probe_roofline.py:20", "launches": launches,
            "max_abs_err": tot["err"], "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": "operations", "library_ms": None}


def gridded_kernel(launches: int, operands) -> dict:
    """K4 (and a ragged shape) against its plain version, timed on the
    device beside ``torch.mm`` (bf16 in, float32 out); returns its kernels
    entry."""
    t0 = time.time()
    w, x = operands
    err = check("gridded_dot", max_err(DP.gridded_dot(w, x), DP.gridded_dot_plain(w, x)), GRIDDED_TOL)
    wr, xr = ragged_bf16(200, 1000, SEED + 1)
    ragged_err = check("gridded_dot ragged", max_err(DP.gridded_dot(wr, xr),
                                                     DP.gridded_dot_plain(wr, xr)), GRIDDED_TOL)
    library = lambda: torch.mm(w, x, out_dtype=torch.float32)  # noqa: E731
    lib_err = max_err(library(), DP.gridded_dot_plain(w, x))
    nbytes = 2 * (w.numel() + x.numel()) + 4 * w.shape[0] * x.shape[1]
    b = bound(probe_roof.gridded_flops(x.shape[1]), nbytes, PEAK_BF16_FLOPS)
    k4 = {"max_abs_err": err, "ragged_err": ragged_err, "library_err": lib_err,
          "ms": graph_ms(lambda: DP.gridded_dot(w, x)), "call_ms": cuda_ms(lambda: DP.gridded_dot(w, x)),
          "plain_ms": graph_ms(lambda: DP.gridded_dot_plain(w, x)),
          "plain_call_ms": cuda_ms(lambda: DP.gridded_dot_plain(w, x)),
          "library_ms": graph_ms(library), "library_call_ms": cuda_ms(library),
          "bound_ms": b[0], "bound_by": b[1], "bytes": nbytes}
    emit("probe_kernel", t0, kernel="gridded_dot", shape=[w.shape[0], DP.K, x.shape[1]],
         tol=GRIDDED_TOL, **k4)
    return {"name": "gridded_dot", "route": "cuda", "source": "bvsc_tpu_torch/csrc/dot_probe.cu",
            "replaces": "benchmarks/probe_roofline.py:45", "launches": launches,
            **{k: k4[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}


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
    probe_entries = probes_phase()

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
    }, *probe_entries]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
