#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds:

1. ``device``: the card's name and ``nvidia-smi``'s name and power limit
   (also printed raw on a line of its own).  Without a card the script
   exits non-zero and prints no result.
2. ``build``: nvcc builds every CUDA source of ``bvsc_tpu_torch/csrc``
   into the gitignored ``bvsc_tpu_torch/_build``, and ``cc`` the host C
   sources of ``bvsc_tpu_torch/native`` (bit packing, rANS, the prior
   coder's fixed-order products; a missing one fails the run, so no numpy
   path is taken on the card's host); ``cuobjdump`` counts the
   float32-pipe instructions of one snake on its fast path in the bf16
   build's SASS (``k1_tiles.snake_instructions``).
3. ``main_path``: ``BVRNNCodecModel`` at full width (the shipped BVRNN
   checkpoint and the trained vocoder, both from their flat ``.npz``
   files) resynthesises a batch of 4 waveforms at 3 kbps; the kernels' launch counts are read around that
   one call, which also keeps every vocoder stage's input and kernel
   output.  Checks shape, finiteness, codes in {0, 0.5, 1}, each stage's
   kernel output against the plain version on the same input, and the
   kernel vocoder against the plain generator on the same decoded mel.
4. ``fast_path``: the same batch and checkpoint with a seeded full-width
   vocoder, at ``precision='default'`` (fast serving) in four forms: ``fused_cell``
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
   checkpoint is printed too, and the fast ``decode``'s gap from the parity
   one with the trained vocoder (no gate: the 2e-2 contract was set on the
   seeded one).
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
   Then ``antialias``: the anti-aliased activation kernel
   (``ops.resample.activation1d_kernel``) against the plain
   ``Activation1d`` chain (TF32 off) at each stage shape of the
   ``varbit-bigvgan-f32.offline-b32`` cell (B = 32, 517 frames, C 768 ->
   24), seeded SnakeBeta parameters: max error over the output's peak in
   both sin^2 modes (at most 2e-6), the kernel's and the chain's ms (CUDA
   events; also on the stage input as the generator hands it, a view
   trimmed at both ends, read in place and bitwise its contiguous copy's
   result; and the bf16 build's ms, its output bitwise the float32
   build's rounded) beside the bytes bound
   (``portbench.aa_counts.aa_bound_s``), every launch counted in
   ``vocoder.aa_kernel``; an ``antialias_total`` line sums a cell call's
   109 activations (18 a stage, 3 of them on the trimmed input, one more at
   the last).  First, one call of the BigVGAN codec
   (``configs/varbitrate_bigvgan.toml``, the shipped BVRNN, a seeded
   vocoder) on a second of the batch's first two rows makes 109
   ``vocoder.aa`` spans and 109 ``vocoder.aa_kernel`` launches, in float32
   and at ``precision='default'`` (the bf16 vocoder segment), and one of
   the parity codec none of either (``antialias_codec``).
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
7. ``plc``: packet-loss concealment, ``decode(lost=, conceal_bitrate=)``,
   on the main path's batch, codes and trained pair, at parity and in fast
   ``'auto'`` mode (the fused cell at B=4).  Each stream loses ~10 % of its
   frames (seeded Bernoulli) and one 5-frame burst; stream 0 conceals at
   3 kbps, the others with all 64 bits.  The K1 launch counts are read
   around each lossy call (12 float32 at parity, 12 bf16 in fast mode).
   Checks: no loss is bitwise ``decode``; the mel and the waveform are
   bitwise the clean decode's before each stream's first lost frame; at
   parity one concealed frame equals the prior at the state before it,
   masked and substituted by hand, to 1e-4; the TF32 flags are unchanged.
   Prints, with no gate, the mel-L1 against the clean decode of
   ``'expect'``, ``'map'`` and 0.5-fill concealment, and the milliseconds
   of ``decode`` and of ``decode(lost=)`` in each mode (CUDA events around
   single calls taken in turns; median, least and most of 5).

8. ``golden``: the parity codec (trained pair) at B = 1 on the demo
   utterance (58 239 samples, 3 kbps) against the goldens ``bvsc_tpu``
   wrote (``tools/write_goldens.py`` ->
   ``chkpts_npz/golden_demo_stim15_3kbps.npz``, read with numpy):
   ``decode_to_mel`` of the golden codes within 1e-4 of the golden mel
   (the gap printed beside the CPU gate of 2e-5), ``decode`` of them at
   SNR > 40 dB against the golden waveform, and ``encode``'s codes
   bit-exact (the flipped bits counted, with the first one's frame and
   |enc - 0.5|); resynthesis's SNR against the golden waveform printed.
9. ``streaming``: ``bvsc_tpu_torch.streaming`` on the main path's batch and
   trained pair, at parity and in fast ``'auto'`` mode, against the same
   codec's one-shot calls.  ``FusedPacketCodec`` in 256-sample packets and
   ``flush()`` against ``codec(x)`` (1e-5 parity, 7e-2 fast), its codes
   against ``encode``'s and the K1 launch counts read around it (12 a step
   in the mode's kernel, 0 in the other); ``StreamingEncoder`` at chunks
   of 256, 1 000 and 4 096 against ``encode`` (bitwise at parity, the
   agreement printed in fast mode); the first code at sample 768;
   ``StreamingDecoder`` frame by frame against ``decode``, clean and with
   ``plc``'s losses (stream 0 concealed at 3 kbps), both 1e-5 at parity
   and 7e-2 fast.  Codes and waveforms are held on the frames whose
   analysis window lies inside the input: the last two read the reflected
   tail in a stream and the length bucket's zeros one-shot (their gaps are
   printed).  Then each stage's streamed kernel output against the
   one-shot kernel output on the same seeded signal (bit-equality and the
   largest gap printed), the kernel stage with ``ctx``/``start`` against
   its plain version on one packet's windows (the first packet's and a
   later one's, and with per-row starts) within the kernel tolerances,
   and, at M = B rows against M = B x frames, the bits of each product the
   one-shot scan hoists over the frames.  Times, no limit: ms per packet
   step (host wall time, synchronised; median and p90 of 50 steps after
   10) at B = 1 and 4 in both modes, the vocoder step alone with kernel
   and with plain stages, and the real-time factor against the 11.61 ms a
   packet lasts.  The TF32 flags are unchanged at its end.
10. ``serving``: ``bvsc_tpu_torch.serve`` at 128 slots on the trained pair.
    A ``ServingEngine(max_streams=128)`` at parity and in fast ``'auto'``
    mode (the standard cell at 128 slots) runs a schedule of 24 live
    streams (seeded noisy crops of the demo of 20 000 to 54 753 samples, one
    opened every 3 ticks at 1 000 / 3 000 / 5 512.5 bps, one 256-sample
    packet a tick, ``begin_flush`` after the last, closed once drained);
    stream 1 switches to 1 kbps after its 60th frame, and stream 5's slot is
    reopened with its input when it ends.  The K1 launch counts are read
    around each run (12 a tick in the mode's kernel, 0 in the other).  Held:
    streams 0, 1, 2 and 23 against a dedicated B = 1 ``FusedPacketCodec``
    with ``flush()`` on the same input and bitrates (at parity codes bitwise
    and audio <= 1e-5 on the frames inside the input; fast against a B = 1
    codec with ``fused_cell=False``, audio <= 7e-2, the code agreement
    printed), and the reopened slot bitwise its first run.  A
    ``DecodeEngine(max_streams=128)`` at parity decodes the main path's
    codes with ``plc``'s losses on four slots: each within 1e-5 of a B = 1
    ``StreamingDecoder(lost=)``, bitwise a clean engine run's before its
    first loss, 12 K1 launches a tick.  A ``CodecDaemon(max_streams=128)`` on
    loopback serves six concurrent clients: three of the port's client
    (resynthesis, encoding, decoding with losses), the same encoding and
    decoding with ``entropy=True`` (the ``FLAG_ENTROPY`` wire option), and
    the encoding through ``bvsc_tpu``'s native C client's ``encode-ent``
    (built with ``cc`` from its C source): the wire output bitwise equal to
    direct engine runs and the entropy wire's to the raw wire's, every
    ``CODES_ENT_OUT`` body of the C client byte for byte the port's
    ``AdaptiveCodesCoder`` on the same block partition, and the entropy
    clients' raw and wire bytes printed (no gate: savings depend on the
    model); the daemon is closed.  Times, no limit: ms
    per tick (median and p90 of 50 after 10) at 1, 32 and 128 active
    streams of 128 slots, for both engines in both modes, each split into
    the device step (``_tick_call``, synchronised) and the host's part; at
    128 the device time of 10 more ticks from a ``torch.profiler`` trace
    (and the idle share), K1 / K1-bf16 on one tick's stage windows against
    plain (with the tick's and with per-row starts; float32 within 1e-4,
    bf16 within the plain bf16 stack's own distance from the float32
    stage) and timed, and the streams served in real time, 128 x 11.61 /
    (tick ms).  The TF32 flags
    are unchanged at its end; the phase prints its line, then fails if any
    gate did.
11. ``direct_path``: the codec's direct vocoder path
    (``BVRNNCodecModel(use_pallas=False)``: cuDNN convs and elementwise
    torch, no kernel) on the trained pair and the main path's batch, at
    parity and fast (``approx_snake`` and the bf16 vocoder segment, the
    reference's fast defaults).  The K1 launch counts of both modes are
    read around every direct call (``encode``, ``__call__``, ``decode``,
    the stream, the ticks, the variants): 0.  Codes bitwise the kernel
    path's codec's at the same precision; the parity waveform within 1e-4
    of the K1 codec's (TF32 off); the fast ``decode`` of the parity codes
    within 2e-2 of the parity ``decode`` (the reference's contract); 24
    packets of the demo through a fast ``FusedPacketCodec``, an 8-slot
    fast ``ServingEngine``, a ``StreamingDecoder`` and an 8-slot fast
    ``DecodeEngine``, each within 7e-2 of the offline fast ``decode`` of
    the same codes (the reference's fast streaming contract; the gaps
    printed), and the same packets through a parity ``FusedPacketCodec``
    within 1e-5 of the parity call on the frames inside the input; the
    symmetric and the
    anti-aliased full-width generators (the trained vocoder's weights) on
    the first 32 frames of the batch's decoded mel, card against CPU within
    1e-4 in float32.  Printed, no gate: the ms of a direct call beside the
    K1 call, and the variants' ms.  (Phase ``parallel`` runs the direct
    path under SP and PP.)
12. ``entropy``: ``.bvsc`` files (``bvsc_tpu_torch.cli.codec_cli``) on the
    trained pair at parity, on the demo utterance encoded on the card at
    3 kbps and with a VBR schedule (1 / 3 / 5.5 kbps, a third of the frames
    each).  Each is written as version 1 (raw packing) and version 3 (rANS
    against the BVRNN's prior, ``bvsc_tpu_torch.entropy``: a fixed-order
    float64 pass on the host) and read back: the codes bitwise
    ``encode``'s, and ``decode`` of them bitwise ``decode`` of the encoded
    codes, with 12 K1 launches a call.  The CLI runs as a user runs it, in
    subprocesses on the card beside that work (``encode --entropy``, then
    ``decode``): its file is the in-process version 3 file and its wav within 1e-6 of the
    in-process decode written the same way.  The version 3 payload of the
    golden codes has the SHA-256 that ``tests/test_torch_entropy.py``
    asserts on the CPU (the same bytes on both machines) and a size within
    1 % of ``bvsc_tpu``'s 912 bytes.  Printed, no gate: the files' sizes,
    the coder's ms per frame writing and reading, and rANS MB/s native
    against numpy.

13. ``export``: AOT serving bundles (``bvsc_tpu_torch.serve.export``) on
    the trained pair.  Three processes of the export CLI
    (``cli/export_cli.py``), started before phase ``serving`` to run beside
    it, ``direct_path`` and ``entropy``, export a parity and a fast
    ``'auto'`` one on the card and a parity one on the CPU; each has
    the one-shot programs at B = 4 on the bucket of the demo batch's first
    16 384 samples (not the CPU one), the packet programs at batch 1 and
    the engines' ticks at 128 slots, in a temporary directory removed at
    the end.  Each bundle loads onto the card and each program is held
    against the same codec live: ``encode`` bitwise, ``decode``,
    ``forward``, ``vocode``, the packet step (its codes bitwise) and the
    receiver's step with ``plc``'s losses within 1e-6 (the reference's
    bound; bitwise is printed), 12 K1 launches (K1-bf16 in fast mode) per
    ``forward``, ``decode``, packet step and tick, counted through the op;
    the ``serving`` phase's 24-stream schedule through
    ``BundleServingEngine`` and its decode run through
    ``BundleDecodeEngine`` against the live engines' (codes bitwise, audio
    within 1e-6).  The CPU-traced bundle's packet step and both ticks on
    the card are bitwise the card-traced bundle's.  A ``CodecDaemon`` of
    the parity bundle serves three clients (resynthesis, an entropy-coded
    encode, a decode with losses), bitwise the live daemon's wire.
    Printed: export seconds and bytes per program, load seconds per
    program, each bundle's bytes per member, ms per tick at 128 active of
    the live and the bundle engine (median and p90 of 30 in turns), and a
    launch's host microseconds through the op and through its direct
    implementation (``ops.amp_resblock.launch``), on one tick's windows.
    The daemon is closed and the CLI processes stopped before it ends.

14. ``train``: both trainers at the full width of the default config, on
    the demo utterance (a filelist the phase writes; speed and gain
    augmentation, ``cli/train_bvrnn.py``'s ``--augment``), in a temporary
    directory removed at the end.  BVRNN (``train.bvrnn_train``): one step
    at B = 2 on 0.5-s segments on the card against the port's CPU step from
    the same weights and draws (loss <= 1e-5 relative, gradient norm
    <= 1e-4, updated params <= 1e-5); 6 float32 steps at batch 32 on 4.0-s
    segments (344 frames), every loss finite and the mean of the last 3
    below the first; the fused cell and bf16 compute from the same weights
    and first batch, their first loss within the reference's 5 % of the
    standard's; 2 steps, a checkpoint, a restore into a new trainer and 2
    more bitwise 4 unbroken steps (batch 4, with ``mel_mask``).  The
    full-size run's params go through ``cli/export_bvrnn_npz.py`` into
    ``BVRNNCodecModel`` with the trained vocoder: the demo resynthesised at
    3 kbps with 12 K1 launches, finite.  GAN (``train.vocoder_train``,
    ``GANTrainConfig`` defaults: batch 32, segment 8192, ``freeze_step`` 1),
    the generator warm-started from the trained vocoder's ``.npz`` as
    ``--init_generator`` does it: the first step's D and G losses on the
    card against the CPU at B = 2 (<= 1e-4 relative); 3 steps, D unchanged
    at step 0 and changed at step 1, every loss finite; one fine-tuning
    step on the trained BVRNN's ``decode_to_mel`` of the same crops.  Both
    trainer CLIs through their ``main`` in this process (phases
    ``parallel`` and ``eval`` start them as processes), 2 steps, then each
    resumed to 4.  Printed: the
    card-against-CPU gaps and ms a step of each mode beside ``nvidia-smi``'s
    line.

15. ``parallel``: ``bvsc_tpu_torch.parallel`` with two ranks sharing the
    one card over gloo (NCCL refuses two ranks on one card), spawned by
    ``parallel.dryrun.run_ranks`` from a thread before phase ``train``, so
    that they run beside it (its line follows ``train``'s; its
    ``start_seconds``, ``ranks_seconds`` and ``finish_seconds`` split its
    time); a failed rank or a collective that times out fails the phase.  On the ranks, at full width on the trained pair
    and the main path's batch (B = 4, 256 frames, 3 kbps): ``encode_tp``
    and ``decode_tp`` against the one-device ``encode`` / ``decode`` of the
    standard cell (codes bitwise, each flipped code listed with its
    distance from 0.5; mel and h within 2e-5); ``generator_apply_sp`` over
    2 shards of the decoded mel against ``generator_apply_kernel`` (1e-5;
    12 K1 launches a shard); ``pipeline_resynth`` on 3 microbatches of 64
    frames against the unpipelined run (codes bitwise, waveform 1e-6, 12 K1
    launches a microbatch on stage 1); the same SP and pipeline on the
    direct path (``use_pallas=False``, and fast with ``approx_snake`` and
    bf16 products; ``pipeline_resynth(approx_snake=True)``) against the
    one-device direct generator (SP 1e-5 exact, 2e-2 fast; PP codes
    bitwise, waveform 1e-6; 0 K1 launches); one data-parallel step of each
    trainer at full width (BVRNN on 4 x 0.5-s mels, the GAN twice on 4 x
    8 192 crops, D frozen at step 0) against one rank's step on the global
    batch (metrics 1e-5 relative, parameters 1e-5, those whose gradient is
    within float noise of 0 left out and counted).  In this process: the
    four engines at 128 slots with ``mesh`` over [card, card] (64 slots a
    block, streams alternating between the blocks) against unsharded ones
    (codes bitwise, audio 1e-5; 12 K1 launches a block a tick), the bundle
    ones on phase ``export``'s parity bundle (kept for this).  From the
    start of the ranks to the end of the engines, ``cli.train_bvrnn`` as
    two processes of one run (2 steps): equal losses on both ranks and rank
    0's checkpoint loading.  The ranks' and phase ``train``'s times are
    each other's neighbours', so neither says what it costs alone.  Printed
    beside
    ``nvidia-smi``'s line: ms per TP frame and per SP call next to one
    device's, labelled as two ranks on one card (no scaling claim).

16. ``eval``: the eval metrics (``bvsc_tpu_torch.eval``) and the synthesis,
    evaluation and daemon CLIs on the card, on the trained pair and the demo
    utterance (as a one-stimulus layout ``stim_15/ref.wav`` in a temporary
    directory removed at the end).  ``cli.evaluate_codec`` in this process
    at 1 378 and 5 512 bps with 10 % seeded losses and entropy coding: 12
    K1 launches (float32) a vocoding call, two a row; each row's mel-L1 and
    MRSTFT within 1e-5 relative and MCD within 1e-2 dB of the metrics
    recomputed on the CPU from the waveforms the CLI scored (STOI and PESQ,
    host numpy on both sides, printed); the summary printed.
    ``cli.dump_finetune_mels`` at 3 kbps: its ``.npy`` bitwise
    ``decode_to_mel(encode(x))`` of the parity codec.
    ``cli.synthesize`` with the trained vocoder's ``.npz``, in wav mode and on
    that ``.npy``: one file each, 12 K1 launches a file, each written float
    waveform within 1e-4 of the plain generator on the same mel (the
    generator's output scale).  ``cli.select_vocoder_ckpt`` on the trained and
    a seeded vocoder: the trained one first, 12 launches a candidate.  In
    subprocesses meanwhile: ``python -m bvsc_tpu_torch.cli.serve_daemon``
    (trained pair, 8 slots, fast serving by default: K1-bf16) serves a port
    ``CodecClient`` resynthesising the demo cut to whole hops (finite, of the
    sent length, bitwise an 8-slot ``ServingEngine`` of the fast codec in
    this process on the same input) and exits 0 on SIGTERM with its
    "served" line: a serving tick a frame, 12 K1-bf16 launches a tick, no
    float32 one, and its process's TF32 flags (printed; seconds to its
    serving line printed).  The in-process engine runs twice more with
    ``ops.conv``'s per-call TF32 pin taken out, cuDNN's flag on and off:
    its gaps from the pinned run printed (the daemon fault's cause);
    ``cli.train_vocoder --fine_tuning --evaluate`` on the dumped
    mel prints finite STOI and PESQ.  Printed, no gate: the host ms a clip of
    STOI, PESQ-WB and MCD.  Every process is stopped before the phase ends.

17. ``bf16_storage`` (after ``golden``): ``BVRNNCodecModel(dtype='bfloat16')``
    at full width on the trained pair, parity (``'highest'``) and fast
    (``'default'``).  One offline call of each on the main path's batch, the
    launch counts set to 0 before and read after it: 12 launches of the
    kernel with bf16 activations (K1 at parity, K1-bf16 fast) and no other;
    float32 waveform, finite.  Each stage's kernel output there against its
    plain version on the same bf16 input: within one bf16 ulp of the
    largest output (the samples that differ counted), timed with CUDA
    events beside the plain version and the bound (bf16 activations read
    and written once, or the FLOP floor).  ``encode`` (bf16 codes, no
    launch), ``decode``, a ``FusedPacketCodec`` step and a 4-slot
    ``ServingEngine`` tick (12 each), and the direct path's call (none).
    The teacher-forced golden step (``chkpts_npz/
    golden_demo_stim15_3kbps_bf16.npz``): state and encoder output within 4
    bf16 ulps of the JAX package's largest magnitude, the transmitted codes
    equal but within one ulp of 0.5; printed without a gate: the closed loop's code
    agreement beside the float32 golden's, and the decoded-mel gap.

18. ``upstream_ckpt`` (after ``main_path``): the reference's PyTorch
    checkpoints.  The trained pair written, in a temporary directory, as
    the upstream files: the BVRNN as ``{'vrnn': state_dict}``
    (``convert.bvrnn_params_to_torch_sd``), the vocoder as BigVGAN
    ``{'generator': state_dict}`` ``g_`` files with (a) plain ``weight``
    keys and (b) ``weight_g`` / ``weight_v`` from
    ``unfold_generator_params``.  ``BVRNNCodecModel(bvrnn_chkpt_path=,
    vocoder_chkpt_path=)`` at parity from (``.pt``, a) and (``.pt``, b) and
    fast from (``.pt``, a), on the main path's batch at 3 kbps, the K1
    counts set to 0 just before each call and read just after: 12 launches
    of the mode's kernel (K1 at parity, K1-bf16 fast) and none of the
    other; 0 codes flipped against the ``.npz`` codecs; the waveform
    bitwise theirs from (a) and within 1e-4 from (b), whose weights' gap
    is printed in float32 ulps.  ``cli.synthesize`` in this process on
    file (a) and on the vocoder ``.npz``: bitwise equal waveforms, 12 K1
    launches each.  ``cli.export_bvrnn_npz`` on the ``.pt``: its float16
    arrays bitwise the shipped ``.npz``'s.

Then a ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``.  Any failure raises: exit code non-zero
and no ``ok`` line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import json
import os
import re
import shutil
import signal
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from bvsc_tpu_torch import BVRNNCodecModel, load_config
from bvsc_tpu_torch import entropy as PE
from bvsc_tpu_torch import streaming as S
from bvsc_tpu_torch.benchmarks import (chain_steps, cold_ms, cuda_ms, graph_ms, gru_steps, k1_tiles,
                                        seeded_vocoder)
from bvsc_tpu_torch.benchmarks import probe_persistent_gru as probe_gru
from bvsc_tpu_torch.benchmarks import probe_roofline as probe_roof
from bvsc_tpu_torch.cli import (codec_cli, dump_finetune_mels, export_bvrnn_npz, train_bvrnn,
                                train_vocoder)
from bvsc_tpu_torch.cli import evaluate_codec as EVC
from bvsc_tpu_torch.cli import select_vocoder_ckpt as SEL
from bvsc_tpu_torch.cli import synthesize as SY
from bvsc_tpu_torch.codec import DEFAULT_CONFIG, SCALING, _generator_impl
from bvsc_tpu_torch.convert import (bvrnn_params_to_torch_sd, flatten_tree, load_bvrnn_npz,
                                    load_vocoder_npz, to_torch, vocoder_params_to_torch_sd)
from bvsc_tpu_torch.data.audio import load_wav, peak_normalize, save_wav
from bvsc_tpu_torch.data.dataset import AudioSegmentDataset
from bvsc_tpu_torch.device import set_parity_mode
from bvsc_tpu_torch.eval import metrics as EM
from bvsc_tpu_torch.models import bvrnn as bvrnn_mod
from bvsc_tpu_torch.models import vocoder as voc_mod
from bvsc_tpu_torch.ops import _build, _cc, bitpack, rans
from bvsc_tpu_torch.ops import amp_resblock as AR
from bvsc_tpu_torch.ops import dot_probe as DP
from bvsc_tpu_torch.ops import persistent_gru as PG
from bvsc_tpu_torch.ops import resample as RS
from bvsc_tpu_torch.ops.mel import MelFrontend
from bvsc_tpu_torch.ops.snake import linear_params, prepare_act, snake_linear
from bvsc_tpu_torch.serve import protocol as P
from bvsc_tpu_torch.serve.daemon import CodecDaemon
from bvsc_tpu_torch.serve.engine import DecodeEngine, ServingEngine
from bvsc_tpu_torch.serve.entropy_wire import AdaptiveCodesCoder
from bvsc_tpu_torch.train import bvrnn_train as BT
from bvsc_tpu_torch.train import checkpoint as ckpt
from bvsc_tpu_torch.train import vocoder_train as VT
from bvsc_tpu_torch.utils import tracing

REPO = os.path.dirname(os.path.abspath(__file__))
NPZ = os.path.join(REPO, "chkpts", "bvsc_bvrnn_demo_augfull_step1800_f16.npz")
VOC_NPZ = os.path.join(REPO, "chkpts_npz", "bvsc_vocoder_demo_cl_ft_g_step600_f16.npz")
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
# K1-bf16 on a serving tick's windows: no further from the float32 stage than
# the plain bf16 stack, to this factor (both carry the same rounding noise).
TICK_BF16_MARGIN = 1.1
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
PLC_LOSS = 0.10  # Bernoulli loss rate of each frame
PLC_BURST = 5  # frames of each stream's one burst
PLC_CONCEAL_BITRATE = 3000  # stream 0's concealment allocation; the others use every bit
PLC_MANUAL_TOL = 1e-4  # a concealed frame against the hand-made substitution
GOLDEN = os.path.join(REPO, "chkpts_npz", "golden_demo_stim15_3kbps.npz")
GOLDEN_BF16 = os.path.join(REPO, "chkpts_npz", "golden_demo_stim15_3kbps_bf16.npz")
# the golden step's state and encoder output, in bf16 ulps of their largest
# magnitude (tests/test_torch_bf16_storage.py's gate; measured 1 on the CPU
# and 2 on the card: a product's one-ulp flip carried through the GRU
# update's rounded ops)
BF16_STEP_ULPS = 4
BF16_SLOTS = 4  # the bf16 engine's slots
GOLDEN_MEL_TOL = 1e-4  # the decoded mel against bvsc_tpu's on the card (sums in another order)
GOLDEN_MEL_CPU = 2e-5  # the port's BVRNN gate on the CPU, printed beside the card's gap
GOLDEN_SNR_DB = 40.0  # the codec gate (ROADMAP.md, North star)
STREAM_TOL = 1e-5  # streaming against one-shot at parity: the overlap-add's reordered sums
STREAM_FAST_TOL = 7e-2  # the same in fast mode (the reference's fast streaming bound)
STREAM_CHUNKS = (256, 1000, 4096)
STREAM_STEPS, STREAM_WARMUP = 50, 10  # timed packet steps, after the warm-up ones
STREAM_STAGE_STEPS = 16  # packets of one stage streamed against its one-shot output
SERVE_SLOTS = 128  # the reference's serving config: 128 concurrent streams on one card
SERVE_STREAMS = 24  # streams of the schedule, opened SERVE_STAGGER ticks apart
SERVE_STAGGER = 3
SERVE_BITRATES = (1000.0, 3000.0, 5512.5)  # stream i's: SERVE_BITRATES[i % 3]
SERVE_HELD = (0, 1, 2, 23)  # streams held against a dedicated B = 1 packet codec
SERVE_SWITCH = (1, 60, 1000.0)  # stream 1 switches to 1 kbps after its 60th frame
SERVE_REOPEN = 5  # this stream's slot is closed at its end and reopened with its input
SERVE_ACTIVE = (1, 32, 128)  # streams advancing in the timed ticks
SERVE_STEPS, SERVE_WARMUP = 50, 10  # timed ticks, after the warm-up ones
DAEMON_SAMPLES = 20000  # each daemon client's input
DAEMON_ENT_BLOCK = 8  # frames a CODES_ENT message of the entropy decode client
NATIVE_CLIENT = os.path.join(REPO, "bvsc_tpu", "native", "bvsp_client.c")  # C, built with cc
ENTROPY_VBR = (1000.0, 3000.0, 5512.5)  # the VBR file's bitrates, one a third of the frames
# SHA-256 of the port's prior-coded payload of the golden codes (35 bits a
# frame); tests/test_torch_entropy.py holds the CPU to the same constant
GOLDEN_V3_SHA256 = "c6db926661ba5993ae8c505205097521dc51744bd534bac5fa5bafb4d499a26f"
GOLDEN_V2_BYTES = 912  # bvsc_tpu's payload of the same codes (its float32 prior)
ENTROPY_SIZE_RTOL = 0.01
CLI_WAV_TOL = 1e-6  # the CLI's wav against the in-process decode written the same way
RANS_BITS = (1 << 20, 1 << 15)  # bits coded to time rANS: native, numpy
EXPORT_CROP = 16384  # the one-shot programs' input: a 64-frame length bucket of the demo batch
EXPORT_TOL = 1e-6  # bundle audio against the live codec (the reference's bound)
EXPORT_PACKET = 16384  # samples through the B = 1 packet codecs
EXPORT_DECODE_FRAMES = 64  # frames through the B = 1 packet decoders
EXPORT_TICKS = 30  # timed ticks of each engine at 128 active, in turns, after SERVE_WARMUP
EXPORT_OP_CALLS = 500  # launches a round when timing the op's host cost
EXPORT_CLI_TIMEOUT = 900  # seconds an export CLI process may take
TRAIN_CHECK_BATCH = 2  # card against CPU: one step of each trainer at this batch
TRAIN_CHECK_SECONDS = 0.5  # the BVRNN's segments in that check
TRAIN_LOSS_RTOL = 1e-5  # BVRNN loss, card against CPU
TRAIN_GRAD_RTOL = 1e-4  # BVRNN gradient norm (sums over 43 frames in another order)
TRAIN_PARAM_TOL = 1e-5  # BVRNN params after the step, card against CPU
TRAIN_STEPS = 6  # full-size BVRNN steps (batch 32, 4.0-s segments)
TRAIN_MODE_RTOL = 0.05  # fused / bf16 first loss against the standard one (the reference's)
TRAIN_RESUME_BATCH = 4  # the resume check's batch and frames, full width
TRAIN_RESUME_FRAMES = 86
TRAIN_GAN_RTOL = 1e-4  # GAN D and G losses, card against CPU
TRAIN_GAN_STEPS = 3  # full-size GAN steps (batch 32, segment 8192), D frozen at step 0
TRAIN_CLI_BATCH = 4  # the trainer CLIs' batch
TRAIN_CLI_TIMEOUT = 300  # seconds a trainer CLI process may take


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


def stage_bound_ms(stage_blocks, B: int, T: int, compute_dtype: torch.dtype = torch.float32,
                   io_bytes: int = 4) -> tuple[float, str]:
    """Least time of one vocoder stage (its resblocks and their average):
    conv FLOPs (2 C^2 k per output sample, 6 convs per block) at the peak of
    their type (float32 on the CUDA cores, or bf16 on the tensor cores)
    against the input read once, the output written once (``io_bytes`` an
    element: 4 float32, 2 bf16) and the weights the mode reads (float32, or
    the packed bf16 ones) read once."""
    C = stage_blocks[0].channels
    flops = sum(6 * 2 * C * C * rb.kernel_size for rb in stage_blocks) * B * T
    bf16 = compute_dtype == torch.bfloat16
    weights = sum(t.numel() * t.element_size() for rb in stage_blocks
                  for t in ((rb.wk1, rb.wk2) if bf16 else (rb.w1, rb.w2))
                  + (rb.b1, rb.b2, rb.alpha, rb.inv_beta))
    nbytes = io_bytes * 2 * B * C * T + weights
    peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def device_phase() -> tuple[str, float, str]:
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
    return name, float(clock), smi


def build_phase(clock_mhz: float) -> dict:
    """Builds every kernel, and with ``cc`` the host C libraries (bit
    packing, rANS, the prior coder's fixed-order products): the card's host
    has a C compiler, so no numpy path is taken there.  Returns one snake's
    float32-pipe instruction count in the bf16 build's SASS and the SM
    clock, for the snake floor."""
    t0 = time.time()
    _build.load_all()
    host = {"bitpack": bitpack._load_native(), "rans": rans._load_native(),
            "prior": PE._load_native()}
    missing = [name for name, lib in host.items() if lib is None]
    if missing:
        raise AssertionError(f"cc did not build the host libraries {missing}")
    snake = {**k1_tiles.snake_instructions(), "clock_mhz": clock_mhz}
    emit("build", t0, libraries=[os.path.relpath(_build.library_path(name), REPO)
                                 for name in _build.sources()],
         host_libraries=[os.path.relpath(lib._name, REPO) for lib in host.values()], snake=snake)
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


AA_BATCH = 32  # the BigVGAN cell's clips a call
AA_FRAMES = 517  # frames it vocodes a clip
# (C, samples a frame, samples the upsampler's output is trimmed by at each end)
AA_STAGES = ((768, 4, 2), (384, 16, 2), (192, 32, 1), (96, 64, 1), (48, 128, 1), (24, 256, 1))
AA_PER_STAGE = 18  # anti-aliased activations a stage: 3 blocks x 3 dilations x 2
AA_TRIMMED = 3  # of them on the trimmed upsampler output (each block's first), read in place
AA_CODEC_SAMPLES = 22050  # one second through the BigVGAN codec, counting its launches
AA_TOL = 2e-6  # of the output's peak: the kernel's float32 sums against cuDNN's order


# Each kind of kernel launch by its ``utils.tracing`` counter, which the
# kernel's wrapper adds to as it launches
LAUNCH_COUNTERS = {"f32": "amp_resblock.launches", "bf16": "amp_resblock.launches_bf16",
                   "f32_io_bf16": "amp_resblock.launches_io_bf16",
                   "bf16_io_bf16": "amp_resblock.launches_bf16_io_bf16",
                   "persistent_gru": "persistent_gru.launches",
                   "dot_chain": "dot_chain.launches", "gridded_dot": "gridded_dot.launches",
                   "aa": "vocoder.aa_kernel"}
K1_KINDS = ("f32", "bf16", "f32_io_bf16", "bf16_io_bf16")


def kernel_launches(*kinds: str) -> dict:
    """The launches of each kind (:data:`LAUNCH_COUNTERS`; by default K1's
    two modes with float32 activations) since the last ``tracing.reset()``,
    counted on the host as each launch is issued, so nothing needs
    synchronising."""
    counters = tracing.snapshot()["counters"]
    return {k: counters.get(LAUNCH_COUNTERS[k], 0) for k in kinds or ("f32", "bf16")}


def aa_counts(codec: BVRNNCodecModel, x: torch.Tensor) -> tuple[int, int]:
    """(anti-aliased activations, kernel launches) of one call: the
    ``vocoder.aa`` spans and the launches it added."""
    def read():
        return (tracing.snapshot()["spans"].get("vocoder.aa", {}).get("count", 0),
                kernel_launches("aa")["aa"])

    before = read()
    with torch.no_grad():
        codec(x, BITRATE)
    return tuple(b - a for a, b in zip(before, read()))


def antialias_phase(smi: str, causal: BVRNNCodecModel, wav: np.ndarray) -> dict:
    """The anti-aliased activation kernel against the plain chain at the
    BigVGAN cell's stage shapes (module docstring, phase 5), and its launch
    count in one call of the BigVGAN codec and of ``causal``; returns the
    kernel's entry of the ``kernels`` line."""
    from portbench.aa_counts import aa_bound_s

    t0 = time.time()
    conf = load_config(os.path.join(REPO, "configs", "varbitrate_bigvgan.toml"))
    big = BVRNNCodecModel(config=conf, bvrnn_params=causal.bvrnn_params,
                          vocoder_params=seeded_vocoder(conf.vocoder_config, SEED), device=DEV)
    fast = BVRNNCodecModel(config=conf, bvrnn_params=causal.bvrnn_params,
                           vocoder_params=big.vocoder_params, precision="default", device=DEV)
    x = torch.from_numpy(wav[:2, :AA_CODEC_SAMPLES]).to(DEV)
    per_call = len(AA_STAGES) * AA_PER_STAGE + 1
    counts = {"bigvgan": aa_counts(big, x), "bigvgan_bf16": aa_counts(fast, x),
              "causal": aa_counts(causal, x)}
    emit("antialias_codec", t0, **counts, nvidia_smi=smi)
    if counts != {"bigvgan": (per_call, per_call), "bigvgan_bf16": (per_call, per_call),
                  "causal": (0, 0)}:
        raise AssertionError(f"(activations, kernel launches) a call: {counts}, expected "
                             f"({per_call}, {per_call}) for BigVGAN in float32 and in bf16, "
                             "and (0, 0) causal")
    del big, fast
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    launches = kernel_launches("aa")["aa"]
    calls = 0
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bf16_ms": 0.0, "max_abs_err": 0.0,
             "max_err": 0.0}
    for C, hop, trim in AA_STAGES:
        T = AA_FRAMES * hop
        wide = torch.randn(AA_BATCH, C, T + 2 * trim, generator=gen, device=DEV)
        trimmed = wide[..., trim:-trim]
        x = trimmed.contiguous()
        stored = {k: 0.3 * torch.randn(C, generator=gen, device=DEV) for k in ("alpha", "beta")}
        alpha, inv_beta = linear_params(prepare_act(stored, kind="snakebeta", logscale=True),
                                        kind="snakebeta", logscale=True)
        errs = {}  # sin^2 mode -> (max |error|, over the output's peak)
        for approx in (False, True):
            ref = RS.Activation1d(lambda v: snake_linear(v, alpha, inv_beta, approx))(x)
            got = RS.activation1d_kernel(x, alpha, inv_beta, approx)
            calls += 1
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            errs[approx] = (err, err / float(ref.abs().max()))
            del ref, got
        if not torch.equal(RS.activation1d_kernel(trimmed, alpha, inv_beta),
                           RS.activation1d_kernel(x, alpha, inv_beta)):
            raise AssertionError(f"antialias kernel at C={C}: a trimmed view read in place "
                                 "differs from its contiguous copy")
        xb = x.bfloat16()
        if not torch.equal(RS.activation1d_kernel(xb, alpha, inv_beta),
                           RS.activation1d_kernel(xb.float(), alpha, inv_beta).bfloat16()):
            raise AssertionError(f"antialias kernel at C={C}: the bf16 build is not the "
                                 "float32 one rounded")
        calls += 4
        warm = kernel_launches("aa")["aa"]
        ms = cuda_ms(lambda: RS.activation1d_kernel(x, alpha, inv_beta), reps=20, warmup=3)
        trimmed_ms = cuda_ms(lambda: RS.activation1d_kernel(trimmed, alpha, inv_beta), reps=20,
                             warmup=3)
        bf16_ms = cuda_ms(lambda: RS.activation1d_kernel(xb, alpha, inv_beta), reps=20, warmup=3)
        calls += kernel_launches("aa")["aa"] - warm
        plain_ms = cuda_ms(lambda: RS.Activation1d(lambda v: snake_linear(v, alpha, inv_beta))(x),
                           reps=3, warmup=1)
        bound_ms = aa_bound_s(x.numel())[0] * 1e3
        n = AA_PER_STAGE + (C == AA_STAGES[-1][0])  # activation_post after the last stage
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound_ms),
                       ("bf16_ms", bf16_ms)):
            total[key] += n * v
        total["ms"] += AA_TRIMMED * (trimmed_ms - ms)
        total["max_abs_err"] = max(total["max_abs_err"], *(e[0] for e in errs.values()))
        total["max_err"] = max(total["max_err"], *(e[1] for e in errs.values()))
        emit("antialias", t0, C=C, T=T, B=AA_BATCH, elements=x.numel(), max_abs_err=errs[False][0],
             max_err=errs[False][1], max_err_approx=errs[True][1], tol=AA_TOL, ms=ms,
             trimmed_ms=trimmed_ms, bf16_ms=bf16_ms, plain_ms=plain_ms, bound_ms=bound_ms,
             roofline_pct=100 * bound_ms / ms, per_call=n, nvidia_smi=smi)
        if max(e[1] for e in errs.values()) > AA_TOL:
            raise AssertionError(f"antialias kernel at C={C}, T={T}: error {errs} > {AA_TOL}")
        del x, xb, trimmed, wide
    counted = kernel_launches("aa")["aa"] - launches
    if counted != calls:
        raise AssertionError(f"vocoder.aa_kernel counted {counted} launches of {calls}")
    emit("antialias_total", t0, **total, roofline_pct=100 * total["bound_ms"] / total["ms"],
         per_call=per_call, launches=calls, nvidia_smi=smi)
    return {"name": "antialias_act", "route": "cuda",
            "source": "bvsc_tpu_torch/csrc/antialias_act.cu", "replaces": None,
            "launches": counts["bigvgan"][1], "max_abs_err": total["max_abs_err"],
            "ms": total["ms"],
            "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"], "bound_by": "bytes",
            "library_ms": None}


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

    def stage(xs, blocks, compute_dtype=torch.float32, **kw):
        ys = AR.amp_stack(xs, blocks, compute_dtype, **kw)
        stages.append((xs, ys))
        return ys

    voc_mod.amp_stack = stage
    try:
        return codec(x, BITRATE), stages
    finally:
        voc_mod.amp_stack = AR.amp_stack


def main_path_phase(codec: BVRNNCodecModel, wav: np.ndarray) -> tuple[int, list, dict, tuple]:
    """One resynthesis call through the entry point, with the kernel's
    launch count read around it and each stage's kernel output held against
    the plain version; then a second, warm call for its time, and the
    call's phases one at a time.  Returns the launches of the first call,
    the (B, C, T) it gave each stage, the call's times, and its (codes,
    waveform)."""
    t0 = time.time()
    B, L = wav.shape
    x = torch.from_numpy(wav).to(DEV)
    tracing.reset()
    (y, stages), first_ms = timed(lambda: recorded_call(codec, x))
    k1 = kernel_launches()
    launches = k1["f32"]
    n_blocks = sum(len(blocks) for blocks in codec.kernel_blocks)
    if launches < n_blocks or k1["bf16"]:
        raise AssertionError(f"amp_resblock launched {launches} times (bf16: {k1['bf16']}) in "
                             f"the main path, expected at least {n_blocks} (bf16: 0)")
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
                              "scan_ms": scan_ms, "vocoder_ms": voc_ms}, (codes, y)


UPSTREAM_WN_TOL = 1e-4  # the weight-normed files' waveform: K1's float32 gate


def f32_ulps(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest |got - ref| in float32 ulps of ``ref``."""
    ref = ref.float().cpu().numpy()
    gap = np.abs(got.float().cpu().numpy().astype(np.float64) - ref)
    return float((gap / np.spacing(np.abs(ref))).max())


def write_upstream(tmp: str, codec: BVRNNCodecModel) -> dict:
    """The trained pair as the reference's PyTorch files: the BVRNN as
    ``{'vrnn': state_dict}`` (``bvrnn.pt``), the vocoder as BigVGAN
    ``{'generator': state_dict}`` ``g_`` files, (a) with plain ``weight``
    keys (``plain/g_00000600``) and (b) weight-normed, ``weight_g`` /
    ``weight_v`` from ``unfold_generator_params`` (``wn/g_00000600``)."""
    def tensors(sd):
        return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}

    paths = {"bvrnn": os.path.join(tmp, "bvrnn.pt")}
    torch.save({"vrnn": tensors(bvrnn_params_to_torch_sd(codec.bvrnn_params))}, paths["bvrnn"])
    voc = load_vocoder_npz(VOC_NPZ)
    for name, tree in (("plain", voc), ("wn", voc_mod.unfold_generator_params(voc))):
        os.makedirs(os.path.join(tmp, name))
        paths[name] = os.path.join(tmp, name, "g_00000600")
        torch.save({"generator": tensors(vocoder_params_to_torch_sd(tree))}, paths[name])
    return paths


def upstream_synthesize(tmp: str, speech: np.ndarray, checkpoint: str, out: str) -> tuple:
    """``synthesize.main`` in this process on one wav of ``speech`` with the
    vocoder ``checkpoint``: (the float waveform it writes, K1 launches),
    the counts set to 0 just before and read just after."""
    src = os.path.join(tmp, "wavs")
    if not os.path.isdir(src):
        os.makedirs(src)
        save_wav(speech, os.path.join(src, "demo.wav"), 22050)
    written, write = [], SY._write

    def keep(args, path, sfx, w, fs):
        written.append(w)
        return write(args, path, sfx, w, fs)

    SY._write = keep
    try:
        tracing.reset()
        SY.main(["--input_wavs_dir", src, "--output_dir", os.path.join(tmp, out),
                 "--checkpoint_file", checkpoint, "--config", DEFAULT_CONFIG])
        launched = kernel_launches()
    finally:
        SY._write = write
    return written[0], launched


def upstream_ckpt_phase(codec: BVRNNCodecModel, fast: BVRNNCodecModel, wav: np.ndarray,
                        parity_out: tuple, smi: str) -> None:
    """The reference's PyTorch checkpoints on the card: the trained pair
    written as upstream files (:func:`write_upstream`) into a temporary
    directory, read back by ``BVRNNCodecModel(bvrnn_chkpt_path=,
    vocoder_chkpt_path=)`` on the main path's batch at 3 kbps, against the
    main path's (codes, waveform) ``parity_out`` and ``fast``'s.  Parity
    codecs from (BVRNN ``.pt``, vocoder a) and (BVRNN ``.pt``, vocoder b)
    and a fast one from a: 12 launches of the mode's kernel a call (the
    counts set to 0 just before and read just after), codes bitwise the
    ``.npz`` codecs' (0 flipped), the waveform bitwise theirs from (a) and
    within 1e-4 from (b), whose weights' largest gap is printed in float32
    ulps.  ``cli/synthesize`` on file (a) and on the vocoder ``.npz``:
    bitwise equal waveforms, 12 K1 launches each.  ``cli/export_bvrnn_npz``
    on the ``.pt``: float16 arrays bitwise the shipped ``.npz``'s."""
    t0 = time.time()
    x = torch.from_numpy(wav).to(DEV)
    conf, gates, rows = codec.conf, [], {}
    with torch.no_grad():
        refs = {"highest": parity_out, "default": (fast.encode(x, BITRATE), fast(x, BITRATE))}
    with tempfile.TemporaryDirectory(prefix="bvsc-upstream-") as tmp:
        t1 = time.time()
        paths = write_upstream(tmp, codec)
        rows["write_s"] = time.time() - t1
        plain_voc = None
        for name, voc, precision in (("parity_plain", "plain", "highest"),
                                     ("parity_weight_norm", "wn", "highest"),
                                     ("fast_plain", "plain", "default")):
            t1 = time.time()
            c = BVRNNCodecModel(config=conf, bvrnn_chkpt_path=paths["bvrnn"],
                                vocoder_chkpt_path=paths[voc], precision=precision, device=DEV)
            build_s = time.time() - t1
            ref_codes, ref_wav = refs[precision]
            with torch.no_grad():
                tracing.reset()
                y = c(x, BITRATE)
                launched = kernel_launches()
                codes = c.encode(x, BITRATE)
            kernel = "bf16" if precision == "default" else "f32"
            want = {"f32": 0, "bf16": 0, kernel: 12}
            flipped = int((codes != ref_codes).sum().item())
            gap = max_err(y, ref_wav)
            row = {"launches": launched, "flipped_codes": flipped, "max_abs_vs_npz": gap,
                   "finite": bool(torch.isfinite(y).all()), "build_s": build_s}
            tol = UPSTREAM_WN_TOL if voc == "wn" else 0.0
            if voc == "wn":
                row["weight_gap_f32_ulps"] = max(
                    f32_ulps(a, b) for a, b in zip(flatten_tree(c.vocoder_params).values(),
                                                   flatten_tree(plain_voc).values()))
            elif precision == "highest":
                plain_voc = c.vocoder_params
            gates += [(f"{name}: launches {launched} == {want}", launched == want),
                      (f"{name}: {flipped} codes flipped against the .npz codec", flipped == 0),
                      (f"{name}: waveform vs the .npz codec {gap} <= {tol}", gap <= tol),
                      (f"{name}: finite output of shape {tuple(y.shape)}",
                       row["finite"] and y.shape == x.shape)]
            rows[name] = row
            del c
        t1, synth = time.time(), {}
        for name, path in (("upstream_g", paths["plain"]), ("npz", VOC_NPZ)):
            synth[name] = upstream_synthesize(tmp, wav[0], path, f"synth_{name}")
        same = np.array_equal(synth["upstream_g"][0], synth["npz"][0])
        rows["synthesize"] = {"launches": {k: v[1] for k, v in synth.items()},
                              "bitwise": same, "samples": int(synth["npz"][0].shape[0]),
                              "seconds": time.time() - t1}
        gates += [("synthesize: upstream g_ bitwise the .npz", same)]
        gates += [(f"synthesize {k}: K1 launches {v[1]} == 12", v[1] == {"f32": 12, "bf16": 0})
                  for k, v in synth.items()]
        t1 = time.time()
        flat = export_bvrnn_npz.export(paths["bvrnn"], os.path.join(tmp, "exported.npz"))
        with np.load(NPZ) as shipped:
            same_keys = sorted(flat) == sorted(shipped.files)
            differ = [k for k in shipped.files if k in flat and not (
                flat[k].dtype == shipped[k].dtype and np.array_equal(flat[k], shipped[k]))]
        rows["export_bvrnn_npz"] = {"arrays": len(flat), "same_names": same_keys,
                                    "differing": differ, "seconds": time.time() - t1}
        gates += [("export_bvrnn_npz: the shipped .npz's names", same_keys),
                  (f"export_bvrnn_npz: arrays bitwise the shipped ones (differing: {differ})",
                   not differ)]
    failed = [what for what, ok in gates if not ok]
    emit("upstream_ckpt", t0, batch=int(x.shape[0]), samples=int(x.shape[1]), bitrate=BITRATE,
         nvidia_smi=smi, **rows, gates=len(gates), failed=failed)
    if failed:
        raise AssertionError(f"upstream_ckpt: {len(failed)} gates failed: {failed}")


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


def fast_path_phase(parity: BVRNNCodecModel, wav: np.ndarray, parity_times: dict,
                    trained: tuple[BVRNNCodecModel, BVRNNCodecModel]):
    """The fast-serving forms on the main path's batch and checkpoint with
    ``parity``'s (seeded) vocoder; returns the bf16 kernel's launches in the
    'auto' call and the (B, C, T) it gave each stage.  ``trained`` is the
    (parity, fast 'auto') pair with the trained vocoder, whose decode gap is
    printed."""
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

    tracing.reset()
    (y, stages), first_ms = timed(lambda: recorded_call(auto, x))
    launches = kernel_launches()
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
    trained_err = max_err(trained[1].decode(ref_codes, L), trained[0].decode(ref_codes, L))

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
         first_call_ms=first_ms, decode_vs_parity=decode_err,
         trained_vocoder_decode_vs_parity=trained_err, parity=parity_times,
         forms=report, agree_min=AGREE_MIN, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return launches["bf16"], shapes


def turns_ms(fns: dict, rounds: int = 5) -> dict:
    """Milliseconds of each function by CUDA events around one call, the
    functions called in turns for ``rounds`` rounds after a warm-up round:
    the median, least and most of each."""
    times = {key: [] for key in fns}
    for r in range(rounds + 1):
        for key, fn in fns.items():
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            if r:
                times[key].append(start.elapsed_time(end))
    return {key: {"median": float(np.median(v)), "min": min(v), "max": max(v)}
            for key, v in times.items()}


def loss_pattern(B: int, n: int) -> np.ndarray:
    """(B, n) 0/1: each stream, seeded on its own, loses ~``PLC_LOSS`` of its
    frames and one ``PLC_BURST``-frame burst; frame 0 is received."""
    lost = np.zeros((B, n), np.float32)
    for b in range(B):
        rng = np.random.default_rng([SEED, b])
        lost[b] = rng.random(n) < PLC_LOSS
        start = int(rng.integers(1, n - PLC_BURST))
        lost[b, start:start + PLC_BURST] = 1.0
    lost[:, 0] = 0.0
    return lost


def plc_mel(codec: BVRNNCodecModel, codes: torch.Tensor, lost: np.ndarray | None,
            conceal_bitrate=None, mode: str = "expect") -> torch.Tensor:
    """The decoded mel (B, n, M) that ``codec.decode(codes, lost=...)``
    hands its vocoder, padded as it pads (``lost=None``: the clean decode)."""
    B, n = codes.shape[:2]
    Tp = codec._pad_length(n * codec.conf.hopsize) // codec.conf.hopsize
    padded = codec._pad_codes(codes, Tp)
    with torch.no_grad():
        if lost is None:
            mel, _ = bvrnn_mod.decode(codec.scan_params, codec.bvrnn_cfg, padded, codec._h0(B))
            return mel[:, :n]
        bits = None
        if conceal_bitrate is not None:
            bits = np.broadcast_to(codec.bits_per_frame(conceal_bitrate), (B, n))
            bits = torch.as_tensor(np.pad(bits, ((0, 0), (0, Tp - n))), device=DEV)
        mel, _ = bvrnn_mod.decode_plc(
            codec.scan_params, codec.bvrnn_cfg, padded,
            torch.as_tensor(np.pad(lost, ((0, 0), (0, Tp - n))), device=DEV), codec._h0(B), bits,
            mode=mode)
    return mel[:, :n]


def manual_substitution(codec: BVRNNCodecModel, codes: torch.Tensor, t: int, bps: np.ndarray,
                        L: int) -> dict:
    """Frame ``t`` of every stream lost, concealed by ``decode(lost=,
    conceal_bitrate=bps)`` in 'expect' mode, against the prior at the state
    before it (``prior_apply`` after a clean decode of the frames before
    it), masked to each stream's bits and substituted into the codes by
    hand, through the plain ``decode``."""
    B, n = codes.shape[:2]
    lost = np.zeros((B, n), np.float32)
    lost[:, t] = 1.0
    bits = codec.bits_per_frame(bps[:, t])
    with torch.no_grad():
        _, h_t = bvrnn_mod.decode(codec.scan_params, codec.bvrnn_cfg, codes[:, :t], codec._h0(B))
        prior = bvrnn_mod.prior_apply(codec.scan_params.std, h_t, codec.bvrnn_cfg.precision)
    keep = torch.arange(codes.shape[2], device=DEV)[None] < torch.as_tensor(bits, device=DEV)[:, None]
    manual = codes.clone()
    manual[:, t] = torch.where(keep, prior, torch.full_like(prior, 0.5))
    mel_err = max_err(plc_mel(codec, codes, lost, bps), plc_mel(codec, manual, None))
    wav_err = max_err(codec.decode(codes, L, lost=lost, conceal_bitrate=bps), codec.decode(manual, L))
    check("manual substitution, mel", mel_err, PLC_MANUAL_TOL)
    check("manual substitution, waveform", wav_err, PLC_MANUAL_TOL)
    return {"frame": t, "mel_err": mel_err, "wav_err": wav_err}


def plc_phase(parity: BVRNNCodecModel, fast: BVRNNCodecModel, wav: np.ndarray, smi: str) -> None:
    """Packet-loss concealment through ``decode(lost=)`` at parity and in
    fast 'auto' mode on the trained pair; see the module docstring."""
    t0 = time.time()
    B, L = wav.shape
    x = torch.from_numpy(wav).to(DEV)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    if not bvrnn_mod._use_fused(fast.bvrnn_cfg, B) or bvrnn_mod._use_fused(parity.bvrnn_cfg, B):
        raise AssertionError(f"the fast codec should run the fused cell at B={B}, parity the standard")
    codes = parity.encode(x, BITRATE)
    n, hop, z_dim = codes.shape[1], parity.conf.hopsize, codes.shape[2]
    lost = loss_pattern(B, n)
    first = [int(np.argmax(lost[b] > 0)) for b in range(B)]
    full_bps = z_dim * parity.conf.fs / hop  # every bit: the mask of conceal_bitrate=None
    cbps = np.full((B, n), full_bps)
    cbps[0] = PLC_CONCEAL_BITRATE
    n_blocks = sum(len(blocks) for blocks in parity.kernel_blocks)
    report = {}
    for name, codec, kernel in (("parity", parity, "f32"), ("fast", fast, "bf16")):
        clean = codec.decode(codes, L)
        zero = codec.decode(codes, L, lost=np.zeros_like(lost))
        if not torch.equal(zero, clean):
            raise AssertionError(f"{name}: decode with no loss differs from decode by "
                                 f"{max_err(zero, clean)}")
        tracing.reset()
        y = codec.decode(codes, L, lost=lost, conceal_bitrate=cbps)
        torch.cuda.synchronize()
        launches = kernel_launches()
        want = {"f32": 0, "bf16": 0, kernel: n_blocks}
        if launches != want:
            raise AssertionError(f"{name}: decode(lost=) launched {launches}, expected {want}")
        if tuple(y.shape) != (B, L) or not torch.isfinite(y).all():
            raise AssertionError(f"{name}: output shape {tuple(y.shape)}, finite {torch.isfinite(y).all()}")
        clean_mel = plc_mel(codec, codes, None)
        mels = {mode: plc_mel(codec, codes, lost, cbps, mode) for mode in ("expect", "map")}
        prefix = []
        for b, f in enumerate(first):
            mel_gap = max_err(mels["expect"][b, :f], clean_mel[b, :f])
            wav_gap = max_err(y[b, :f * hop], clean[b, :f * hop])
            if mel_gap or wav_gap:
                raise AssertionError(f"{name} stream {b}: before its first lost frame {f} the mel "
                                     f"differs by {mel_gap}, the waveform by {wav_gap}")
            prefix.append({"first_lost": f, "mel_gap": mel_gap, "wav_gap": wav_gap})
        filled = torch.where(torch.as_tensor(lost, device=DEV)[..., None] > 0,
                             torch.full_like(codes, 0.5), codes)
        mels["fill_0.5"] = plc_mel(codec, filled, None)
        mel_l1 = {mode: (m - clean_mel).abs().mean().item() for mode, m in mels.items()}
        report[name] = {"launches": launches, "prefix": prefix, "mel_l1_vs_clean": mel_l1,
                        "ms": turns_ms({
                            "decode": lambda: codec.decode(codes, L),
                            "expect": lambda: codec.decode(codes, L, lost=lost, conceal_bitrate=cbps),
                            "map": lambda: codec.decode(codes, L, lost=lost, conceal_bitrate=cbps,
                                                        conceal_mode="map")})}
    report["parity"]["manual"] = manual_substitution(parity, codes, n // 2, cbps, L)
    if (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) != tf32:
        raise AssertionError(f"the TF32 flags changed from {tf32}")
    emit("plc", t0, batch=B, samples=L, frames=n, bitrate=BITRATE, loss_rate=PLC_LOSS,
         burst=PLC_BURST, lost_frames=int(lost.sum()), conceal_bitrate_stream0=PLC_CONCEAL_BITRATE,
         manual_tol=PLC_MANUAL_TOL, nvidia_smi=smi, **report)


def snr_db(ref: np.ndarray, test: np.ndarray) -> float:
    """The reference's SNR (``bvsc_tpu/eval/metrics.py``)."""
    err = ref.astype(np.float64) - test
    return float(10 * np.log10((ref.astype(np.float64) ** 2).mean() / max((err ** 2).mean(), 1e-20)))


def enc_margin(codec: BVRNNCodecModel, x: torch.Tensor, frame: int, bit: int) -> float:
    """|enc - 0.5| of one code before its rounding, from the parity codec's
    own state before ``frame`` (standard cell)."""
    mel, _, h_seq, _ = parity_states(codec, x)
    sp, prec = codec.scan_params.std, codec.bvrnn_cfg.precision
    with torch.no_grad():
        phi_x = bvrnn_mod.phi_x_apply(sp, bvrnn_mod._normalize(sp, mel[:, frame]), prec)
        enc = bvrnn_mod.enc_apply(sp, torch.cat([phi_x, h_seq[:, frame]], -1), prec)
    return abs(enc[0, bit].item() - 0.5)


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each value's magnitude (zero counts as the least
    normal's)."""
    v = v.float().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(v)) - 7)


def bf16_ulps(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest gap of ``got`` from ``ref``, in bf16 ulps of ``ref``'s
    largest magnitude (tests/test_torch_bf16_storage.py's measure)."""
    gap = (got.float() - ref.float()).abs().max()
    return (gap / bf16_ulp(ref.float().abs().max())).item()


def bf16_bits(a: np.ndarray) -> torch.Tensor:
    """A golden's uint16 bf16 bits as a bf16 tensor on the card."""
    return torch.from_numpy(a.astype(np.uint16).view(np.int16)).view(torch.bfloat16).to(DEV)


def bf16_golden_step(codec: BVRNNCodecModel) -> tuple[dict, dict]:
    """One BVRNN step of the bf16 codec from each of the bf16 golden's
    states (``tools/write_goldens.py --dtype bf16``), all in one batch: the
    encoder's probabilities and the next state against the JAX package's in
    bf16 ulps of their largest magnitude, the transmitted codes equal
    except where the golden's encoder output lies within one ulp of 0.5
    (counted).  Returns those
    numbers and the golden's arrays."""
    with np.load(GOLDEN_BF16) as z:
        g = {k: z[k] for k in z.files}
    h = bf16_bits(g["step_h"])
    mel = torch.from_numpy(g["step_mel"]).to(DEV)[:, None]
    bits = torch.full((h.shape[0], 1), codec.bits_per_frame(float(g["bitrate"])), device=DEV)
    with torch.no_grad():
        codes, h_next = bvrnn_mod.encode_with_state(codec.scan_params, codec.bvrnn_cfg, mel, bits,
                                                    h)
        enc = bvrnn_mod.enc_from_states(codec.scan_params, codec.bvrnn_cfg, mel, h[:, None])[:, 0]
    ref_enc = bf16_bits(g["step_enc"])
    k = int(bits[0, 0].item())  # the transmitted bits; the rest are 0.5
    differ = codes[:, 0, :k].float() != torch.round(ref_enc[:, :k].float())
    near_half = (ref_enc[:, :k].float() - 0.5).abs() <= bf16_ulp(torch.tensor(0.5)).item()
    out = {"frames": g["step_frames"].tolist(), "h_ulps": bf16_ulps(h_next, bf16_bits(g["step_h_next"])),
           "enc_ulps": bf16_ulps(enc, ref_enc), "codes_differing_near_half": int(differ.sum()),
           "codes_differing_elsewhere": int((differ & ~near_half).sum())}
    return out, g


def bf16_storage_phase(parity: BVRNNCodecModel, wav: np.ndarray, smi: str) -> dict:
    """The bf16 storage dtype (``BVRNNCodecModel(dtype='bfloat16')``) at full
    width on the trained pair, on the card: its main path (one offline call
    of each kernel mode, the counts read around each), the kernels' bf16-I/O
    forms against their plain versions at that call's stage shapes and
    timed, the other entry points with their launch counts, the teacher-
    forced golden step, and the closed-loop agreement (printed).  Returns
    the kernels line's numbers for both bf16-I/O kernels."""
    t0 = time.time()
    conf = parity.conf
    B, L = wav.shape
    x = torch.from_numpy(wav).to(DEV)
    codecs = {prec: BVRNNCodecModel(config=conf, bvrnn_chkpt_path=NPZ, vocoder_chkpt_path=VOC_NPZ,
                                    dtype="bfloat16", precision=prec, device=DEV)
              for prec in ("highest", "default")}
    counter = {"highest": "f32_io_bf16", "default": "bf16_io_bf16"}
    n_blocks = sum(len(blocks) for blocks in parity.kernel_blocks)
    entries, launches, calls = {}, {}, {}
    for prec, codec in codecs.items():
        compute = codec.voc_compute_dtype
        tracing.reset()
        (y, stages), ms = timed(lambda: recorded_call(codec, x))
        counts = kernel_launches(*K1_KINDS)
        if counts[counter[prec]] != n_blocks or sum(counts.values()) != n_blocks:
            raise AssertionError(f"bf16 storage at {prec!r}: launches {counts}, expected "
                                 f"{n_blocks} {counter[prec]} and no other")
        if y.dtype != torch.float32 or tuple(y.shape) != (B, L) or not torch.isfinite(y).all():
            raise AssertionError(f"bf16 storage at {prec!r}: output {y.dtype} {tuple(y.shape)}")
        launches[prec], calls[prec] = counts[counter[prec]], {"call_ms": ms}
        tot = {"max_abs_err": 0.0, "ulp_of_max": 0.0, "samples_differing": 0, "ms": 0.0,
               "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": set()}
        for i, (xs, ys) in enumerate(stages):
            blocks = codec.kernel_blocks[i]
            if xs.dtype != torch.bfloat16 or ys.dtype != torch.bfloat16:
                raise AssertionError(f"stage {i} ran on {xs.dtype} -> {ys.dtype}, not bf16")
            ref = AR.amp_stack_plain(xs, blocks, compute)
            gap = (ys.float() - ref.float()).abs()
            scale = bf16_ulp(ref.float().abs().max()).item()
            err, n_diff = gap.max().item(), int((gap > 0).sum())
            k_ms = cuda_ms(lambda: AR.amp_stack(xs, blocks, compute))
            p_ms = cuda_ms(lambda: AR.amp_stack_plain(xs, blocks, compute), reps=5, warmup=1)
            bound, by = stage_bound_ms(blocks, xs.shape[0], xs.shape[2], compute, io_bytes=2)
            emit("bf16_kernel", time.time(), mode=prec, stage=i, shape=list(xs.shape),
                 max_abs_err=err, ulp_of_max=scale, samples_differing=n_diff, ms=k_ms,
                 plain_ms=p_ms, bound_ms=bound, bound_by=by)
            if not err <= scale:
                raise AssertionError(f"bf16-I/O kernel at {prec!r} stage {i}: {err} > one bf16 "
                                     f"ulp of its largest output, {scale}")
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            tot["ulp_of_max"] = max(tot["ulp_of_max"], scale)
            tot["samples_differing"] += n_diff
            for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("bound_ms", bound)):
                tot[key] += v
            tot["bound_by"].add(by)
        entries[prec] = tot

    # the other entry points of the parity-mode codec, and the direct path
    codec = codecs["highest"]
    tracing.reset()
    codes = codec.encode(x, BITRATE)
    if sum(kernel_launches(*K1_KINDS).values()) or codes.dtype != torch.bfloat16:
        raise AssertionError(f"encode: {codes.dtype}, launches {kernel_launches(*K1_KINDS)}")
    if not set(torch.unique(codes.float()).tolist()) <= {0.0, 0.5, 1.0}:
        raise AssertionError("bf16 codes outside {0, 0.5, 1}")
    counts = {}
    fpc = S.FusedPacketCodec(codec, 1, BITRATE)
    for name, fn in (("decode", lambda: codec.decode(codes, L)),
                     ("packet_step", lambda: fpc.process(wav[:1, :768]))):  # its first step
        tracing.reset()
        out = fn()
        torch.cuda.synchronize()
        counts[name] = kernel_launches("f32_io_bf16")["f32_io_bf16"]
        if not torch.isfinite(out).all() or counts[name] != n_blocks:
            raise AssertionError(f"{name}: {counts[name]} launches, finite "
                                 f"{torch.isfinite(out).all().item()}")
    eng = ServingEngine(codec, max_streams=BF16_SLOTS)
    for i in range(2):
        eng.push(eng.open_stream(BITRATE), wav[i, : 768 + 256])
    tracing.reset()
    out = eng.tick()
    torch.cuda.synchronize()
    counts["engine_tick"] = kernel_launches("f32_io_bf16")["f32_io_bf16"]
    if len(out) != 2 or counts["engine_tick"] != n_blocks:
        raise AssertionError(f"engine tick: {len(out)} streams, {counts['engine_tick']} launches")
    direct = BVRNNCodecModel(config=conf, bvrnn_chkpt_path=NPZ, vocoder_chkpt_path=VOC_NPZ,
                             dtype="bfloat16", use_pallas=False, device=DEV)
    tracing.reset()
    y_direct = direct(x, BITRATE)
    torch.cuda.synchronize()
    counts["direct_call"] = sum(kernel_launches(*K1_KINDS).values())
    if counts["direct_call"] or not torch.isfinite(y_direct).all():
        raise AssertionError(f"direct path: {counts['direct_call']} launches")

    # the teacher-forced golden step, and the closed loop (printed)
    step, g = bf16_golden_step(codec)
    speech = torch.from_numpy(wav[:1]).to(DEV)
    gold = torch.from_numpy(g["codes"].astype(np.float32) / 2).to(DEV)[None]
    active = gold != 0.5
    agree = ((codec.encode(speech, BITRATE).float() == gold) & active).sum().item() / active.sum().item()
    with np.load(GOLDEN) as z:
        gold32 = torch.from_numpy(z["codes"].astype(np.float32) / 2).to(DEV)[None]
    agree32 = (parity.encode(speech, BITRATE) == gold32).sum().item() / gold32.numel()
    mel_gap = max_err(codec.decode_to_mel(gold).float()[0], bf16_bits(g["mel"]).float())
    emit("bf16_storage", t0, calls=calls, launches=launches, entry_launches=counts,
         kernels={p: {k: (sorted(v) if isinstance(v, set) else v) for k, v in e.items()}
                  for p, e in entries.items()},
         golden_step=step, golden_step_ulps_gate=BF16_STEP_ULPS,
         closed_loop_code_agreement=agree, float32_golden_code_agreement=agree32,
         closed_loop_decoded_mel_gap=mel_gap, nvidia_smi=smi)
    if max(step["h_ulps"], step["enc_ulps"]) > BF16_STEP_ULPS or step["codes_differing_elsewhere"]:
        raise AssertionError(f"bf16 golden step: {step}")
    return {"launches": launches, "entries": entries}


def golden_phase(codec: BVRNNCodecModel, speech: np.ndarray, smi: str) -> None:
    """The parity codec at B = 1 against ``bvsc_tpu``'s goldens; see the
    module docstring.  The numbers are printed before any gate is applied."""
    t0 = time.time()
    with np.load(GOLDEN) as z:
        g = {k: z[k] for k in z.files}
    L, bitrate = int(g["length"]), float(g["bitrate"])
    if speech.shape != (L,) or bitrate != BITRATE:
        raise AssertionError(f"goldens for {L} samples at {bitrate} bps, input {speech.shape}")
    x = torch.from_numpy(speech[None]).to(DEV)
    gold_codes = torch.from_numpy(g["codes"].astype(np.float32) / 2)[None].to(DEV)
    mel_gap = max_err(codec.decode_to_mel(gold_codes)[0], torch.from_numpy(g["mel"]).to(DEV))
    decode_snr = snr_db(g["wav"], codec.decode(gold_codes, L)[0].cpu().numpy())
    resynthesis_snr = snr_db(g["wav"], codec(x, bitrate)[0].cpu().numpy())
    flips = (codec.encode(x, bitrate) != gold_codes)[0].nonzero().tolist()
    first = None
    if flips:
        frame, bit = flips[0]
        first = {"frame": frame, "bit": bit, "enc_margin": enc_margin(codec, x, frame, bit)}
    emit("golden", t0, samples=L, bitrate=bitrate, frames=int(g["codes"].shape[0]),
         mel_gap=mel_gap, mel_tol=GOLDEN_MEL_TOL, mel_cpu_gate=GOLDEN_MEL_CPU,
         mel_within_cpu_gate=mel_gap <= GOLDEN_MEL_CPU, decode_snr_db=decode_snr,
         resynthesis_snr_db=resynthesis_snr, flipped_bits=len(flips), first_flip=first,
         nvidia_smi=smi)
    check("golden decoded mel", mel_gap, GOLDEN_MEL_TOL)
    if not decode_snr > GOLDEN_SNR_DB:
        raise AssertionError(f"golden decode SNR {decode_snr} dB <= {GOLDEN_SNR_DB}")
    if flips:
        raise AssertionError(f"encode flips {len(flips)} golden code bits, the first {first}")


def rans_rates() -> dict:
    """MB/s of coded payload through rANS, native against numpy, on seeded
    bits with probabilities in [0.01, 0.99]."""
    out = {}
    saved = (rans._lib, rans._tried)
    try:
        for path, n in zip(("native", "numpy"), RANS_BITS):
            if path == "numpy":
                rans._lib, rans._tried = None, True
            rng = np.random.default_rng([SEED, n])
            p = rng.uniform(0.01, 0.99, n)
            q, bits = rans.quantize_probs(p), (rng.uniform(size=n) < p).astype(np.uint8)
            t = time.perf_counter()
            payload = rans.rans_encode(bits, q)
            t_enc = time.perf_counter() - t
            t = time.perf_counter()
            dec = rans.RansDecoder(payload)
            ok = np.array_equal(dec.decode_bits(q), bits)
            dec.finish()
            t_dec = time.perf_counter() - t
            out[path] = {"bits": n, "payload_bytes": len(payload), "roundtrip": ok,
                         "encode_mb_s": len(payload) / t_enc / 1e6,
                         "decode_mb_s": len(payload) / t_dec / 1e6}
    finally:
        rans._lib, rans._tried = saved
    return out


def start_cli(*args: str) -> subprocess.Popen:
    """``python -m bvsc_tpu_torch.cli.codec_cli`` on the card, as a user runs
    it, in the background; ``cli_stdout`` waits for it."""
    return subprocess.Popen([sys.executable, "-m", "bvsc_tpu_torch.cli.codec_cli", *args,
                             "--bvrnn_checkpoint", NPZ, "--vocoder_checkpoint", VOC_NPZ],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)


def cli_stdout(proc: subprocess.Popen, what: str) -> str:
    try:
        out, err = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"codec_cli {what} failed ({proc.returncode}): {err}")
    return out.strip()


def entropy_phase(codec: BVRNNCodecModel, speech: np.ndarray, smi: str) -> None:
    """``.bvsc`` files on the trained pair at parity; see the module
    docstring.  The numbers are printed before any gate is applied."""
    t0 = time.time()
    gates = [(f"rANS native library loaded ({rans._lib})", rans._load_native() is not None),
             (f"prior native library loaded ({PE._lib})", PE._load_native() is not None)]
    coder = PE.PriorEntropyCoder(load_bvrnn_npz(NPZ), codec.bvrnn_cfg)
    L, hop, fs = speech.shape[0], codec.conf.hopsize, codec.conf.fs
    n = codec.frontend.num_frames(L)
    x = torch.from_numpy(speech[None]).to(DEV)
    n_blocks = sum(len(blocks) for blocks in codec.kernel_blocks)
    schedules = {"3kbps": float(BITRATE),
                 "vbr": np.asarray(ENTROPY_VBR)[np.minimum(np.arange(n) * 3 // n, 2)]}
    files, report, procs = {}, {}, []
    with tempfile.TemporaryDirectory(dir=_cc.BUILD_DIR) as tmp:  # inside the checkout
        try:
            # the CLI as a user runs it, encode --entropy then decode, in
            # processes of their own beside this one's files
            t1 = time.time()
            cli_file, cli_wav, ref_wav = (os.path.join(tmp, f) for f in
                                          ("cli.bvsc", "cli.wav", "ref.wav"))
            procs.append(start_cli("encode", WAV, cli_file, "--bitrate", str(BITRATE),
                                   "--entropy"))
            for name, bitrate in schedules.items():
                codes = codec.encode(x, bitrate)
                codes_np = codes[0].cpu().numpy()
                bits = codec.bits_per_frame(bitrate)
                y_enc = codec.decode(codes, L)
                r = {"frames": codes_np.shape[0], "raw_bits": int(np.sum(np.ceil(
                    np.broadcast_to(bits, (codes_np.shape[0],)))))}
                for version, c in (("v1", None), ("v3", coder)):
                    path = os.path.join(tmp, f"{name}_{version}.bvsc")
                    t = time.perf_counter()
                    codec_cli.write_bvsc(path, codes_np, bits, fs, coder=c)
                    t_write = time.perf_counter() - t
                    t = time.perf_counter()
                    got, got_bits, _ = codec_cli.read_bvsc(path, lambda: coder)
                    t_read = time.perf_counter() - t
                    tracing.reset()
                    y_read = codec.decode(torch.from_numpy(got)[None].to(DEV), L)
                    launches = kernel_launches()
                    files[(name, version)] = open(path, "rb").read()
                    r[version] = {"bytes": os.path.getsize(path),
                                  "codes_bitwise": bool(np.array_equal(got, codes_np)),
                                  "bits_equal": bool(np.array_equal(got_bits, bits)),
                                  "decode_bitwise": bool(torch.equal(y_read, y_enc)),
                                  "launches": launches,
                                  "write_ms_per_frame": t_write * 1e3 / codes_np.shape[0],
                                  "read_ms_per_frame": t_read * 1e3 / codes_np.shape[0]}
                    for key in ("codes_bitwise", "bits_equal", "decode_bitwise"):
                        gates.append((f"{name} {version} {key}", r[version][key]))
                    gates.append((f"{name} {version}: decode launches {launches}",
                                  launches == {"f32": n_blocks, "bf16": 0}))
                report[name] = r
            cli_out = [cli_stdout(procs[0], "encode")]
            procs.append(start_cli("decode", cli_file, cli_wav))

            # the golden codes: cross-machine determinism and the size against
            # bvsc_tpu's
            with np.load(GOLDEN) as z:
                gold = z["codes"].astype(np.float32) / 2
            t = time.perf_counter()
            payload = coder.encode(gold, codec.conf.bits_per_frame(BITRATE))
            golden = {"bytes": len(payload), "bvsc_tpu_v2_bytes": GOLDEN_V2_BYTES,
                      "sha256": hashlib.sha256(payload).hexdigest(),
                      "encode_ms_per_frame": (time.perf_counter() - t) * 1e3 / gold.shape[0]}
            rates = rans_rates()

            cli_out.append(cli_stdout(procs[1], "decode"))
            got, _, _ = codec_cli.read_bvsc(cli_file, lambda: coder)
            save_wav(codec.decode(torch.from_numpy(got)[None].to(DEV), got.shape[0] * hop)[0]
                     .cpu().numpy(), ref_wav, fs)
            (a, fs_a), (b, fs_b) = load_wav(cli_wav), load_wav(ref_wav)
            cli = {"seconds": time.time() - t1, "stdout": cli_out,
                   "file_bitwise": open(cli_file, "rb").read() == files[("3kbps", "v3")],
                   "wav_gap": float(np.abs(a - b).max()) if a.shape == b.shape else None,
                   "samples": a.shape[0], "fs": [fs_a, fs_b]}
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
    gates.append(("the CLI's file is the in-process v3 file", cli["file_bitwise"]))
    gates.append((f"the CLI's wav against the in-process decode ({cli['wav_gap']})",
                  cli["wav_gap"] is not None and cli["wav_gap"] <= CLI_WAV_TOL))

    gates.append((f"golden payload sha256 {golden['sha256']}",
                  golden["sha256"] == GOLDEN_V3_SHA256))
    gates.append((f"golden payload {len(payload)} B within {ENTROPY_SIZE_RTOL} of "
                  f"{GOLDEN_V2_BYTES}",
                  abs(len(payload) - GOLDEN_V2_BYTES) <= ENTROPY_SIZE_RTOL * GOLDEN_V2_BYTES))
    gates += [(f"rANS {path} round trip", r["roundtrip"]) for path, r in rates.items()]
    failed = [what for what, ok in gates if not ok]
    emit("entropy", t0, samples=L, frames=n, nvidia_smi=smi, files=report, cli=cli,
         golden=golden, rans=rates, gates=len(gates), failed=failed)
    if failed:
        raise AssertionError(f"entropy: {len(failed)} gates failed: {failed}")


def inside_frames(codec: BVRNNCodecModel, L: int, n: int) -> int:
    """Frames whose analysis window lies inside an input of L samples: all
    n where L fills its length buckets (one-shot's right padding is then the
    same reflection a stream makes), else those ending by sample L."""
    if codec._pad_length(L) == L:
        return n
    return min(n, (L - (codec.conf.winsize - codec.conf.mel_pad_left)) // codec.conf.hopsize + 1)


def packet_run(codec: BVRNNCodecModel, x: np.ndarray):
    """x (B, L) through a ``FusedPacketCodec`` in 256-sample packets, the
    remainder and ``flush()``, with the K1 launch counts read around it:
    (waveform, codes of the emitted frames, steps, launches)."""
    B, L = x.shape
    hop = codec.conf.hopsize
    fc = S.FusedPacketCodec(codec, batch=B, bitrate=BITRATE)
    codes, step = [], fc._step

    def recording(chunk):
        out = step(chunk)
        codes.append(out[0])
        return out

    fc._step = recording
    tracing.reset()
    outs = [fc.process(x[:, i: i + hop]) for i in range(0, L - hop + 1, hop)]
    if L % hop:
        outs.append(fc.process(x[:, L - L % hop:]))
    outs.append(fc.flush())
    torch.cuda.synchronize()
    launches = kernel_launches()
    wav = torch.cat(outs, 1)
    return wav, torch.stack(codes, 1)[:, : wav.shape[1] // hop], len(codes), launches


def encode_stream(codec: BVRNNCodecModel, x: np.ndarray, chunk: int) -> torch.Tensor:
    enc = S.StreamingEncoder(codec, batch=x.shape[0], bitrate=BITRATE)
    outs = [enc.feed(x[:, i: i + chunk]) for i in range(0, x.shape[1], chunk)]
    return torch.cat(outs + [enc.flush()], 1)


def decode_stream(codec: BVRNNCodecModel, codes: torch.Tensor, lost=None,
                  conceal_bitrate=None) -> torch.Tensor:
    """``StreamingDecoder`` fed frame by frame."""
    dec = S.StreamingDecoder(codec, batch=codes.shape[0], conceal_bitrate=conceal_bitrate)
    return torch.cat([dec.feed(codes[:, t: t + 1], None if lost is None else lost[:, t: t + 1])
                      for t in range(codes.shape[1])], 1)


def percentiles(times: list[float]) -> dict:
    return {"median": float(np.median(times)), "p90": float(np.percentile(times, 90)),
            "steps": len(times)}


def packet_step_ms(codec: BVRNNCodecModel, x: np.ndarray) -> dict:
    """Host milliseconds of one packet step (``FusedPacketCodec._step``,
    synchronised on both sides) over ``STREAM_STEPS`` steps after
    ``STREAM_WARMUP``, once the stream has started."""
    B = x.shape[0]
    hop, need = codec.conf.hopsize, codec.conf.winsize - codec.conf.mel_pad_left
    fc = S.FusedPacketCodec(codec, batch=B, bitrate=BITRATE)
    fc.process(x[:, :need])
    times = []
    for i in range(STREAM_WARMUP + STREAM_STEPS):
        chunk = x[:, need + i * hop: need + (i + 1) * hop]
        _, t = timed(lambda: fc._step(chunk))
        times.append(t)
    return percentiles(times[STREAM_WARMUP:])


def vocoder_step_ms(codec: BVRNNCodecModel, B: int, plain: bool) -> dict:
    """Host milliseconds of one streaming vocoder step on one seeded mel
    frame (the same windows every time), its stages through the kernel or,
    with ``plain``, through ``amp_stack_plain``."""
    vcfg = codec.conf.vocoder_config
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    mel = 2 * torch.randn(B, vcfg.num_mels, 1, device=DEV, generator=gen) - 4
    state = S.generator_stream_init(vcfg, B, DEV)
    times = []
    voc_mod.amp_stack = AR.amp_stack_plain if plain else AR.amp_stack
    try:
        with torch.no_grad():
            for _ in range(STREAM_WARMUP + STREAM_STEPS):
                (state, _), t = timed(lambda: S.generator_stream_step(
                    codec.weights.vocoder, state, mel, precision=codec.precision))
                times.append(t)
    finally:
        voc_mod.amp_stack = AR.amp_stack
    return percentiles(times[STREAM_WARMUP:])


def stage_stream_vs_oneshot(codec: BVRNNCodecModel, compute_dtype: torch.dtype) -> list[dict]:
    """Each stage's kernel over ``STREAM_STAGE_STEPS`` packets of a seeded
    signal (its per-packet samples a step, over the carried context)
    against the one-shot kernel on the whole signal."""
    vcfg = codec.conf.vocoder_config
    ctx = S.stage_context(vcfg)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    voc = voc_mod.Vocoder(codec.vocoder_params, vcfg, codec.kernel_blocks, compute_dtype)
    out, n = [], 1
    for stage, (u, blocks) in enumerate(zip(vcfg.upsample_rates, codec.kernel_blocks)):
        n *= u
        C = blocks[0].channels
        x = 0.3 * torch.randn(BATCH, C, STREAM_STAGE_STEPS * n, device=DEV, generator=gen)
        one = AR.amp_stack(x, blocks, compute_dtype)
        state = {"ctx": torch.zeros(BATCH, C, ctx, device=DEV),
                 "fed": torch.zeros(BATCH, dtype=torch.int32, device=DEV)}
        parts = []
        for i in range(STREAM_STAGE_STEPS):
            state, y = S._stream_stage(state, x[..., i * n: (i + 1) * n].contiguous(), voc, stage)
            parts.append(y)
        got = torch.cat(parts, -1)
        out.append({"stage": stage, "new_per_step": n, "bit_equal": torch.equal(got, one),
                    "max_abs_gap": max_err(got, one)})
    return out


def recorded_windows(codec: BVRNNCodecModel, x: np.ndarray, steps: int) -> list:
    """The (window, stage, ctx, start) each stage's ``amp_stack`` got in the
    first and in the ``steps``-th packet step of a stream."""
    B = x.shape[0]
    hop, need = codec.conf.hopsize, codec.conf.winsize - codec.conf.mel_pad_left
    fc = S.FusedPacketCodec(codec, batch=B, bitrate=BITRATE)
    calls = []

    def stage(window, blocks, compute_dtype, ctx=0, start=None):
        calls.append((window, blocks, ctx, start.clone()))
        return AR.amp_stack(window, blocks, compute_dtype, ctx=ctx, start=start)

    voc_mod.amp_stack = stage
    try:
        fc.process(x[:, :need])  # the first step
        first = list(calls)
        fc.process(x[:, need: need + steps * hop])
    finally:
        voc_mod.amp_stack = AR.amp_stack
    return first + calls[-len(first):]


def stage_windows_vs_plain(codec: BVRNNCodecModel, x: np.ndarray) -> dict:
    """The kernel stage with ``ctx``/``start`` against ``amp_stack_plain``
    with the same arguments, on the first packet's windows and a later
    one's, with their own starts and with per-row starts (a row that began
    this step, inside the context, at its edge and long ago)."""
    mode = codec.voc_compute_dtype
    tol = BF16_KERNEL_TOL if mode == torch.bfloat16 else KERNEL_TOL
    errs = []
    for window, blocks, ctx, start in recorded_windows(codec, x, 20):
        rows = torch.tensor([0, 5, ctx, 10 * ctx], dtype=torch.int32, device=DEV)[: window.shape[0]]
        for st in (start, rows.contiguous()):
            err = max_err(AR.amp_stack(window, blocks, mode, ctx=ctx, start=st),
                          AR.amp_stack_plain(window, blocks, mode, ctx=ctx, start=st))
            errs.append(check(f"streaming stage {tuple(window.shape)} start {st.tolist()}", err, tol))
    return {"windows": len(errs), "max_abs_err": max(errs), "tol": tol}


def hoisted_product_bits(codec: BVRNNCodecModel, x: torch.Tensor) -> dict:
    """Each product the one-shot path computes over all frames at once,
    against the same product frame by frame (M = B rows, as a stream
    computes it): the largest difference (0.0: bit-equal)."""
    B, L = x.shape
    Lp = codec._pad_length(L)
    prec = codec.bvrnn_cfg.precision
    fe = codec.frontend
    with torch.no_grad():
        frames = (fe.pad(torch.nn.functional.pad(x, (0, Lp - L)) * SCALING)
                  .unfold(-1, fe.n_fft, fe.hop_size) * fe.window)  # (B, F, n_fft)
        mel = codec._mel(torch.nn.functional.pad(x, (0, Lp - L)))  # (B, F, M)
        sp = codec.scan_params.std
        y = bvrnn_mod._normalize(sp, mel)
        out = {}

        def per_frame(fn, a):
            return torch.stack([fn(a[:, t]) for t in range(a.shape[1])], 1)

        out["dft_cos"] = max_err(frames @ fe.cos_basis, per_frame(lambda f: f @ fe.cos_basis, frames))
        re, im = frames @ fe.cos_basis, frames @ fe.sin_basis
        mag = torch.sqrt(re * re + im * im + 1e-9).transpose(-1, -2)  # (B, bins, F)
        out["filterbank"] = max_err(fe.mel_basis @ mag, torch.cat(
            [fe.mel_basis @ mag[..., t: t + 1] for t in range(mag.shape[-1])], -1))
        for i, layer in enumerate(sp["phi_x"]):
            fn = lambda a, layer=layer: bvrnn_mod._dense(layer, a, prec)  # noqa: E731
            out[f"phi_x_{i}"] = max_err(fn(y), per_frame(fn, y))
            y = torch.nn.functional.elu(fn(y))
        if codec.scan_params.fused is not None and bvrnn_mod._use_fused(codec.bvrnn_cfg, B):
            w = codec.scan_params.fused["w_enc1_x"]
            fn = lambda a: bvrnn_mod._matmul(a, w, prec)  # noqa: E731
            out["encx"] = max_err(fn(y), per_frame(fn, y))
    return out


def streaming_phase(parity: BVRNNCodecModel, fast: BVRNNCodecModel, wav: np.ndarray,
                    smi: str) -> None:
    """The streaming runtime against one-shot at parity and in fast
    'auto' mode on the trained pair; see the module docstring."""
    t0 = time.time()
    B, L = wav.shape
    x = torch.from_numpy(wav).to(DEV)
    hop = parity.conf.hopsize
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    n_blocks = sum(len(blocks) for blocks in parity.kernel_blocks)
    codes = parity.encode(x, BITRATE)
    lost = loss_pattern(B, codes.shape[1])
    cbps = np.full(B, codes.shape[2] * parity.conf.fs / hop)  # every bit
    cbps[0] = PLC_CONCEAL_BITRATE
    report = {}
    for name, codec, kernel in (("parity", parity, "f32"), ("fast", fast, "bf16")):
        t1 = time.time()
        tol = STREAM_TOL if kernel == "f32" else STREAM_FAST_TOL
        ref = codec(x, BITRATE)
        ref_codes = codec.encode(x, BITRATE)
        n = ref_codes.shape[1]
        inside = inside_frames(codec, L, n)
        bpf = int(codec.bits_per_frame(BITRATE))
        r = {"frames": n, "inside_frames": inside, "tol": tol}

        def held(got):
            """Agreement with ``encode`` on the frames inside the input, and
            on the tail frames."""
            out = {"codes": agreement(got[:, :inside], ref_codes[:, :inside], bpf)}
            if inside < n:
                out["tail_codes"] = agreement(got[:, inside:n], ref_codes[:, inside:], bpf)
            return out

        wav_pkt, pkt_codes, steps, launches = packet_run(codec, wav)
        want = {"f32": 0, "bf16": 0, kernel: n_blocks * steps}
        if launches != want:
            raise AssertionError(f"{name}: the packet run launched {launches}, expected {want} "
                                 f"({steps} steps)")
        if tuple(wav_pkt.shape) != (B, n * hop) or not torch.isfinite(wav_pkt).all():
            raise AssertionError(f"{name}: packet output {tuple(wav_pkt.shape)}, finite "
                                 f"{torch.isfinite(wav_pkt).all()}")
        end = min(n * hop, L)
        r["packet"] = {"steps": steps, "launches": launches,
                       "launches_per_step": launches[kernel] / steps, **held(pkt_codes),
                       "wav_gap": max_err(wav_pkt[:, : inside * hop], ref[:, : inside * hop])}
        if inside * hop < end:
            r["packet"]["tail_wav_gap"] = max_err(wav_pkt[:, inside * hop: end],
                                                  ref[:, inside * hop: end])
        r["encoder"] = {}
        for chunk in STREAM_CHUNKS:
            got = encode_stream(codec, wav, chunk)
            if tuple(got.shape) != tuple(ref_codes.shape):
                raise AssertionError(f"{name}: encoder at {chunk} gave {tuple(got.shape)}")
            r["encoder"][chunk] = held(got)
        enc = S.StreamingEncoder(codec, batch=B, bitrate=BITRATE)
        r["first_code_at"] = [enc.feed(wav[:, :767]).shape[1], enc.feed(wav[:, 767:768]).shape[1]]
        clean = decode_stream(codec, codes)
        concealed = decode_stream(codec, codes, lost, cbps)
        r["decoder"] = {  # one-shot decodes to L, past the codes' frames with 0.5 codes
            "clean_gap": max_err(clean[:, :end], codec.decode(codes, L)[:, :end]),
            "lossy_gap": max_err(concealed[:, :end], codec.decode(
                codes, L, lost=lost,
                conceal_bitrate=np.broadcast_to(cbps[:, None], lost.shape))[:, :end])}
        r["stage_stream_vs_oneshot"] = stage_stream_vs_oneshot(codec, codec.voc_compute_dtype)
        r["stage_vs_plain"] = stage_windows_vs_plain(codec, wav)
        r["hoisted_product_gap"] = hoisted_product_bits(codec, x)
        r["packet_step_ms"] = {f"B{b}": packet_step_ms(codec, wav[:b]) for b in (1, B)}
        r["vocoder_step_ms"] = {f"B{b}": {"kernel": vocoder_step_ms(codec, b, False),
                                          "plain": vocoder_step_ms(codec, b, True)} for b in (1, B)}
        packet_s = hop / codec.conf.fs * 1e3
        r["real_time_factor"] = {k: packet_s / v["median"] for k, v in r["packet_step_ms"].items()}
        r["seconds"] = time.time() - t1
        report[name] = r

        # gates, after the numbers are kept
        if r["first_code_at"] != [0, 1]:
            raise AssertionError(f"{name}: codes after 767 and 768 samples: {r['first_code_at']}")
        for what, gap in (("packet waveform", r["packet"]["wav_gap"]),
                          ("decoder", r["decoder"]["clean_gap"]),
                          ("decoder with losses", r["decoder"]["lossy_gap"])):
            if not gap <= tol:
                emit("streaming", t0, failed=name, nvidia_smi=smi, **report)
                raise AssertionError(f"{name} {what} vs one-shot {gap} > {tol}")
        if kernel == "f32":
            exact = [r["packet"]["codes"]["all"]] + [e["codes"]["all"] for e in r["encoder"].values()]
            if min(exact) != 1.0:
                emit("streaming", t0, failed=name, nvidia_smi=smi, **report)
                raise AssertionError(f"parity streaming codes differ from encode's: {exact}")
    if (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) != tf32:
        raise AssertionError(f"the TF32 flags changed from {tf32}")
    emit("streaming", t0, batch=B, samples=L, bitrate=BITRATE, packet_ms=hop / parity.conf.fs * 1e3,
         nvidia_smi=smi, **report)


def count_calls(eng) -> list:
    """Wrap ``eng._tick_call`` (the device step of a tick) so that each call
    is timed, synchronised on both sides; returns the list of its ms."""
    orig, times = eng._tick_call, []

    def call(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        return out

    eng._tick_call = call
    return times


def serve_inputs(speech: np.ndarray) -> list[np.ndarray]:
    """The schedule's streams: seeded noisy copies of the demo, cropped to
    lengths that differ from stream to stream (20 000 + 1 511 i samples)."""
    out = []
    for i in range(SERVE_STREAMS):
        n = 20000 + 1511 * i
        rng = np.random.default_rng([SEED, 200 + i])
        out.append((speech[:n] + 0.01 * rng.standard_normal(n)).astype(np.float32))
    return out


def serve_schedule(codec: BVRNNCodecModel, inputs: list[np.ndarray], eng=None) -> dict:
    """The phase's schedule through one ``ServingEngine(max_streams=128)``,
    each stream a live caller: stream i opens at tick ``SERVE_STAGGER`` i at
    ``SERVE_BITRATES[i % 3]``, gets one 256-sample packet a tick, calls
    ``begin_flush`` after its last and is closed once drained.  Stream
    ``SERVE_SWITCH[0]`` switches bitrate after its ``SERVE_SWITCH[1]``-th
    frame; the slot of stream ``SERVE_REOPEN``, closed at its end, is
    reopened at once with the same input.  The K1 launch counts are read
    around the run.  ``eng`` (default a new live engine) runs it."""
    hop = codec.conf.hopsize
    eng = ServingEngine(codec, max_streams=SERVE_SLOTS) if eng is None else eng
    steps = count_calls(eng)
    tracing.reset()
    live, out, slots, switched, t = {}, {}, {}, False, 0
    while t < SERVE_STAGGER * SERVE_STREAMS or live:
        if t % SERVE_STAGGER == 0 and t // SERVE_STAGGER < SERVE_STREAMS:
            i = t // SERVE_STAGGER
            slots[i] = eng.open_stream(SERVE_BITRATES[i % 3])
            live[i] = {"sid": slots[i], "x": inputs[i], "pos": 0, "codes": [], "wav": []}
        for s in live.values():
            if s["pos"] < len(s["x"]):
                eng.push(s["sid"], s["x"][s["pos"]: s["pos"] + hop])
                s["pos"] += hop
                if s["pos"] >= len(s["x"]):
                    eng.begin_flush(s["sid"])
        res = eng.tick()
        for s in live.values():
            if s["sid"] in res:
                s["codes"].append(res[s["sid"]][0])
                s["wav"].append(res[s["sid"]][1])
        stream, frame, bps = SERVE_SWITCH
        if not switched and stream in live and len(live[stream]["codes"]) == frame:
            eng.set_bitrate(live[stream]["sid"], bps)
            switched = True
        for key in [k for k, s in live.items()
                    if s["pos"] >= len(s["x"]) and not eng.has_frame(s["sid"])]:
            s = live.pop(key)
            eng.close_stream(s["sid"])
            out[key] = (np.stack(s["codes"]), np.concatenate(s["wav"]))
            if key == SERVE_REOPEN:
                eng._free.remove(s["sid"])  # the free list is FIFO: hand this slot out next
                eng._free.insert(0, s["sid"])
                slots["reopen"] = eng.open_stream(SERVE_BITRATES[SERVE_REOPEN % 3])
                live["reopen"] = {"sid": slots["reopen"], "x": inputs[SERVE_REOPEN], "pos": 0,
                                  "codes": [], "wav": []}
        t += 1
    launches = kernel_launches()
    if slots["reopen"] != slots[SERVE_REOPEN] or not switched:
        raise AssertionError(f"the schedule did not run as planned: slots {slots}, "
                             f"switched {switched}")
    return {"out": out, "ticks": t, "steps": len(steps), "launches": launches}


def packet_reference(codec: BVRNNCodecModel, x: np.ndarray, bitrate: float, switch=None):
    """``x`` through a dedicated B = 1 ``FusedPacketCodec``, ``process()``
    and ``flush()``: (codes (T, z), waveform) as numpy; ``switch=(frame,
    bps)`` changes its bits before that frame."""
    fpc = S.FusedPacketCodec(codec, batch=1, bitrate=bitrate)
    codes, step = [], fpc._step

    def recording(chunk):
        if switch is not None and len(codes) == switch[0]:
            fpc.bits.fill_(codec.bits_per_frame(switch[1]))
        out = step(chunk)
        codes.append(out[0][0])
        return out

    fpc._step = recording
    wav = torch.cat([fpc.process(x[None]), fpc.flush()], 1)[0]
    n = wav.shape[0] // codec.conf.hopsize
    return torch.stack(codes)[:n].cpu().numpy(), wav.cpu().numpy()


def held_slots(reference: BVRNNCodecModel, out: dict, inputs: list[np.ndarray]) -> list[dict]:
    """Each of ``SERVE_HELD``'s engine slots against ``packet_reference`` on
    the same input and bitrates: code agreement and the largest waveform
    gap, on the frames whose analysis window lies inside the input and on
    all."""
    hop, rows = reference.conf.hopsize, []
    for i in SERVE_HELD:
        switch = SERVE_SWITCH[1:] if i == SERVE_SWITCH[0] else None
        ref_codes, ref_wav = packet_reference(reference, inputs[i], SERVE_BITRATES[i % 3], switch)
        codes, wav = out[i]
        if codes.shape != ref_codes.shape or wav.shape != ref_wav.shape:
            raise AssertionError(f"stream {i}: engine {codes.shape} {wav.shape}, B = 1 "
                                 f"{ref_codes.shape} {ref_wav.shape}")
        n = codes.shape[0]
        inside = inside_frames(reference, len(inputs[i]), n)
        eq = codes == ref_codes
        row = {"stream": i, "samples": len(inputs[i]), "frames": n, "inside_frames": inside,
               "bitrate": SERVE_BITRATES[i % 3], "switch": switch,
               "codes_inside": float(eq[:inside].mean()), "codes_all": float(eq.mean()),
               "wav_gap_inside": float(np.abs(wav - ref_wav)[: inside * hop].max()),
               "wav_gap_all": float(np.abs(wav - ref_wav).max())}
        if not eq.all():
            frame, bit = (int(v) for v in np.argwhere(~eq)[0])
            row["first_flip"] = {"frame": frame, "bit": bit}
        rows.append(row)
    return rows


def decode_engine_run(codec: BVRNNCodecModel, codes: np.ndarray, lost, eng=None) -> tuple:
    """The B streams' codes (B, n, z) through one ``DecodeEngine(max_streams
    =128)`` (or ``eng``), slot 0 concealed at ``PLC_CONCEAL_BITRATE``, the
    others with every bit: (waveforms (B, n hop), device steps, K1
    launches)."""
    eng = DecodeEngine(codec, max_streams=SERVE_SLOTS) if eng is None else eng
    steps = count_calls(eng)
    tracing.reset()
    sids = [eng.open_stream(conceal_bitrate=PLC_CONCEAL_BITRATE if b == 0 else None)
            for b in range(codes.shape[0])]
    for b, sid in enumerate(sids):
        eng.push(sid, codes[b], lost=None if lost is None else lost[b])
    res = [eng.tick() for _ in range(codes.shape[1])]
    launches = kernel_launches()
    if eng.tick():
        raise AssertionError("the decode engine ticked past its streams' frames")
    return np.stack([np.concatenate([r[sid] for r in res]) for sid in sids]), len(steps), launches


def solo_serve(codec: BVRNNCodecModel, x: np.ndarray, bitrate: float, slots: int = SERVE_SLOTS):
    """A direct ``ServingEngine(max_streams=slots)`` run of one stream,
    flushed as the daemon's CLOSE flushes: (codes (T, z), waveform)."""
    eng = ServingEngine(codec, max_streams=slots)
    sid = eng.open_stream(bitrate)
    eng.push(sid, x)
    eng.begin_flush(sid)
    codes, wav = [], []
    while (res := eng.tick()):
        codes.append(res[sid][0])
        wav.append(res[sid][1])
    return np.stack(codes), np.concatenate(wav)


def native_client() -> str:
    """``bvsc_tpu``'s native BVSP client, built with ``cc`` from its C source
    into the gitignored build directory (a C file read, not an import)."""
    with open(NATIVE_CLIENT, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    exe = os.path.join(_cc.BUILD_DIR, f"bvsp_client-{digest}")
    if not os.path.exists(exe):
        os.makedirs(_cc.BUILD_DIR, exist_ok=True)
        subprocess.run(["cc", "-O2", "-o", exe, NATIVE_CLIENT], check=True, capture_output=True)
    return exe


def parse_frames(blob: bytes) -> list[tuple[int, bytes]]:
    """BVSP wire frames (u8 type, u32 length, payload) from a byte stream."""
    out, pos = [], 0
    while pos < len(blob):
        t, n = struct.unpack_from("<BI", blob, pos)
        out.append((t, blob[pos + 5: pos + 5 + n]))
        pos += 5 + n
    return out


def native_ent_codes(stdout: bytes, z_dim: int) -> tuple:
    """The C client's encode-ent output, CODES_ENT_OUT frames verbatim ->
    (codes, every body byte for byte the port's coder on the same block
    partition, raw bytes, wire bytes)."""
    dec, enc = AdaptiveCodesCoder(z_dim), AdaptiveCodesCoder(z_dim)
    codes, same, raw, wire = [], True, 0, 0
    for t, payload in parse_frames(stdout):
        if t != P.MSG_CODES_ENT_OUT:
            raise AssertionError(f"native encode-ent wrote message 0x{t:02x}")
        frames, bits, body = P.unpack_codes_ent_msg(payload)
        block = dec.decode_block(body, frames, bits)
        same &= enc.encode_block(block, bits) == body
        codes.append(block)
        raw += (frames * bits + 7) // 8
        wire += len(body)
    return np.concatenate(codes), bool(same), raw, wire


def daemon_run(codec: BVRNNCodecModel, inputs: list[np.ndarray], codes: np.ndarray,
               lost: np.ndarray) -> dict:
    """A ``CodecDaemon(max_streams=128)`` on loopback serving six concurrent
    clients: three of the port's client on the raw wire (resynthesis at
    3 kbps and encoding at 1 kbps of two schedule inputs' first
    ``DAEMON_SAMPLES``, and decoding stream 1's codes with its losses), and
    the same encoding and decoding with ``entropy=True``, and the encoding
    through ``bvsc_tpu``'s native C client's ``encode-ent``; against direct
    engine runs of the same streams.  The daemon is closed before this
    returns."""
    from bvsc_tpu_torch.serve.client import CodecClient

    x_res, x_enc = inputs[2][:DAEMON_SAMPLES], inputs[3][:DAEMON_SAMPLES]
    bits = int(np.ceil(codec.bits_per_frame(BITRATE)))  # the codes' allocation: 0.5 past it
    _, ref_res = solo_serve(codec, x_res, 3000.0)
    ref_enc, _ = solo_serve(codec, x_enc, 1000.0)
    dec = DecodeEngine(codec, max_streams=SERVE_SLOTS)
    sid = dec.open_stream()
    dec.push(sid, codes[1], lost=lost[1])
    ref_dec = np.concatenate([dec.tick()[sid] for _ in range(codes.shape[1])])
    exe = native_client()
    results, t0 = {}, time.time()

    errors = {}

    def client(name, mode, bitrate, feed, entropy=False):
        try:
            with CodecClient("127.0.0.1", d.port, mode=mode, bitrate=bitrate, timeout=120,
                             entropy=entropy) as c:
                feed(c)
                c.close_input()
                results[name] = {**c.drain(), "entropy_stats": dict(c.entropy_stats)}
        except Exception as e:  # reported below, with the phase's failure
            errors[name] = repr(e)

    def feed_decode(c):
        pend = []  # blocks of received frames; a loss report keeps its place
        for frame, flag in zip(codes[1], lost[1]):
            if not flag:
                pend.append(frame)
            if pend and (flag or len(pend) == DAEMON_ENT_BLOCK):
                c.send_codes(np.stack(pend), bits=bits)
                pend = []
            if flag:
                c.send_lost(1)
        if pend:
            c.send_codes(np.stack(pend), bits=bits)

    def native(name):
        proc = subprocess.run([exe, "127.0.0.1", str(d.port), "encode-ent", "1000.0"],
                              input=x_enc.astype("<f4").tobytes(), capture_output=True,
                              timeout=120)
        results[name] = {"returncode": proc.returncode, "stdout": proc.stdout,
                         "stderr": proc.stderr.decode(errors="replace")}

    with CodecDaemon(codec, port=0, max_streams=SERVE_SLOTS) as d:
        threads = [threading.Thread(target=client, args=a, daemon=True) for a in (
            ("resynth", "resynth", 3000.0, lambda c: c.send_audio(x_res)),
            ("encode", "encode", 1000.0, lambda c: c.send_audio(x_enc)),
            ("decode", "decode", None, feed_decode),
            ("encode_ent", "encode", 1000.0, lambda c: c.send_audio(x_enc), True),
            ("decode_ent", "decode", None, feed_decode, True))]
        threads.append(threading.Thread(target=native, args=("native_ent",), daemon=True))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        hung = [t.name for t in threads if t.is_alive()]
    if hung or len(results) != len(threads) or results["native_ent"]["returncode"] != 0:
        raise AssertionError(f"daemon clients hung {hung} or failed: got {sorted(results)}, "
                             f"errors {errors}, native: "
                             f"{results.get('native_ent', {}).get('stderr')}")
    nat_codes, nat_same, nat_raw, nat_wire = native_ent_codes(results["native_ent"]["stdout"],
                                                              codec.conf.z_dim)
    enc, enc_ent = results["encode"]["codes"], results["encode_ent"]["codes"]
    return {"seconds": time.time() - t0,
            "resynth_bitwise": bool(np.array_equal(results["resynth"]["audio"], ref_res)),
            "encode_bitwise": bool(np.array_equal(enc, ref_enc)),
            "decode_bitwise": bool(np.array_equal(results["decode"]["audio"], ref_dec)),
            "encode_ent_bitwise": bool(np.array_equal(enc_ent, ref_enc)
                                       and np.array_equal(enc_ent, enc)),
            "decode_ent_bitwise": bool(np.array_equal(results["decode_ent"]["audio"],
                                                      results["decode"]["audio"])),
            "native_ent_bitwise": bool(np.array_equal(nat_codes, ref_enc)),
            "native_ent_bodies_equal": nat_same,
            "entropy_stats": {"encode_ent": results["encode_ent"]["entropy_stats"],
                              "decode_ent": results["decode_ent"]["entropy_stats"],
                              "native_ent": {"raw_payload_bytes": nat_raw,
                                             "wire_payload_bytes": nat_wire}},
            "frames": {"resynth": len(ref_res) // 256, "encode": len(ref_enc),
                       "decode": len(ref_dec) // 256}}


def device_busy(eng, ticks: int) -> dict:
    """Device time of ``ticks`` ticks of ``eng`` from a ``torch.profiler``
    trace: the union of the card's kernel and copy intervals."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            eng.tick()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return {"device_ms_per_tick": "not measured (no device events in the trace)"}
    busy, end = 0.0, -np.inf
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return {"device_ms_per_tick": busy / 1e3 / ticks, "device_ops_per_tick": len(spans) / ticks}


def tick_ms(codec: BVRNNCodecModel, kind: str, active: int, profiled: bool) -> tuple[dict, list]:
    """Milliseconds of ``tick()`` of a 128-slot engine (``kind`` 'serve' or
    'decode') with ``active`` streams advancing every tick: median and p90
    of ``SERVE_STEPS`` ticks after ``SERVE_WARMUP``, each split into its
    device step (``_tick_call``, synchronised) and the host's part (the rest:
    the slot loop, queues, transfers, the read-back).  With ``profiled``,
    the device time of 10 more ticks from a trace, and the stage windows
    one more tick gives K1 (for the kernel check at this shape)."""
    n = SERVE_WARMUP + SERVE_STEPS + 12
    rng = np.random.default_rng([SEED, 300, active])
    hop, z = codec.conf.hopsize, codec.conf.z_dim
    if kind == "serve":
        eng = ServingEngine(codec, max_streams=SERVE_SLOTS)
        for _ in range(active):
            sid = eng.open_stream(BITRATE)
            eng.push(sid, (0.1 * rng.standard_normal(512 + n * hop)).astype(np.float32))
    else:
        eng = DecodeEngine(codec, max_streams=SERVE_SLOTS)
        for _ in range(active):
            sid = eng.open_stream()
            eng.push(sid, (rng.random((n, z)) > 0.5).astype(np.float32),
                     lost=rng.random(n) < PLC_LOSS)
    steps, ticks = count_calls(eng), []
    for _ in range(SERVE_WARMUP + SERVE_STEPS):
        t = time.perf_counter()
        res = eng.tick()
        ticks.append((time.perf_counter() - t) * 1e3)
        if len(res) != active:
            raise AssertionError(f"{kind} tick advanced {len(res)} of {active} streams")
    host = [a - b for a, b in zip(ticks, steps)]
    k = SERVE_WARMUP
    row = {"tick": percentiles(ticks[k:]), "device_step": percentiles(steps[k:]),
           "host": percentiles(host[k:])}
    windows = []
    if profiled:
        del eng._tick_call  # the unwrapped step: no synchronisation
        row.update(device_busy(eng, 10))
        if isinstance(row.get("device_ms_per_tick"), float):
            row["device_idle_share"] = 1 - row["device_ms_per_tick"] / row["tick"]["median"]

        def stage(window, blocks, compute_dtype, ctx=0, start=None):
            windows.append((window, blocks, compute_dtype, ctx, start.clone()))
            return AR.amp_stack(window, blocks, compute_dtype, ctx=ctx, start=start)

        voc_mod.amp_stack = stage
        try:
            eng.tick()
        finally:
            voc_mod.amp_stack = AR.amp_stack
    return row, windows


def tick_kernel_vs_plain(windows: list) -> dict:
    """K1 (or K1-bf16) on one tick's stage windows (128 rows of a 120-sample
    context and the new samples) against ``amp_stack_plain`` with the same
    arguments, with the tick's own starts and with per-row starts, and
    timed by CUDA events (mean of back-to-back calls) beside each stage's
    bound.  Float32 is held to ``KERNEL_TOL``.  In bf16 both versions round
    the same operands and sum in float32 in other orders, so each moves from
    the float32 stage by bf16 rounding noise that grows with the stage's
    values (stage 0 of the trained vocoder reaches ~20): bf16 is held to
    that noise, measured on the same windows by the float32 plain stage,
    the kernel-plain gap within the plain version's own distance from
    float32, and the kernel no further from float32 than plain, with
    ``TICK_BF16_MARGIN``; the gap is printed beside ``BF16_KERNEL_TOL``."""
    stages, ok = [], True
    for window, blocks, mode, ctx, start in windows:
        rows = torch.tensor([0, 5, ctx, 10 * ctx], dtype=torch.int32, device=DEV)
        row = {"shape": [window.shape[0], window.shape[1], ctx, window.shape[2] - ctx],
               "launches": len(blocks), "max_abs_err": [], "noise": [], "kernel_vs_f32": []}
        for st in (start, rows.repeat(window.shape[0] // 4 + 1)[: window.shape[0]].contiguous()):
            kernel = AR.amp_stack(window, blocks, mode, ctx=ctx, start=st)
            plain = AR.amp_stack_plain(window, blocks, mode, ctx=ctx, start=st)
            row["max_abs_err"].append(max_err(kernel, plain))
            if mode == torch.bfloat16:
                f32 = AR.amp_stack_plain(window, blocks, torch.float32, ctx=ctx, start=st)
                row["noise"].append(max_err(plain, f32))
                row["kernel_vs_f32"].append(max_err(kernel, f32))
                ok &= (row["max_abs_err"][-1] <= row["noise"][-1]
                       and row["kernel_vs_f32"][-1] <= TICK_BF16_MARGIN * row["noise"][-1])
            else:
                ok &= row["max_abs_err"][-1] <= KERNEL_TOL
        B, C, T = row["shape"][0], row["shape"][1], row["shape"][3]
        row["bound_ms"], row["bound_by"] = stage_bound_ms(blocks, B, T, mode)
        row["ms"] = cuda_ms(lambda: AR.amp_stack(window, blocks, mode, ctx=ctx, start=start))
        row["plain_ms"] = cuda_ms(lambda: AR.amp_stack_plain(window, blocks, mode, ctx=ctx,
                                                             start=start), reps=5, warmup=1)
        stages.append(row)
    bf16 = windows[0][2] == torch.bfloat16
    return {"stages": stages, "max_abs_err": max(max(s["max_abs_err"]) for s in stages),
            "tol": "bf16 rounding noise" if bf16 else KERNEL_TOL,
            "abs_tol_of_other_bf16_checks": BF16_KERNEL_TOL if bf16 else None, "ok": bool(ok),
            **{k: sum(s[k] for s in stages) for k in ("ms", "plain_ms", "bound_ms")}}


def serving_phase(parity: BVRNNCodecModel, fast: BVRNNCodecModel, wav: np.ndarray,
                  smi: str) -> None:
    """The serving engines and the daemon at 128 slots on the trained pair;
    see the module docstring."""
    t0 = time.time()
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    if bvrnn_mod._use_fused(fast.bvrnn_cfg, SERVE_SLOTS) or not bvrnn_mod._use_fused(fast.bvrnn_cfg, 1):
        raise AssertionError("fast 'auto' should run the standard cell at 128 slots, fused at 1")
    unfused = BVRNNCodecModel(config=fast.conf, bvrnn_params=fast.bvrnn_params,
                              vocoder_params=fast.vocoder_params, precision="default",
                              fused_cell=False, device=DEV)
    n_blocks = sum(len(blocks) for blocks in parity.kernel_blocks)
    inputs = serve_inputs(wav[0])
    report, gates = {}, []
    for name, codec, reference, kernel in (("parity", parity, parity, "f32"),
                                           ("fast", fast, unfused, "bf16")):
        t1 = time.time()
        run = serve_schedule(codec, inputs)
        want = {"f32": 0, "bf16": 0, kernel: n_blocks * run["steps"]}
        held = held_slots(reference, run["out"], inputs)
        first, again = run["out"][SERVE_REOPEN], run["out"]["reopen"]
        r = {"ticks": run["ticks"], "device_steps": run["steps"], "launches": run["launches"],
             "launches_per_tick": run["launches"][kernel] / run["steps"],
             "streams": SERVE_STREAMS + 1, "held": held,
             "reopened_bitwise": bool(np.array_equal(first[0], again[0])
                                      and np.array_equal(first[1], again[1]))}
        gates.append((f"{name}: launches {run['launches']} == {want}", run["launches"] == want))
        gates.append((f"{name}: the reopened slot repeats its first run bitwise",
                      r["reopened_bitwise"]))
        tol = STREAM_TOL if kernel == "f32" else STREAM_FAST_TOL
        for h in held:
            gates.append((f"{name} stream {h['stream']}: audio gap {h['wav_gap_inside']} <= {tol}",
                          h["wav_gap_inside"] <= tol))
            if kernel == "f32":
                gates.append((f"parity stream {h['stream']}: codes bitwise inside "
                              f"({h['codes_inside']})", h["codes_inside"] == 1.0))
        r["seconds"] = time.time() - t1
        report[name] = r

    # the decode engine at parity: plc's losses, against B = 1 decoders
    t1 = time.time()
    x = torch.from_numpy(wav).to(DEV)
    codes = parity.encode(x, BITRATE)
    B, n = codes.shape[:2]
    lost = loss_pattern(B, n)
    first_lost = [int(np.argmax(lost[b] > 0)) for b in range(B)]
    codes_np = codes.cpu().numpy()
    got, steps, launches = decode_engine_run(parity, codes_np, lost)
    clean, _, _ = decode_engine_run(parity, codes_np, None)
    hop = parity.conf.hopsize
    dec = {"streams": B, "frames": n, "lost_frames": int(lost.sum()), "device_steps": steps,
           "launches": launches, "launches_per_tick": launches["f32"] / steps, "slots": []}
    for b in range(B):
        cb = [PLC_CONCEAL_BITRATE] if b == 0 else None
        ref = decode_stream(parity, codes[b: b + 1], lost[b: b + 1], cb)[0].cpu().numpy()
        f = first_lost[b]
        dec["slots"].append({"stream": b, "first_lost": f,
                             "gap_vs_streaming_decoder": float(np.abs(got[b] - ref).max()),
                             "prefix_gap_vs_clean": float(np.abs(got[b, : f * hop]
                                                                 - clean[b, : f * hop]).max())})
    dec["seconds"] = time.time() - t1
    report["decode"] = dec
    gates.append((f"decode launches {launches}", launches == {"f32": n_blocks * steps, "bf16": 0}))
    for s in dec["slots"]:
        gates.append((f"decode stream {s['stream']}: {s['gap_vs_streaming_decoder']} <= {STREAM_TOL}",
                      s["gap_vs_streaming_decoder"] <= STREAM_TOL))
        gates.append((f"decode stream {s['stream']}: prefix bitwise ({s['prefix_gap_vs_clean']})",
                      s["prefix_gap_vs_clean"] == 0.0))

    report["daemon"] = daemon_run(parity, inputs, codes_np, lost)
    for key in ("resynth_bitwise", "encode_bitwise", "decode_bitwise", "encode_ent_bitwise",
                "decode_ent_bitwise", "native_ent_bitwise", "native_ent_bodies_equal"):
        gates.append((f"daemon {key}", report["daemon"][key]))

    # times: both engines, both modes, 1 / 32 / 128 active streams
    t1 = time.time()
    times, tick_kernels = {}, {}
    for name, codec in (("parity", parity), ("fast", fast)):
        for kind in ("serve", "decode"):
            for active in SERVE_ACTIVE:
                profiled = active == SERVE_SLOTS
                row, windows = tick_ms(codec, kind, active, profiled)
                times[f"{name}_{kind}_{active}"] = row
                if profiled and kind == "serve":
                    tick_kernels[name] = tick_kernel_vs_plain(windows)
    packet_ms = hop / parity.conf.fs * 1e3
    served = {f"{name}_{kind}": SERVE_SLOTS * packet_ms / times[f"{name}_{kind}_{SERVE_SLOTS}"]
              ["tick"]["median"] for name in ("parity", "fast") for kind in ("serve", "decode")}
    report["times_seconds"] = time.time() - t1
    for name, k in tick_kernels.items():
        gates.append((f"{name}: K1 at the tick's shape vs plain ({k['max_abs_err']}, {k['tol']})",
                      k["ok"]))
    if (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) != tf32:
        gates.append((f"the TF32 flags changed from {tf32}", False))
    failed = [what for what, ok in gates if not ok]
    emit("serving", t0, slots=SERVE_SLOTS, packet_ms=packet_ms, nvidia_smi=smi, **report,
         tick_ms=times, streams_in_real_time=served, tick_kernel=tick_kernels,
         gates=len(gates), failed=failed)
    if failed:
        raise AssertionError(f"serving: {len(failed)} gates failed: {failed}")


DIRECT_TOL = 1e-4  # the direct parity waveform against the kernel path's (float32, TF32 off)
DIRECT_STREAM_PACKETS = 24  # tests/test_streaming.py's fast streaming contract: 24 packets
DIRECT_VARIANT_FRAMES = 32  # the variants' mel crop: a frame a 256-sample hop
DIRECT_VARIANTS = {"symmetric": {"layers_sym": (True,) * 4, "pre_sym": True, "post_sym": True},
                   "antialiased": {"layers_antialias": (True,) * 4, "antialias_post": True}}


def direct_path_phase(parity: BVRNNCodecModel, fast: BVRNNCodecModel, wav: np.ndarray,
                      smi: str) -> None:
    """The codec's direct vocoder path (``use_pallas=False``) on the trained
    pair and the main batch; see the module docstring.  The numbers are
    printed before any gate is applied."""
    t0 = time.time()
    conf, gates = parity.conf, []
    report = {"nvidia_smi": smi}
    x = torch.from_numpy(wav).to(DEV)
    L = x.shape[1]
    direct = BVRNNCodecModel(config=conf, bvrnn_params=parity.bvrnn_params,
                             vocoder_params=parity.vocoder_params, use_pallas=False, device=DEV)
    dfast = BVRNNCodecModel(config=conf, bvrnn_params=parity.bvrnn_params,
                            vocoder_params=parity.vocoder_params, use_pallas=False,
                            precision="default", device=DEV)
    report["resolved"] = {k: (c.use_pallas, c.approx_snake, c.voc_dtype)
                          for k, c in (("parity", direct), ("fast", dfast))}
    gates.append((f"resolved {report['resolved']}", report["resolved"] == {
        "parity": (False, False, "f32"), "fast": (False, True, "bf16")}))

    def launches_of(fn):
        """(fn's result, the K1 launches of both modes during it)."""
        tracing.reset()
        out = fn()
        return out, kernel_launches()

    zero = {"f32": 0, "bf16": 0}
    runs = {}
    for key, codec, k1 in (("parity", direct, parity), ("fast", dfast, fast)):
        codes, n_enc = launches_of(lambda: codec.encode(x, BITRATE))
        y, n_call = launches_of(lambda: codec(x, BITRATE))
        dec, n_dec = launches_of(lambda: codec.decode(codes, L))
        _, direct_ms = timed(lambda: codec(x, BITRATE))
        k1_y, k1_ms = timed(lambda: k1(x, BITRATE))
        runs[key] = {"codes": codes, "y": y, "decode": dec}
        same = torch.equal(codes, k1.encode(x, BITRATE))
        r = report[key] = {"launches": {"encode": n_enc, "call": n_call, "decode": n_dec},
                           "codes_bitwise_kernel_path": same, "finite": bool(
                               torch.isfinite(y).all() and torch.isfinite(dec).all()),
                           "call_ms": direct_ms, "kernel_path_call_ms": k1_ms}
        gates += [(f"{key}: 0 K1 launches on the direct path {r['launches']}",
                   all(n == zero for n in r["launches"].values())),
                  (f"{key}: codes bitwise the kernel path's", same),
                  (f"{key}: finite {tuple(y.shape)}", r["finite"] and y.shape == x.shape)]
        if key == "parity":
            r["gap_vs_kernel_path"] = (y - k1_y).abs().max().item()
            gates.append((f"parity waveform {r['gap_vs_kernel_path']} <= {DIRECT_TOL} from the "
                          "kernel path's", r["gap_vs_kernel_path"] <= DIRECT_TOL))
    # the reference's fast contract: fast decode of the parity codes
    pc = runs["parity"]["codes"]
    fd, n = launches_of(lambda: dfast.decode(pc, L))
    gap = (fd - runs["parity"]["decode"]).abs().max().item()
    report["fast"]["decode_gap_vs_parity"] = gap
    gates += [(f"fast decode {gap} <= {FAST_WAVE_TOL} from the parity decode",
               gap <= FAST_WAVE_TOL), ("fast decode: 0 K1 launches", n == zero)]

    # streaming and serving, fast: 24 packets, and an 8-slot engine's ticks
    hop = conf.hopsize
    xs = wav[:1, : DIRECT_STREAM_PACKETS * hop]
    codes = dfast.encode(xs, BITRATE)
    ref = dfast.decode(codes, xs.shape[1]).cpu().numpy()

    def packets():
        fc = S.FusedPacketCodec(dfast, batch=1, bitrate=BITRATE)
        outs = [fc.process(xs[:, i: i + hop]) for i in range(0, xs.shape[1], hop)]
        return torch.cat(outs + [fc.flush()], 1).cpu().numpy()

    pkt, n_pkt = launches_of(packets)
    (_, tick), n_tick = launches_of(lambda: solo_serve(dfast, xs[0], BITRATE, EVAL_DAEMON_SLOTS))
    dec = S.StreamingDecoder(dfast, batch=1)
    sdec, n_dec = launches_of(lambda: dec.feed(codes).cpu().numpy())
    (dtick, _, _), n_dtick = launches_of(lambda: decode_engine_run(
        dfast, codes.cpu().numpy(), None, DecodeEngine(dfast, EVAL_DAEMON_SLOTS)))
    m = ref.shape[1]
    report["stream"] = {
        "packets": DIRECT_STREAM_PACKETS, "slots": EVAL_DAEMON_SLOTS,
        "state_dtype": str(S.voc_state_dtype(dfast)),
        "packet_gap": float(np.abs(pkt[:, :m] - ref[:, : pkt.shape[1]]).max()),
        "tick_gap": float(np.abs(tick[:m] - ref[0, : tick.shape[0]]).max()),
        "decoder_gap": float(np.abs(sdec[:, :m] - ref[:, : sdec.shape[1]]).max()),
        "decode_tick_gap": float(np.abs(dtick[:, :m] - ref[:, : dtick.shape[1]]).max()),
        "launches": {"packets": n_pkt, "ticks": n_tick, "decoder": n_dec,
                     "decode_ticks": n_dtick}}
    rs = report["stream"]
    for k in ("packet_gap", "tick_gap", "decoder_gap", "decode_tick_gap"):
        gates.append((f"fast {k} {rs[k]} <= {STREAM_FAST_TOL}", rs[k] <= STREAM_FAST_TOL))
    # the parity packet codec on the same packets, against the parity call
    fc = S.FusedPacketCodec(direct, batch=1, bitrate=BITRATE)
    ppkt, n_ppkt = launches_of(lambda: torch.cat(
        [fc.process(xs[:, i: i + hop]) for i in range(0, xs.shape[1], hop)] + [fc.flush()], 1))
    inside = xs.shape[1] - 2 * hop  # the last two frames' windows reach past the input
    rs["parity_packet_gap"] = (ppkt[:, :inside] - direct(xs, BITRATE)[:, :inside]).abs().max().item()
    rs["launches"]["parity_packets"] = n_ppkt
    gates += [(f"parity packet codec {rs['parity_packet_gap']} <= {STREAM_TOL}",
               rs["parity_packet_gap"] <= STREAM_TOL),
              (f"streams and ticks: 0 K1 launches {rs['launches']}",
               all(n == zero for n in rs["launches"].values()))]

    # the symmetric and the anti-aliased generators, card against CPU
    mel = direct.decode_to_mel(runs["parity"]["codes"])[..., :DIRECT_VARIANT_FRAMES]
    report["variants"] = {}
    for name, ov in DIRECT_VARIANTS.items():
        vcfg = dataclasses.replace(conf.vocoder_config, **ov)
        with torch.no_grad():
            (card, ms), n = launches_of(lambda: timed(lambda: voc_mod.generator_apply(
                parity.vocoder_params, vcfg, mel)))
            cpu = voc_mod.generator_apply(to_torch(parity.vocoder_params, "cpu"), vcfg,
                                          mel.cpu())
        gap = (card.cpu() - cpu).abs().max().item()
        report["variants"][name] = {"shape": list(card.shape), "gap_vs_cpu": gap, "ms": ms,
                                    "launches": n, "peak": card.abs().max().item()}
        gates += [(f"{name} generator card against CPU {gap} <= {DIRECT_TOL}",
                   gap <= DIRECT_TOL and bool(torch.isfinite(card).all())),
                  (f"{name}: 0 K1 launches", n == zero)]
    failed = [what for what, ok in gates if not ok]
    emit("direct_path", t0, **report, gates=len(gates), failed=failed)
    if failed:
        raise AssertionError(f"direct_path: {len(failed)} gates failed: {failed}")


class ExportCLIs:
    """The three bundles of phase ``export`` through ``python -m
    bvsc_tpu_torch.cli.export_cli``, as a user runs it, in processes of
    their own: a parity and a fast one traced on the card and a parity one
    traced on the CPU, each with its output in a log file.  ``main`` starts
    them before phase ``serving``, so that they run beside it and phases
    ``direct_path`` and ``entropy`` (whose times they may lengthen; those
    phases gate no time); ``summary`` waits for one and reads its JSON
    summary; ``close`` stops them and removes the directory."""

    def __init__(self, conf):
        self.tmp = tempfile.mkdtemp(prefix="bvscx-")
        self.paths = {k: os.path.join(self.tmp, f"{k}.bvscx") for k in ("parity", "fast",
                                                                        "parity_cpu")}
        secs = str(EXPORT_CROP / conf.fs)
        self.t0, self.procs = time.time(), {}
        for key, args in (("parity", ("--batch", str(BATCH), "--seconds", secs,
                                      "--engine_batch", str(SERVE_SLOTS))),
                          ("fast", ("--batch", str(BATCH), "--seconds", secs, "--engine_batch",
                                    str(SERVE_SLOTS), "--precision", "default")),
                          ("parity_cpu", ("--device", "cpu", "--seconds", "--engine_batch",
                                          str(SERVE_SLOTS)))):
            log = open(os.path.join(self.tmp, f"{key}.log"), "w")
            self.procs[key] = (subprocess.Popen(
                [sys.executable, "-m", "bvsc_tpu_torch.cli.export_cli", "--out",
                 self.paths[key], *args], cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
                text=True), log)

    def summary(self, key: str) -> dict:
        proc, log = self.procs[key]
        proc.wait(timeout=EXPORT_CLI_TIMEOUT)
        log.close()
        out = open(log.name).read()
        if proc.returncode != 0:
            raise AssertionError(f"the {key} export failed ({proc.returncode}): {out[-3000:]}")
        return json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])

    def close(self) -> None:
        for proc, log in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        shutil.rmtree(self.tmp, ignore_errors=True)


def load_programs(bundle) -> dict:
    """Each program of ``bundle`` loaded (deserialised, moved to the card),
    timed: {program: seconds}."""
    names = [p for b in bundle.meta["buckets"] for p in b["programs"].values()]
    for part, kinds in (("packet", ("step", "decode_step")), ("engine", ("tick", "decode_tick"))):
        names += [bundle.meta[part][k] for k in kinds] if bundle.meta.get(part) else []
    out = {}
    for name in names:
        t = time.perf_counter()
        bundle._program(name)
        out[os.path.basename(name)] = time.perf_counter() - t
    return out


def member_bytes(path: str) -> dict:
    import zipfile

    with zipfile.ZipFile(path) as zf:
        return {i.filename: i.file_size for i in zf.infolist()}


def launched(fn, mode: str) -> tuple:
    """``fn()`` with the K1 launch counts set to 0 before and read after:
    (result, launches of ``mode``'s kernel, launches of the other)."""
    tracing.reset()
    out = fn()
    n = kernel_launches()
    other = "f32" if mode == "bf16" else "bf16"
    return out, n[mode], n[other]


def packet_codes_wav(pc, x: np.ndarray):
    """``x`` (1, n) through a packet codec (live or exported), ``process``
    then ``flush``: (codes (T, z), waveform (n',), steps)."""
    codes, step = [], pc._step

    def recording(chunk):
        out = step(chunk)
        codes.append(out[0][0])
        return out

    pc._step = recording
    wav = torch.cat([pc.process(x), pc.flush()], 1)[0]
    return torch.stack(codes).cpu().numpy(), wav.cpu().numpy(), len(codes)


def bundle_vs_live(name: str, bundle, codec: BVRNNCodecModel, wav: np.ndarray, inputs,
                   codes_full: np.ndarray, lost_full: np.ndarray, live_runs: dict) -> tuple:
    """Every program of ``bundle`` against ``codec`` on the card: the
    one-shot ones at B = 4 on the demo batch's first ``EXPORT_CROP``
    samples, the packet step and the receiver's step at B = 1, the engines'
    ticks on the serving phase's schedule and losses.  Returns (report,
    failed gates)."""
    mode = "bf16" if codec.voc_compute_dtype == torch.bfloat16 else "f32"
    n_blocks = sum(len(blocks) for blocks in codec.kernel_blocks)
    hop = codec.conf.hopsize
    x = torch.from_numpy(np.ascontiguousarray(wav[:, :EXPORT_CROP])).to(DEV)
    rep, gates = {}, []

    def gate(key: str, ok: bool):
        if not ok:
            gates.append(f"{name}: {key}")

    def max_gap(a, b) -> float:
        return max_err(a, b) if a.shape == b.shape else float("inf")

    with torch.no_grad():
        codes = codec.encode(x, BITRATE)
        got = bundle.encode(x, BITRATE)
        rep["encode_bitwise"] = bool(torch.equal(got, codes))
        rep["encode_flipped_bits"] = (int((got != codes).sum().item()) if got.shape == codes.shape
                                      else f"shape {tuple(got.shape)}")
        gate("encode bitwise", rep["encode_bitwise"])
        for kind, live_fn, fn in (
                ("decode", lambda: codec.decode(codes, EXPORT_CROP),
                 lambda: bundle.decode(codes, EXPORT_CROP)),
                ("forward", lambda: codec(x, BITRATE), lambda: bundle(x, BITRATE))):
            ref = live_fn()
            out, n, other = launched(fn, mode)
            rep[kind] = {"max_abs_gap": max_gap(out, ref), "bitwise": bool(torch.equal(out, ref)),
                         "launches": n, "other_launches": other}
            gate(f"{kind} within {EXPORT_TOL}", rep[kind]["max_abs_gap"] <= EXPORT_TOL)
            gate(f"{kind} launches {n}, {other}", n == n_blocks and other == 0)
        mel = codec.decode_to_mel(codes)
        ref = _generator_impl(codec.weights, mel, mel.shape[-1] * hop)
        out = bundle.vocode(mel)
        rep["vocode"] = {"max_abs_gap": max_gap(out, ref), "bitwise": bool(torch.equal(out, ref))}
        gate(f"vocode within {EXPORT_TOL}", rep["vocode"]["max_abs_gap"] <= EXPORT_TOL)

    xp = wav[:1, :EXPORT_PACKET]
    ref_codes, ref_wav, _ = packet_codes_wav(S.FusedPacketCodec(codec, batch=1, bitrate=BITRATE), xp)
    (got_codes, got_wav, steps), n, other = launched(
        lambda: packet_codes_wav(bundle.packet_codec(BITRATE), xp), mode)
    rep["packet_step"] = {"codes_bitwise": bool(np.array_equal(got_codes, ref_codes)),
                          "max_abs_gap": float(np.abs(got_wav - ref_wav).max()),
                          "steps": steps, "launches_per_step": n / steps, "other_launches": other}
    gate("packet codes bitwise", rep["packet_step"]["codes_bitwise"])
    gate(f"packet audio within {EXPORT_TOL}", rep["packet_step"]["max_abs_gap"] <= EXPORT_TOL)
    gate("packet launches", n == n_blocks * steps and other == 0)

    c1 = codes_full[:1, :EXPORT_DECODE_FRAMES]
    l1 = lost_full[:1, :EXPORT_DECODE_FRAMES]
    live = S.StreamingDecoder(codec, batch=1, conceal_bitrate=PLC_CONCEAL_BITRATE)
    ref = torch.cat([live.feed(c1[:, t: t + 1], lost=l1[:, t: t + 1])
                     for t in range(c1.shape[1])], 1)
    out, n, other = launched(
        lambda: bundle.packet_decoder(conceal_bitrate=PLC_CONCEAL_BITRATE).feed(c1, l1), mode)
    rep["packet_decode_step"] = {"max_abs_gap": max_gap(out, ref),
                                 "bitwise": bool(torch.equal(out, ref)), "frames": c1.shape[1],
                                 "lost": int(l1.sum()), "launches_per_step": n / c1.shape[1]}
    gate(f"packet decoder within {EXPORT_TOL}",
         rep["packet_decode_step"]["max_abs_gap"] <= EXPORT_TOL)
    gate("packet decoder launches", n == n_blocks * c1.shape[1] and other == 0)

    run = serve_schedule(codec, inputs, bundle.serving_engine())
    live = live_runs["serve"]
    same = [bool(np.array_equal(run["out"][k][0], live["out"][k][0])) for k in live["out"]]
    gaps = [float(np.abs(run["out"][k][1] - live["out"][k][1]).max()) for k in live["out"]]
    rep["engine_tick"] = {"streams": len(same), "codes_bitwise": all(same),
                          "max_abs_gap": max(gaps), "ticks": run["steps"],
                          "launches_per_tick": run["launches"][mode] / run["steps"]}
    gate("engine codes bitwise", all(same) and len(same) == len(run["out"]))
    gate(f"engine audio within {EXPORT_TOL}", max(gaps) <= EXPORT_TOL)
    gate("engine launches", run["launches"][mode] == n_blocks * run["steps"])
    out, steps, launches = decode_engine_run(codec, codes_full, lost_full, bundle.decode_engine())
    ref = live_runs["decode"]
    rep["engine_decode_tick"] = {"max_abs_gap": float(np.abs(out - ref).max()),
                                 "bitwise": bool(np.array_equal(out, ref)), "ticks": steps,
                                 "launches_per_tick": launches[mode] / steps}
    gate(f"decode engine within {EXPORT_TOL}",
         rep["engine_decode_tick"]["max_abs_gap"] <= EXPORT_TOL)
    gate("decode engine launches", launches[mode] == n_blocks * steps)
    return rep, gates, run


def daemon_wire(server, inputs: list[np.ndarray], codes: np.ndarray, lost: np.ndarray) -> dict:
    """Three concurrent clients of a ``CodecDaemon`` on ``server`` (a live
    codec or a bundle): resynthesis at 3 kbps, encoding at 1 kbps with
    ``entropy=True``, decoding stream 1's codes with its losses.  The
    daemon is closed before this returns."""
    from bvsc_tpu_torch.serve.client import CodecClient

    x_res, x_enc = inputs[1][:DAEMON_SAMPLES], inputs[2][:DAEMON_SAMPLES]
    bits = int(np.ceil(server.bits_per_frame(BITRATE)))
    results, errors = {}, {}

    def client(key, mode, bitrate, feed, entropy=False):
        try:
            with CodecClient("127.0.0.1", d.port, mode=mode, bitrate=bitrate, timeout=120,
                             entropy=entropy) as c:
                feed(c)
                c.close_input()
                results[key] = {**c.drain(), "entropy_stats": dict(c.entropy_stats)}
        except Exception as e:  # reported below, with the phase's failure
            errors[key] = repr(e)

    def feed_decode(c):
        for frame, flag in zip(codes[1], lost[1]):
            if flag:
                c.send_lost(1)
            else:
                c.send_codes(frame[None], bits=bits)

    with CodecDaemon(server, port=0) as d:
        threads = [threading.Thread(target=client, args=a, daemon=True) for a in (
            ("resynth", "resynth", 3000.0, lambda c: c.send_audio(x_res)),
            ("encode_ent", "encode", 1000.0, lambda c: c.send_audio(x_enc), True),
            ("decode", "decode", None, feed_decode))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        hung = [t.name for t in threads if t.is_alive()]
    if hung or errors:
        raise AssertionError(f"daemon clients hung {hung} or failed: {errors}")
    return results


def tick_pair_ms(engines: dict) -> dict:
    """Milliseconds of ``tick()`` at 128 active streams of each engine (the
    engines ticked in turns, ``EXPORT_TICKS`` each after ``SERVE_WARMUP``):
    median and p90."""
    n = SERVE_WARMUP + EXPORT_TICKS
    for eng in engines.values():
        for i in range(SERVE_SLOTS):
            rng = np.random.default_rng([SEED, 400, i])
            sid = eng.open_stream(BITRATE)
            eng.push(sid, (0.1 * rng.standard_normal(512 + n * 256)).astype(np.float32))
    times = {key: [] for key in engines}
    for _ in range(n):
        for key, eng in engines.items():
            t = time.perf_counter()
            res = eng.tick()
            times[key].append((time.perf_counter() - t) * 1e3)
            if len(res) != SERVE_SLOTS:
                raise AssertionError(f"{key} tick advanced {len(res)} of {SERVE_SLOTS} streams")
    return {key: percentiles(v[SERVE_WARMUP:]) for key, v in times.items()}


def tick_windows(codec: BVRNNCodecModel) -> list:
    """The (window, stage, mode, ctx, start) each stage's ``amp_stack`` gets
    in one tick of a 128-slot engine with every slot active."""
    eng = ServingEngine(codec, max_streams=SERVE_SLOTS)
    rng = np.random.default_rng([SEED, 500])
    for _ in range(SERVE_SLOTS):
        eng.push(eng.open_stream(BITRATE),
                 (0.1 * rng.standard_normal(768 + 4 * 256)).astype(np.float32))
    eng.tick()
    eng.tick()
    windows = []

    def stage(window, blocks, compute_dtype, ctx=0, start=None):
        windows.append((window, blocks, compute_dtype, ctx, start.clone()))
        return AR.amp_stack(window, blocks, compute_dtype, ctx=ctx, start=start)

    voc_mod.amp_stack = stage
    try:
        eng.tick()
    finally:
        voc_mod.amp_stack = AR.amp_stack
    return windows


def op_host_us(codec: BVRNNCodecModel, windows: list) -> dict:
    """Host microseconds a launch costs through the mode's op (``OPS``,
    the dispatcher: a bundle's route), through its direct implementation
    (``ops.amp_resblock.launch``) and through ``amp_resblock`` (the live
    route), on one tick's stage windows: the host time to issue
    ``EXPORT_OP_CALLS`` launches of each stage's first block, in turns,
    synchronised between the rounds, the median round per launch.  The
    three produce the same bits."""
    mode = codec.voc_compute_dtype
    rows, same = [], True
    for window, blocks, _, ctx, start in windows:
        rb = blocks[0]
        t = rb.op_tensors(mode)
        args = (window, t["w1"], t["b1"], t["w2"], t["b2"], t["alpha"], t["inv_beta"], start,
                rb.kernel_size, list(rb.dilations), ctx, 0)
        fns = {"op": lambda: AR.OPS[mode](*args), "direct": lambda: AR.launch(*args, mode),
               "wrapper": lambda: AR.amp_resblock(window, rb, mode, ctx=ctx, start=start)}
        outs = [fn() for fn in fns.values()]
        same &= all(torch.equal(o, outs[0]) for o in outs)
        times = {key: [] for key in fns}
        for _ in range(5):
            for key, fn in fns.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(EXPORT_OP_CALLS):
                    fn()
                times[key].append((time.perf_counter() - t0) * 1e6 / EXPORT_OP_CALLS)
        torch.cuda.synchronize()
        rows.append({"shape": list(window.shape), "ctx": ctx,
                     **{f"{k}_us": float(np.median(v)) for k, v in times.items()}})
    mean = {k: float(np.mean([r[f"{k}_us"] for r in rows])) for k in fns}
    return {"stages": rows, **{f"{k}_us": v for k, v in mean.items()},
            "op_minus_direct_us": mean["op"] - mean["direct"],
            "op_per_tick_ms": 12 * (mean["op"] - mean["direct"]) / 1e3, "same_bits": same}


def split_seconds(report: dict):
    """A function that records, under ``report["split_seconds"][name]``, the
    seconds since its previous call (or since it was made)."""
    report["split_seconds"], last = {}, [time.time()]

    def mark(name: str) -> None:
        now = time.time()
        report["split_seconds"][name] = now - last[0]
        last[0] = now

    return mark


def export_phase(parity: BVRNNCodecModel, fast: BVRNNCodecModel, wav: np.ndarray,
                 smi: str, keep: str, clis: ExportCLIs) -> str:
    """AOT serving bundles (``bvsc_tpu_torch.serve.export``) on the trained
    pair; see the module docstring.  ``clis`` exported the three bundles
    meanwhile.  Moves the parity bundle into ``keep`` (phase ``parallel``
    serves it sharded) and returns its path."""
    from bvsc_tpu_torch.serve.export import ServingBundle

    t0 = time.time()
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    paths = clis.paths
    report, gates = {"nvidia_smi": smi}, []
    try:
        report["export"] = {}
        for key in paths:
            summary = clis.summary(key)
            report["export"][key] = {k: summary[k] for k in ("export_seconds", "program_bytes",
                                                            "traced_on", "serving")}
        # the CLIs ran from before phase serving; this phase waited for them
        report["export"]["concurrent_wall_s"] = time.time() - clis.t0
        report["export"]["waited_s"] = time.time() - t0
        mark = split_seconds(report)
        report["bundle_bytes"] = {k: member_bytes(p) for k, p in paths.items()}

        bundles, report["load_seconds"] = {}, {}
        for key, path in paths.items():
            t = time.perf_counter()
            bundles[key] = ServingBundle(path, device=DEV)
            report["load_seconds"][key] = {"manifest_and_weights": time.perf_counter() - t,
                                           "programs": load_programs(bundles[key])}
        mark("load")
        if bundles["parity_cpu"].meta["traced_on"] != "cpu":
            gates.append("the CPU bundle was not traced on the CPU")

        inputs = serve_inputs(wav[0])
        codes_full = parity.encode(torch.from_numpy(wav).to(DEV), BITRATE).cpu().numpy()
        lost_full = loss_pattern(*codes_full.shape[:2])
        for key, codec in (("parity", parity), ("fast", fast)):
            live_runs = {"serve": serve_schedule(codec, inputs),
                         "decode": decode_engine_run(codec, codes_full, lost_full)[0]}
            rep, bad, run = bundle_vs_live(key, bundles[key], codec, wav, inputs, codes_full,
                                           lost_full, live_runs)
            report[key] = rep
            gates += bad
            if key == "parity":
                parity_run, parity_decode = run, decode_engine_run(
                    parity, codes_full, lost_full, bundles["parity"].decode_engine())[0]
            mark(f"bundle_vs_live_{key}")

        # the CPU-traced bundle on the card against the card-traced one
        cpu_b, xp = bundles["parity_cpu"], wav[:1, :EXPORT_PACKET]
        a = packet_codes_wav(cpu_b.packet_codec(BITRATE), xp)
        b = packet_codes_wav(bundles["parity"].packet_codec(BITRATE), xp)
        run = serve_schedule(parity, inputs, cpu_b.serving_engine())
        dec = decode_engine_run(parity, codes_full, lost_full, cpu_b.decode_engine())[0]
        report["cpu_traced"] = {
            "packet_bitwise": bool(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])),
            "packet_max_abs_gap": float(np.abs(a[1] - b[1]).max()),
            "engine_bitwise": all(np.array_equal(run["out"][k][i], parity_run["out"][k][i])
                                  for k in run["out"] for i in (0, 1)),
            "engine_max_abs_gap": max(float(np.abs(run["out"][k][1] - parity_run["out"][k][1])
                                            .max()) for k in run["out"]),
            "decode_engine_bitwise": bool(np.array_equal(dec, parity_decode))}
        for key in ("packet_bitwise", "engine_bitwise", "decode_engine_bitwise"):
            if not report["cpu_traced"][key]:
                gates.append(f"cpu-traced bundle: {key}")
        mark("cpu_traced")

        wire = {"live": daemon_wire(parity, inputs, codes_full, lost_full),
                "bundle": daemon_wire(bundles["parity"], inputs, codes_full, lost_full)}
        report["daemon"] = {}
        for key, field in (("resynth", "audio"), ("encode_ent", "codes"), ("decode", "audio")):
            same = bool(np.array_equal(wire["bundle"][key][field], wire["live"][key][field]))
            report["daemon"][f"{key}_bitwise"] = same
            if not same:
                gates.append(f"daemon {key} wire")
        same = wire["bundle"]["encode_ent"]["entropy_stats"] == \
            wire["live"]["encode_ent"]["entropy_stats"]
        report["daemon"]["entropy_stats_equal"] = same
        if not same:
            gates.append("daemon entropy wire bytes")
        mark("daemon_wire")

        for key, codec in (("parity", parity), ("fast", fast)):
            report.setdefault("tick_ms_128", {})[key] = tick_pair_ms(
                {"live": ServingEngine(codec, max_streams=SERVE_SLOTS),
                 "bundle": bundles[key].serving_engine()})
        mark("tick_ms")
        for key, codec in (("parity", parity), ("fast", fast)):
            windows = tick_windows(codec)
            report.setdefault("op_host_us", {})[key] = op_host_us(codec, windows)
            if not report["op_host_us"][key]["same_bits"]:
                gates.append(f"{key}: op and direct launch differ")
        mark("op_host_us")
        if (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) != tf32:
            gates.append("the TF32 flags changed")
        kept = shutil.move(paths["parity"], os.path.join(keep, "parity.bvscx"))
    finally:
        clis.close()
    emit("export", t0, **report, gates_failed=gates)
    if gates:
        raise AssertionError(f"export phase: {gates}")
    return kept


def train_filelist(tmp: str) -> str:
    """A filelist of the demo utterance, the phase's corpus, in ``tmp``."""
    path = os.path.join(tmp, "train.txt")
    with open(path, "w") as f:
        f.write(os.path.splitext(os.path.basename(WAV))[0] + "|demo\n")
    return path


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def tree_gap(a: list, b: list) -> float:
    return max((x.detach().cpu() - y.detach().cpu()).abs().max().item() for x, y in zip(a, b))


def timed_steps(fn, n: int) -> tuple[list, list[float]]:
    """``fn()`` n times, each synchronised; (results, ms of each)."""
    out, ms = [], []
    for _ in range(n):
        r, t = timed(fn)
        out.append(r)
        ms.append(t)
    return out, ms


def train_bvrnn_checks(conf, corpus: AudioSegmentDataset, mean_std, tmp: str, gates: list) -> tuple:
    """Card against CPU, the full-size run, the fused and bf16 modes and the
    resume; returns (report, the full-size trainer)."""
    rep = {}
    t0 = time.time()
    # 1. one step at full width, B = 2, 0.5-s segments: card against CPU
    seg = int(TRAIN_CHECK_SECONDS * conf.fs) // conf.hopsize * conf.hopsize
    audio = np.stack([corpus[0][0][:seg] for _ in range(TRAIN_CHECK_BATCH)])
    card_fe = bvrnn_frontend(conf, DEV)
    mel = card_fe(torch.from_numpy(audio).to(DEV)).transpose(1, 2)
    init = bvrnn_mod.init_bvrnn_params(SEED, bvrnn_mod.BVRNNConfig(
        x_dim=conf.num_mels, h_dim=conf.h_dim, z_dim=conf.z_dim), mean_std_mel=mean_std,
        log_sigma_init=conf.log_sigma_init)
    pair = [BT.BVRNNTrainer(conf, params=init, seed=SEED, device=d) for d in (DEV, "cpu")]
    metrics = [tr.step(mel.to(tr.device)) for tr in pair]
    rep["card_vs_cpu"] = {
        "batch": TRAIN_CHECK_BATCH, "frames": mel.shape[1],
        "loss_rel": rel_gap(float(metrics[0]["loss"]), float(metrics[1]["loss"])),
        "grad_norm_rel": rel_gap(float(metrics[0]["grad_norm"]), float(metrics[1]["grad_norm"])),
        "param_abs": tree_gap(pair[0].leaves, pair[1].leaves),
        "loss": float(metrics[1]["loss"]), "seconds": time.time() - t0}
    cc = rep["card_vs_cpu"]
    gates += [(f"BVRNN loss card/CPU {cc['loss_rel']}", cc["loss_rel"] <= TRAIN_LOSS_RTOL),
              (f"BVRNN grad norm card/CPU {cc['grad_norm_rel']}",
               cc["grad_norm_rel"] <= TRAIN_GRAD_RTOL),
              (f"BVRNN params card/CPU {cc['param_abs']}", cc["param_abs"] <= TRAIN_PARAM_TOL)]
    del pair

    # 2. full size: batch 32, 4.0-s segments, TRAIN_STEPS steps
    t0 = time.time()
    batches = corpus.batches(conf.batch_size)
    mels = [card_fe(torch.from_numpy(next(batches)[0]).to(DEV)).transpose(1, 2)
            for _ in range(TRAIN_STEPS)]
    full = BT.BVRNNTrainer(conf, params=init, seed=SEED, device=DEV)
    it = iter(mels)
    results, ms = timed_steps(lambda: full.step(next(it)), TRAIN_STEPS)
    losses = [float(m["loss"]) for m in results]
    rep["full"] = {"batch": conf.batch_size, "frames": mels[0].shape[1], "losses": losses,
                   "ms_per_step": float(np.median(ms[1:])), "first_ms": ms[0]}
    gates += [("every full-size loss finite", all(np.isfinite(losses))),
              (f"full-size loss falls {losses[0]} -> {np.mean(losses[-3:])}",
               np.mean(losses[-3:]) < losses[0])]
    for mode, kw in (("fused", {"fused_cell": True}), ("bf16", {"compute_dtype": "bf16"})):
        tr = BT.BVRNNTrainer(conf, params=init, seed=SEED, device=DEV, **kw)
        res, mode_ms = timed_steps(lambda: tr.step(mels[0]), 2)
        first = float(res[0]["loss"])
        rep[mode] = {"first_loss": first, "ms_per_step": mode_ms[1], "first_ms": mode_ms[0]}
        gates.append((f"{mode} first loss {first} against standard {losses[0]}",
                      abs(first - losses[0]) < TRAIN_MODE_RTOL * max(1.0, abs(losses[0]))))
    rep["full"]["seconds"] = time.time() - t0
    set_parity_mode()  # the bf16 trainer leaves the flags alone; the others set them

    # 3. resume: 2 steps, save, restore into a new trainer, 2 more
    t0 = time.time()
    small = mels[0][:TRAIN_RESUME_BATCH, :TRAIN_RESUME_FRAMES]
    whole = BT.BVRNNTrainer(conf, params=init, seed=SEED, mel_mask={}, device=DEV)
    for _ in range(4):
        whole.step(small)
    first = BT.BVRNNTrainer(conf, params=init, seed=SEED, mel_mask={}, device=DEV)
    for _ in range(2):
        first.step(small)
    ckpt.save_step(tmp, "bvrnn_", first.step_count, first.state_dict())
    second = BT.BVRNNTrainer(conf, seed=SEED + 1, mel_mask={}, device=DEV)
    state, step = ckpt.restore_latest(tmp, "bvrnn_")
    second.load_state_dict(state)
    for _ in range(2):
        second.step(small)
    bitwise = all(torch.equal(a, b) for a, b in zip(
        whole.leaves + whole.opt.mu + whole.opt.nu, second.leaves + second.opt.mu + second.opt.nu))
    rep["resume"] = {"batch": TRAIN_RESUME_BATCH, "frames": TRAIN_RESUME_FRAMES,
                     "restored_step": step, "bitwise": bitwise, "seconds": time.time() - t0}
    gates.append(("resume bitwise 4 unbroken steps", bitwise and second.step_count == 4))
    return rep, full


def bvrnn_frontend(conf, device) -> MelFrontend:
    return MelFrontend(sampling_rate=conf.fs, n_fft=conf.winsize, num_mels=conf.num_mels,
                       hop_size=conf.hopsize, fmin=conf.fmin, fmax=conf.fmax,
                       padding_left=conf.mel_pad_left, device=device)


def train_serve_check(conf, trainer, tmp: str, speech: np.ndarray, gates: list):
    """Export the trained BVRNN through the export CLI, serve it with the
    trained vocoder; returns (report, the codec)."""
    src = ckpt.save_step(tmp, "bvrnn_", trainer.step_count, trainer.state_dict())
    dst = os.path.join(tmp, "trained.npz")
    export_bvrnn_npz.main([src, dst])
    codec = BVRNNCodecModel(config=conf, bvrnn_chkpt_path=dst, vocoder_chkpt_path=VOC_NPZ,
                            device=DEV)
    n_blocks = sum(len(blocks) for blocks in codec.kernel_blocks)
    tracing.reset()
    y = codec(torch.from_numpy(speech[None]).to(DEV), BITRATE)
    launches = kernel_launches()
    rep = {"npz_bytes": os.path.getsize(dst), "launches": launches,
           "finite": bool(torch.isfinite(y).all()), "samples": y.shape[-1]}
    gates += [(f"trained BVRNN resynthesis launches {launches}",
               launches == {"f32": n_blocks, "bf16": 0} and n_blocks == 12),
              ("trained BVRNN resynthesis finite", rep["finite"]),
              ("trained BVRNN resynthesis length", y.shape[-1] == speech.shape[0])]
    return rep, codec


def gan_setup(conf, corpus: AudioSegmentDataset):
    """(vocoder config, GANTrainConfig with the codec's DSP keys and
    ``freeze_step`` 1, the generator warm start as ``--init_generator``
    reads it, one batch of crops (32, 8192))."""
    tcfg = VT.GANTrainConfig(freeze_step=1, sampling_rate=conf.fs, n_fft=conf.winsize,
                             hop_size=conf.hopsize, win_size=conf.winsize, fmin=conf.fmin,
                             fmax=conf.fmax, mel_pad_left=conf.mel_pad_left)
    crops = AudioSegmentDataset(corpus.audio_files, tcfg.segment_size, conf.fs,
                                conf.hopsize, seed=SEED).batches(tcfg.batch_size)
    return conf.vocoder_config, tcfg, train_vocoder.load_generator(VOC_NPZ), next(crops)[0]


def train_gan_checks(conf, corpus: AudioSegmentDataset, codec: BVRNNCodecModel, gates: list):
    """Three full-size GAN steps (D frozen at step 0), then one fine-tuning
    step on the trained BVRNN's decoded mel."""
    vcfg, tcfg, gen, y = gan_setup(conf, corpus)
    rep = {"batch": tcfg.batch_size, "segment": tcfg.segment_size}
    tr = VT.VocoderGANTrainer(vcfg, tcfg, seed=SEED, gen_params=gen, device=DEV)

    def disc():
        return [t.detach().clone() for t in tr._d.tensors]

    d0 = disc()
    res, ms = [], []
    for step in range(TRAIN_GAN_STEPS):
        r, t = timed(lambda: tr.step_on_audio(y))
        res.append({k: float(v) for k, v in r.items()})
        ms.append(t)
        if step == 0:
            d1 = disc()
    d_frozen = all(torch.equal(a, b) for a, b in zip(d0, d1))
    d_moved = any(not torch.equal(a, b) for a, b in zip(d1, disc()))
    rep.update(metrics=res, ms_per_step=float(np.median(ms[1:])), first_ms=ms[0])
    gates += [("D unchanged at step 0", d_frozen), ("D changed after step 1", d_moved),
              ("every GAN loss finite", all(np.isfinite(list(r.values())).all() for r in res))]

    # fine-tuning: the trained BVRNN's decoded mel of the same crops, the
    # target at the codec's -10 dB (train_vocoder's --fine_tuning default)
    x = torch.from_numpy(y).to(DEV)
    mel_in = codec.decode_to_mel(codec.encode(x, BITRATE))
    r, t = timed(lambda: tr.step_on_audio(x * SCALING, mel_in))
    rep["fine_tuning"] = {"mel_in": list(mel_in.shape), "ms": t,
                          "gen_loss_total": float(r["gen_loss_total"])}
    gates.append(("fine-tuning step finite",
                  all(np.isfinite(float(v)) for v in r.values())))
    return rep


def train_gan_card_vs_cpu(conf, corpus: AudioSegmentDataset, gates: list) -> dict:
    """The first GAN step's D and G losses on the card against the CPU, at
    batch 2, from the same weights (the card trainer's seeded D)."""
    vcfg, tcfg, gen, y = gan_setup(conf, corpus)
    card = VT.VocoderGANTrainer(vcfg, tcfg, seed=SEED, gen_params=gen, device=DEV)
    cpu = VT.VocoderGANTrainer(vcfg, tcfg, gen_params=gen, mpd_params=card.mpd,
                               mrd_params=card.mrd, device="cpu")
    m = [tr.step_on_audio(y[:TRAIN_CHECK_BATCH]) for tr in (card, cpu)]
    rep = {k: rel_gap(float(m[0][k]), float(m[1][k]))
           for k in ("disc_loss_mpd", "disc_loss_mrd", "gen_loss_total")}
    gates += [(f"GAN {k} card/CPU {v}", v <= TRAIN_GAN_RTOL) for k, v in rep.items()]
    return rep


class TrainCLIs:
    """Both trainer CLIs on the card, each into its own run directory, run
    in this process through their ``main`` (no process start to wait for):
    ``run(steps, gates)`` trains each to ``steps``, resuming where an
    earlier run stopped."""

    def __init__(self, filelist: str, wavs: str, tmp: str):
        self.tmp = tmp
        common = ["--input_wavs_dir", wavs, "--input_training_file", filelist,
                  "--input_validation_file", filelist, "--stdout_interval", "1",
                  "--batch_size", str(TRAIN_CLI_BATCH), "--device", str(DEV),
                  "--config", DEFAULT_CONFIG]
        self.args = {
            "train_bvrnn": common + ["--stats_batches", "1", "--val_interval", "2"],
            "train_vocoder": common + ["--freeze_step", "1", "--validation_interval", "2",
                                       "--init_generator", VOC_NPZ]}
        self.report, self.last = {}, 0

    def run(self, steps: int, gates: list) -> None:
        t0 = time.time()
        for m, mod in (("train_bvrnn", train_bvrnn), ("train_vocoder", train_vocoder)):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                mod.main([*self.args[m], "--checkpoint_path", os.path.join(self.tmp, m),
                          "--max_steps", str(steps)])
            out = out.getvalue()
            self.report[f"{m}_{steps}"] = {"in_process": True,
                                           "tail": out.strip().splitlines()[-3:]}
            resumed = not self.last or f"resumed from step {self.last}" in out
            gates.append((f"{m} to step {steps} in this process"
                          + (f", resumed from step {self.last}" if self.last else ""),
                          f"done at step {steps}" in out and resumed))
        self.report[f"seconds_{steps}"] = time.time() - t0
        self.last = steps


def train_phase(wav: np.ndarray, smi: str) -> None:
    """Training on the card: the BVRNN and the GAN trainers at the full width
    of the default config, their CLIs and the trained BVRNN served; see the
    module docstring.  The numbers are printed before any gate is applied."""
    t0 = time.time()
    conf = load_config(DEFAULT_CONFIG)
    gates, report = [], {"nvidia_smi": smi}
    with tempfile.TemporaryDirectory(prefix="bvsc-train-") as tmp:
        filelist = train_filelist(tmp)
        segment = int(conf.train_seq_duration * conf.fs) // conf.hopsize * conf.hopsize
        corpus = AudioSegmentDataset([WAV], segment, conf.fs, conf.hopsize, seed=SEED,
                                     augment=train_bvrnn.AUGMENT)
        stats = bvrnn_frontend(conf, DEV)(torch.from_numpy(next(corpus.batches(
            conf.batch_size))[0]).to(DEV)).transpose(1, 2).reshape(-1, conf.num_mels)
        mean_std = (stats.mean(0).cpu().numpy(), stats.std(0, correction=0).cpu().numpy() + 1e-5)
        t = time.time()
        report["bvrnn"], trainer = train_bvrnn_checks(conf, corpus, mean_std, tmp, gates)
        report["bvrnn"]["seconds"] = time.time() - t
        t = time.time()
        report["serve"], codec = train_serve_check(conf, trainer, tmp, wav[0], gates)
        report["serve"]["seconds"] = time.time() - t
        t = time.time()
        report["gan"] = train_gan_checks(conf, corpus, codec, gates)
        report["gan"]["seconds"] = time.time() - t
        del trainer, codec
        t = time.time()
        report["gan"]["card_vs_cpu"] = train_gan_card_vs_cpu(conf, corpus, gates)
        report["gan"]["card_vs_cpu_seconds"] = time.time() - t
        # both CLIs through their main in this process, then resumed
        # (phases parallel and eval start them as processes)
        clis = TrainCLIs(filelist, os.path.dirname(WAV), tmp)
        clis.run(2, gates)
        clis.run(4, gates)
        report["cli"] = clis.report
    set_parity_mode()
    failed = [what for what, ok in gates if not ok]
    emit("train", t0, **report, gates=len(gates), failed=failed)
    if failed:
        raise AssertionError(f"train: {len(failed)} gates failed: {failed}")


PAR_RANKS = 2  # ranks of the parallel phase, all on the one card
PAR_DEVICE = "cuda:0"  # every rank's device: gloo, since NCCL refuses two ranks on one card
PAR_MICRO, PAR_MICRO_FRAMES = 3, 64  # pipeline microbatches: 64-frame slices of the batch
PAR_TIMED_FRAMES = 64  # frames of the timed (warm) TP and one-device scans
PAR_TRAIN_BATCH = 4  # the data-parallel steps' global batch, split over the ranks
PAR_STREAMS = 6  # schedule streams through the sharded 128-slot engines
PAR_STREAM_SAMPLES = 8192  # each stream's crop of its serving-phase input
PAR_DECODE_FRAMES = 48  # frames of each stream through the sharded decode engines
PAR_TIMEOUT = 300  # seconds the ranks, or a trainer CLI process, may take
TP_MEL_TOL = 2e-5  # tensor-parallel mel and h against one device (tests/test_tp.py's bound)
SP_TOL = 1e-5  # sequence-parallel vocoder against one-shot (the overlap adds' sums)
PP_WAV_TOL = 1e-6  # pipelined waveform against the unpipelined run (tests/test_pp.py's)
DP_TOL = 1e-5  # a data-parallel step against one rank's: metrics relative, params absolute
ILL_CONDITIONED_G = 1e-7  # an Adam step of a weight whose gradient is this near 0 is noise


def dp_gaps(dp, one, dp_m: dict, one_m: dict, params, opt) -> dict:
    """A data-parallel trainer against one rank's after the same steps: the
    largest relative metric gap, the largest parameter gap outside the
    weights whose first Adam moment says their gradient was within
    ``ILL_CONDITIONED_G`` of 0 (their move is float noise), and how many
    were left out."""
    rel = max(rel_gap(float(dp_m[k]), float(one_m[k])) for k in one_m)
    worst, worst_all, ill = 0.0, 0.0, 0
    for a, b, mu in zip(params(dp), params(one), opt(one).mu):
        keep = (mu / (1 - opt(one).b1)).abs() >= ILL_CONDITIONED_G
        gap = (a - b).detach().abs()
        ill += int((~keep).sum())
        worst_all = max(worst_all, float(gap.max()))
        if keep.any():
            worst = max(worst, float(gap[keep].max()))
    return {"metric_rel": rel, "param_abs": worst, "param_abs_all": worst_all,
            "ill_conditioned": ill}


def parallel_ranks(n: int, inp: dict) -> dict:
    """One rank's part of phase ``parallel`` (``parallel.dryrun.run_ranks``
    spawns it on every rank; all on ``PAR_DEVICE``): TP encode and decode,
    the SP vocoder, the pipeline, and a data-parallel step of each trainer;
    rank 0 also runs the one-rank steps the DP steps are held against."""
    from bvsc_tpu_torch.convert import load_vocoder_npz, to_torch
    from bvsc_tpu_torch.parallel import pp as PPL
    from bvsc_tpu_torch.parallel import sp as SPL
    from bvsc_tpu_torch.parallel import tp as TPL
    from bvsc_tpu_torch.parallel.mesh import make_mesh

    set_parity_mode()
    devices = [PAR_DEVICE] * n
    mesh = make_mesh(devices=devices)
    dev, rank = mesh.device, mesh.rank
    conf = load_config(DEFAULT_CONFIG)
    cfg = bvrnn_mod.BVRNNConfig(x_dim=conf.num_mels, h_dim=conf.h_dim, z_dim=conf.z_dim)
    bvrnn = load_bvrnn_npz(NPZ)
    out = {}

    # tensor parallelism: encode, then decode of the one-device codes
    tmesh = TPL.make_tp_mesh(devices=devices)
    tpp = TPL.shard_tp_params(TPL.prepare_tp_params(bvrnn), tmesh)
    y, bits, codes = (torch.from_numpy(inp[k]).to(dev) for k in ("y", "bits", "codes"))
    h0 = torch.zeros(y.shape[0], conf.h_dim, device=dev)
    z_tp, h_enc = TPL.encode_tp(tpp, cfg, y, bits, h0, tmesh)
    mel_tp, h_dec = TPL.decode_tp(tpp, cfg, codes, h0, tmesh)
    k = PAR_TIMED_FRAMES  # warm calls, timed
    _, enc_ms = timed(lambda: TPL.encode_tp(tpp, cfg, y[:, :k], bits[:, :k], h0, tmesh))
    _, dec_ms = timed(lambda: TPL.decode_tp(tpp, cfg, codes[:, :k], h0, tmesh))
    out["tp"] = {"codes": z_tp.cpu().numpy(), "h_enc": h_enc.cpu().numpy(),
                 "mel": mel_tp.cpu().numpy(), "h_dec": h_dec.cpu().numpy(),
                 "encode_ms_per_frame": enc_ms / k, "decode_ms_per_frame": dec_ms / k}

    # sequence parallelism on the trained vocoder: the first call counted,
    # the second timed
    vcfg = conf.vocoder_config
    voc = to_torch(load_vocoder_npz(VOC_NPZ), dev)
    blocks = voc_mod.prepare_kernel_params(voc, vcfg)
    smesh = SPL.make_sp_mesh(devices=devices)
    mel = torch.from_numpy(inp["mel"]).to(dev)
    tracing.reset()
    wav_sp = SPL.generator_apply_sp(voc, vcfg, mel, smesh, kernel_blocks=blocks)
    launches = kernel_launches()
    _, sp_ms = timed(lambda: SPL.generator_apply_sp(voc, vcfg, mel, smesh, kernel_blocks=blocks))
    out["sp"] = {"wav": wav_sp.cpu().numpy(), "launches": launches, "ms": sp_ms}

    # the two-stage pipeline
    tracing.reset()
    (codes_pp, wav_pp), pp_ms = timed(lambda: PPL.pipeline_resynth(
        bvrnn, cfg, voc, vcfg, inp["mel_mb"], inp["bits_mb"], PPL.make_pp_mesh(devices)))
    out["pp"] = {"codes": codes_pp.cpu().numpy(), "wav": wav_pp.cpu().numpy(),
                 "launches": kernel_launches(), "ms": pp_ms}

    # the direct path (no kernel): SP exact and fast, the pipeline with
    # approx_snake
    tracing.reset()
    sp_d = {"parity": SPL.generator_apply_sp(voc, vcfg, mel, smesh, use_pallas=False),
            "fast": SPL.generator_apply_sp(voc, vcfg, mel, smesh, precision="default",
                                           compute_dtype=torch.bfloat16, approx_snake=True)}
    codes_d, wav_d = PPL.pipeline_resynth(bvrnn, cfg, voc, vcfg, inp["mel_mb"], inp["bits_mb"],
                                          PPL.make_pp_mesh(devices), approx_snake=True)
    out["direct"] = {"sp": {k: v.cpu().numpy() for k, v in sp_d.items()},
                     "pp_codes": codes_d.cpu().numpy(), "pp_wav": wav_d.cpu().numpy(),
                     "launches": kernel_launches()}

    # a data-parallel step of each trainer, at full width
    B = PAR_TRAIN_BATCH // n
    rows = slice(rank * B, (rank + 1) * B)
    tmel = torch.from_numpy(inp["train_mel"]).to(dev)
    dp = BT.BVRNNTrainer(conf, seed=SEED, mesh=mesh)
    dp_m, bv_ms = timed(lambda: dp.step(tmel[rows]))
    vtcfg, gen, ys = inp["gan"]
    gan = VT.VocoderGANTrainer(vcfg, vtcfg, seed=SEED, gen_params=gen, mesh=mesh)
    gan_m = [timed(lambda y=y: gan.step_on_audio(y[rows])) for y in ys]
    out["dp"] = {"bvrnn": {k: float(v) for k, v in dp_m.items()}, "bvrnn_ms": bv_ms,
                 "gan": [{k: float(v) for k, v in m.items()} for m, _ in gan_m],
                 "gan_ms": [t for _, t in gan_m]}
    if rank == 0:
        one = BT.BVRNNTrainer(conf, seed=SEED, device=dev)
        one_m = one.step(tmel)
        out["dp"]["bvrnn_gaps"] = dp_gaps(dp, one, dp_m, one_m, lambda t: t.leaves,
                                          lambda t: t.opt)
        ref = VT.VocoderGANTrainer(vcfg, vtcfg, seed=SEED, gen_params=gen, device=dev)
        ref_m = [ref.step_on_audio(y) for y in ys]
        gm = dict(gan_m[-1][0])
        out["dp"]["gan_gaps"] = {
            "d": dp_gaps(gan, ref, gm, ref_m[-1], lambda t: t._d.tensors, lambda t: t.opt_d),
            "g": dp_gaps(gan, ref, gm, ref_m[-1], lambda t: t._g.tensors, lambda t: t.opt_g),
            "metric_rel_step0": max(rel_gap(float(gan_m[0][0][k]), float(ref_m[0][k]))
                                    for k in ref_m[0])}
    return out


class ParallelCLI:
    """``cli.train_bvrnn`` as two processes of one data-parallel run on the
    card (gloo: the ranks share it), 2 steps at batch 4, output to log
    files; ``finish`` gates equal losses on both ranks and a checkpoint,
    written by rank 0, that loads."""

    def __init__(self, tmp: str):
        self.tmp, self.run = tmp, os.path.join(tmp, "bvrnn_dp")
        filelist = os.path.join(tmp, "dp_train.txt")  # the demo once a rank: its shard
        with open(filelist, "w") as f:
            f.write((os.path.splitext(os.path.basename(WAV))[0] + "|demo\n") * PAR_RANKS)
        common = ["--config", DEFAULT_CONFIG, "--input_wavs_dir", os.path.dirname(WAV),
                  "--input_training_file", filelist, "--checkpoint_path", self.run,
                  "--max_steps", "2", "--batch_size", str(PAR_TRAIN_BATCH),
                  "--stdout_interval", "1", "--stats_batches", "1", "--device", PAR_DEVICE,
                  "--dist_backend", "gloo", "--coordinator_address",
                  f"file://{os.path.join(tmp, 'cli_store')}", "--num_processes", str(PAR_RANKS)]
        self.t0, self.procs = time.time(), []
        for r in range(PAR_RANKS):
            log = open(os.path.join(tmp, f"rank{r}.log"), "w")
            self.procs.append((subprocess.Popen(
                [sys.executable, "-m", "bvsc_tpu_torch.cli.train_bvrnn", *common,
                 "--process_id", str(r)], cwd=REPO, stdout=log, stderr=subprocess.STDOUT), log))

    def finish(self, gates: list) -> dict:
        losses, rcs = [], []
        try:
            for proc, log in self.procs:
                proc.wait(timeout=PAR_TIMEOUT)
                rcs.append(proc.returncode)
        finally:
            self.close()
        tails = []
        for _, log in self.procs:
            text = open(log.name).read()
            lines = [ln for ln in text.splitlines() if ln.startswith("Steps : 2,")]
            losses.append(lines[-1].split(", s/b")[0] if lines else None)
            tails.append(text.strip().splitlines()[-3:])
        state, step = ckpt.restore_latest(self.run, "bvrnn_")
        loads = False
        if state is not None:
            tr = BT.BVRNNTrainer(load_config(DEFAULT_CONFIG), device=DEV)
            tr.load_state_dict(state)
            loads = tr.step_count == 2
        gates += [(f"trainer CLI ranks exit 0 ({rcs})", rcs == [0] * PAR_RANKS),
                  (f"trainer CLI losses equal on both ranks {losses}",
                   losses[0] is not None and len(set(losses)) == 1),
                  (f"rank 0's checkpoint (step {step}) loads", loads and step == 2)]
        return {"rcs": rcs, "losses": losses, "tails": tails, "checkpoint_step": step,
                "seconds": time.time() - self.t0}

    def close(self) -> None:
        for proc, log in self.procs:
            proc.kill()
            proc.wait()
            log.close()


def alternating(eng):
    """``eng`` with its free slots handed out alternately from the first and
    the second half, so that consecutive streams land in both blocks of a
    two-device mesh."""
    half = eng.B // 2
    eng._free = [s for pair in zip(range(half), range(half, eng.B)) for s in pair]
    return eng


def parallel_engines(codec: BVRNNCodecModel, wav: np.ndarray, codes: np.ndarray, bundle_path: str,
                     gates: list) -> dict:
    """The four engines at 128 slots with ``mesh`` over [card, card] (a
    block of 64 slots on each) against unsharded ones: 6 streams of the
    serving phase's schedule, cropped, through the serving engines; the
    main path's codes twice with ``plc``-style losses through the decode
    engines; the bundle ones on phase ``export``'s parity bundle.  Streams
    alternate between the blocks."""
    from bvsc_tpu_torch.parallel.mesh import make_mesh
    from bvsc_tpu_torch.serve.export import ServingBundle

    mesh = make_mesh(devices=[PAR_DEVICE] * PAR_RANKS)
    inputs = [x[:PAR_STREAM_SAMPLES] for x in serve_inputs(wav[0])[:PAR_STREAMS]]

    def serve(eng):
        tracing.reset()
        sids = []
        for i, x in enumerate(inputs):
            sids.append(eng.open_stream(SERVE_BITRATES[i % 3]))
            eng.push(sids[-1], x)
            eng.begin_flush(sids[-1])
        out, ticks = {sid: ([], []) for sid in sids}, 0
        while res := eng.tick():
            ticks += 1
            for sid, (c, w) in res.items():
                out[sid][0].append(c)
                out[sid][1].append(w)
        return ([(np.stack(out[s][0]), np.concatenate(out[s][1])) for s in sids],
                kernel_launches(), ticks)

    n = PAR_DECODE_FRAMES  # the batch's codes twice
    dcodes = np.concatenate([codes, codes])[:, :n]
    lost = loss_pattern(dcodes.shape[0], n)
    bundle = ServingBundle(bundle_path, DEV)
    ref, _, ticks = serve(alternating(ServingEngine(codec, SERVE_SLOTS)))
    dref, _, _ = decode_engine_run(codec, dcodes, lost,
                                   alternating(DecodeEngine(codec, SERVE_SLOTS)))
    rep = {"slots": bundle.meta["engine"]["slots"], "ticks": ticks}
    for name, make_s, make_d in (
            ("live", lambda: ServingEngine(codec, SERVE_SLOTS, mesh=mesh),
             lambda: DecodeEngine(codec, SERVE_SLOTS, mesh=mesh)),
            ("bundle", lambda: bundle.serving_engine(mesh=mesh),
             lambda: bundle.decode_engine(mesh=mesh))):
        got, launches, _ = serve(alternating(make_s()))
        dgot, _, dlaunches = decode_engine_run(codec, dcodes, lost, alternating(make_d()))
        codes_eq = all(np.array_equal(a[0], b[0]) for a, b in zip(got, ref))
        gap = max(float(np.abs(a[1] - b[1]).max()) for a, b in zip(got, ref))
        dgap = float(np.abs(dgot - dref).max())
        rep[name] = {"codes_bitwise": codes_eq, "audio_gap": gap, "decode_gap": dgap,
                     "launches": launches, "decode_launches": dlaunches}
        blocks = {"f32": 12 * PAR_RANKS, "bf16": 0}
        gates += [(f"sharded {name} serving codes bitwise unsharded", codes_eq),
                  (f"sharded {name} serving audio {gap} <= {STREAM_TOL}", gap <= STREAM_TOL),
                  (f"sharded {name} decode audio {dgap} <= {STREAM_TOL}", dgap <= STREAM_TOL),
                  (f"sharded {name} K1 launches {launches}, {dlaunches}: 12 a block a tick",
                   launches == {k: v * ticks for k, v in blocks.items()}
                   and dlaunches == {k: v * n for k, v in blocks.items()})]
    return rep


def parallel_phase(codec: BVRNNCodecModel, wav: np.ndarray, smi: str):
    """The parallel paths on the card, two ranks sharing it over gloo: see
    the module docstring.  A generator, so that the ranks and the trainer
    CLI's processes run beside phase ``train``: ``next()`` computes the
    one-device references and starts them (the ranks from a thread of this
    process) and returns; ``send(bundle)``, ``bundle`` phase ``export``'s
    parity bundle, waits for the ranks, runs the sharded engines, applies
    the gates and ends the generator.  The numbers are printed before any
    gate is applied; a rank that fails, or a collective that times out,
    raises."""
    from concurrent.futures import ThreadPoolExecutor

    from bvsc_tpu_torch.parallel.dryrun import run_ranks

    t0 = time.time()
    conf, gates = codec.conf, []
    report = {"nvidia_smi": smi, "ranks": f"{PAR_RANKS} ranks sharing one card over gloo; "
              "their times say nothing about scaling"}
    cfg = dataclasses.replace(codec.bvrnn_cfg, fused_cell=False)  # TP's cell, the standard one
    params = codec.weights.scan.std
    x = torch.from_numpy(wav).to(DEV)
    L = x.shape[1]
    Lp = codec._pad_length(L)
    with torch.no_grad():
        y = codec._mel(torch.nn.functional.pad(x, (0, Lp - L)))
        bits = codec._frame_bits(BITRATE, x.shape[0], L, Lp, codec.frontend.num_frames(L))
        h0 = codec._h0(x.shape[0])
        codes, h_seq = bvrnn_mod.encode(params, cfg, y, bits, h0)
        h_enc = bvrnn_mod.encode_with_state(params, cfg, y, bits, h0)[1]
        mel_ref, h_dec = bvrnn_mod.decode(params, cfg, codes, h0)
        k = PAR_TIMED_FRAMES  # warm calls, timed
        _, enc_ms = timed(lambda: bvrnn_mod.encode_with_state(params, cfg, y[:, :k], bits[:, :k],
                                                             h0))
        _, dec_ms = timed(lambda: bvrnn_mod.decode(params, cfg, codes[:, :k], h0))
        voc_in = mel_ref.transpose(1, 2).contiguous()
        vlen = voc_in.shape[-1] * conf.hopsize

        def vocode():
            return voc_mod.generator_apply_kernel(codec.vocoder_params, codec.kernel_blocks,
                                                  conf.vocoder_config, voc_in, vlen)

        wav_ref = vocode()
        _, voc_ms = timed(vocode)
        enc_p = bvrnn_mod.enc_apply(params, torch.cat([bvrnn_mod.phi_x_apply(
            params, bvrnn_mod._normalize(params, y)), h_seq], -1))
        mel_mb = torch.stack([y[:, i * PAR_MICRO_FRAMES:(i + 1) * PAR_MICRO_FRAMES]
                              for i in range(PAR_MICRO)])
        bits_mb = bits[None, :, :PAR_MICRO_FRAMES].expand(PAR_MICRO, -1, -1).contiguous()
        pp_codes, pp_wav, pp_direct = [], [], []
        for i in range(PAR_MICRO):
            z, m, _ = bvrnn_mod.encode_decode(params, cfg, mel_mb[i], bits_mb[i],
                                              codec._h0(x.shape[0]))
            pp_codes.append(z)
            pp_wav.append(voc_mod.generator_apply_kernel(
                codec.vocoder_params, codec.kernel_blocks, conf.vocoder_config,
                m.transpose(1, 2).contiguous(), PAR_MICRO_FRAMES * conf.hopsize))
            pp_direct.append(voc_mod.generator_apply(
                codec.vocoder_params, conf.vocoder_config, m.transpose(1, 2).contiguous(),
                PAR_MICRO_FRAMES * conf.hopsize, approx_snake=True))
        # the direct path's one-device generator, exact and fast
        direct_ref = {"parity": voc_mod.generator_apply(codec.vocoder_params,
                                                        conf.vocoder_config, voc_in, vlen),
                      "fast": voc_mod.generator_apply(
                          codec.vocoder_params, conf.vocoder_config, voc_in, vlen, "default",
                          torch.bfloat16, approx_snake=True)}
    seg = int(TRAIN_CHECK_SECONDS * conf.fs) // conf.hopsize * conf.hopsize
    train_mel = bvrnn_frontend(conf, DEV)(x[:PAR_TRAIN_BATCH, :seg]).transpose(1, 2)
    vcfg = conf.vocoder_config
    gtcfg = VT.GANTrainConfig(freeze_step=1, batch_size=PAR_TRAIN_BATCH, sampling_rate=conf.fs,
                              n_fft=conf.winsize, hop_size=conf.hopsize, win_size=conf.winsize,
                              fmin=conf.fmin, fmax=conf.fmax, mel_pad_left=conf.mel_pad_left)
    crops = [wav[:PAR_TRAIN_BATCH, o:o + gtcfg.segment_size] for o in (0, 12000)]
    inp = {"y": y.cpu().numpy(), "bits": bits.cpu().numpy(), "codes": codes.cpu().numpy(),
           "mel": voc_in.cpu().numpy(), "mel_mb": mel_mb.cpu().numpy(),
           "bits_mb": bits_mb.cpu().numpy(), "train_mel": train_mel.cpu().numpy(),
           "gan": (gtcfg, train_vocoder.load_generator(VOC_NPZ), crops)}
    # the trainer CLI as two processes, beside the ranks and the sharded
    # engines in here; the ranks wait in a thread
    tmp = tempfile.mkdtemp(prefix="bvsc-parallel-")
    cli = ParallelCLI(tmp)
    pool = ThreadPoolExecutor(1)

    def ranks_timed():
        t = time.time()
        out = run_ranks(PAR_RANKS, parallel_ranks, inp, device=PAR_DEVICE, backend="gloo",
                        timeout_s=PAR_TIMEOUT)
        return out, time.time() - t

    try:
        future = pool.submit(ranks_timed)
        report["start_seconds"] = time.time() - t0
        bundle = yield
        t1 = time.time()
        ranks, report["ranks_seconds"] = future.result()
        report["waited_for_ranks_s"] = time.time() - t1
        r0 = ranks[0]

        # tensor parallelism against one device
        tp = r0["tp"]
        flips = np.argwhere(tp["codes"] != codes.cpu().numpy())
        enc_np = enc_p.cpu().numpy()
        report["tp"] = {
            "frames": y.shape[1], "batch": y.shape[0], "flipped": len(flips),
            "flips": [{"stream": int(b), "frame": int(f), "bit": int(k),
                       "enc_minus_half": float(abs(enc_np[b, f, k] - 0.5))} for b, f, k in flips[:8]],
            "mel_gap": float(np.abs(tp["mel"] - mel_ref.cpu().numpy()).max()),
            "h_dec_gap": float(np.abs(tp["h_dec"] - h_dec.cpu().numpy()).max()),
            "h_enc_gap": float(np.abs(tp["h_enc"] - h_enc.cpu().numpy()).max()),
            "ranks_equal": all(np.array_equal(r["tp"]["mel"], tp["mel"]) for r in ranks),
            "timed_frames": PAR_TIMED_FRAMES,
            "decode_ms_per_frame": tp["decode_ms_per_frame"],
            "one_device_decode_ms_per_frame": dec_ms / PAR_TIMED_FRAMES,
            "encode_ms_per_frame": tp["encode_ms_per_frame"],
            "one_device_encode_ms_per_frame": enc_ms / PAR_TIMED_FRAMES}
        rt = report["tp"]
        gates += [(f"TP codes bitwise one device's ({rt['flipped']} flipped: {rt['flips']})",
                   rt["flipped"] == 0),
                  (f"TP mel {rt['mel_gap']} <= {TP_MEL_TOL}", rt["mel_gap"] <= TP_MEL_TOL),
                  (f"TP h {rt['h_dec_gap']} <= {TP_MEL_TOL}", rt["h_dec_gap"] <= TP_MEL_TOL),
                  ("TP outputs equal on every rank", rt["ranks_equal"])]

        # sequence parallelism against one-shot
        sp_gap = max(float(np.abs(r["sp"]["wav"] - wav_ref.cpu().numpy()).max()) for r in ranks)
        report["sp"] = {"frames": voc_in.shape[-1], "shards": PAR_RANKS, "gap": sp_gap,
                        "launches": [r["sp"]["launches"] for r in ranks], "ms": r0["sp"]["ms"],
                        "one_device_ms": voc_ms}
        gates += [(f"SP vocoder {sp_gap} <= {SP_TOL}", sp_gap <= SP_TOL),
                  (f"SP K1 launches {report['sp']['launches']}: 12 a shard",
                   all(r["sp"]["launches"] == {"f32": 12, "bf16": 0} for r in ranks))]

        # the pipeline against the unpipelined composition
        pp_ref_codes = torch.stack(pp_codes).cpu().numpy()
        pp_ref_wav = torch.stack(pp_wav).cpu().numpy()
        pp_gap = max(float(np.abs(r["pp"]["wav"] - pp_ref_wav).max()) for r in ranks)
        pp_eq = all(np.array_equal(r["pp"]["codes"], pp_ref_codes) for r in ranks)
        report["pp"] = {"micro": PAR_MICRO, "frames": PAR_MICRO_FRAMES, "codes_bitwise": pp_eq,
                        "wav_gap": pp_gap, "launches": [r["pp"]["launches"] for r in ranks],
                        "ms": r0["pp"]["ms"]}
        gates += [("PP codes bitwise the unpipelined run's", pp_eq),
                  (f"PP waveform {pp_gap} <= {PP_WAV_TOL}", pp_gap <= PP_WAV_TOL),
                  (f"PP K1 launches {report['pp']['launches']}: 12 a microbatch on stage 1",
                   [r["pp"]["launches"]["f32"] for r in ranks] == [0, 12 * PAR_MICRO])]

        # the direct path under SP and PP, against one device
        rd = report["direct"] = {
            "sp_gap": {k: max(float(np.abs(r["direct"]["sp"][k] - direct_ref[k].cpu().numpy())
                                    .max()) for r in ranks) for k in direct_ref},
            "pp_codes_bitwise": all(np.array_equal(r["direct"]["pp_codes"], pp_ref_codes)
                                    for r in ranks),
            "pp_wav_gap": max(float(np.abs(r["direct"]["pp_wav"] - torch.stack(pp_direct)
                                           .cpu().numpy()).max()) for r in ranks),
            "launches": [r["direct"]["launches"] for r in ranks]}
        gates += [(f"direct SP exact {rd['sp_gap']['parity']} <= {SP_TOL}",
                   rd["sp_gap"]["parity"] <= SP_TOL),
                  (f"direct SP fast {rd['sp_gap']['fast']} <= {FAST_WAVE_TOL}",
                   rd["sp_gap"]["fast"] <= FAST_WAVE_TOL),
                  ("direct PP codes bitwise the unpipelined run's", rd["pp_codes_bitwise"]),
                  (f"direct PP waveform {rd['pp_wav_gap']} <= {PP_WAV_TOL}",
                   rd["pp_wav_gap"] <= PP_WAV_TOL),
                  (f"direct SP and PP: 0 K1 launches {rd['launches']}",
                   all(n == {"f32": 0, "bf16": 0} for n in rd["launches"]))]

        # data-parallel steps against one rank's on the global batch
        dp = r0["dp"]
        report["dp"] = {"bvrnn": dp["bvrnn_gaps"], "gan": dp["gan_gaps"], "bvrnn_ms": dp["bvrnn_ms"],
                        "gan_ms": dp["gan_ms"], "batch": PAR_TRAIN_BATCH,
                        "ranks_equal": all(r["dp"]["bvrnn"] == dp["bvrnn"] and
                                           r["dp"]["gan"] == dp["gan"] for r in ranks)}
        bg, gg = dp["bvrnn_gaps"], dp["gan_gaps"]
        gates += [(f"DP BVRNN step metrics {bg['metric_rel']} <= {DP_TOL}",
                   bg["metric_rel"] <= DP_TOL),
                  (f"DP BVRNN step params {bg['param_abs']} <= {DP_TOL}", bg["param_abs"] <= DP_TOL),
                  (f"DP GAN metrics {gg['metric_rel_step0']}, {gg['d']['metric_rel']} <= {DP_TOL}",
                   max(gg["metric_rel_step0"], gg["d"]["metric_rel"]) <= DP_TOL),
                  (f"DP GAN params D {gg['d']['param_abs']}, G {gg['g']['param_abs']} <= {DP_TOL}",
                   max(gg["d"]["param_abs"], gg["g"]["param_abs"]) <= DP_TOL),
                  ("DP metrics equal on every rank", report["dp"]["ranks_equal"])]

        t = time.time()
        report["engines"] = parallel_engines(codec, wav, codes.cpu().numpy(), bundle, gates)
        report["engines"]["seconds"] = time.time() - t
        report["cli"] = cli.finish(gates)
    finally:
        cli.close()
        shutil.rmtree(tmp, ignore_errors=True)
        pool.shutdown(wait=False)
    set_parity_mode()
    failed = [what for what, ok in gates if not ok]
    report["finish_seconds"] = time.time() - t1
    emit("parallel", t0, **report, gates=len(gates), failed=failed)
    if failed:
        raise AssertionError(f"parallel: {len(failed)} gates failed: {failed}")


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


EVAL_BITRATES = ("1378", "5512")  # the paper's two operating points, bps
EVAL_LOSS_RATE = "0.1"
EVAL_METRIC_RTOL = 1e-5  # mel-L1 and MRSTFT on the card against the CPU, same waveforms
EVAL_MCD_TOL = 1e-2  # dB: MCD on the card's log-mel against the CPU's
EVAL_SYNTH_TOL = 1e-4  # synthesize's K1 waveform against the plain generator (its output scale)
EVAL_DAEMON_SLOTS = 8
EVAL_PROCESS_TIMEOUT = 300  # seconds a CLI process of the phase may take


def eval_layout(tmp: str) -> dict:
    """The demo utterance as a one-stimulus MUSHRA layout
    (``stimuli/stim_15/ref.wav``), its filelist, and a seeded vocoder as a
    second selection candidate."""
    stim = os.path.join(tmp, "stimuli", "stim_15")
    os.makedirs(stim)
    ref = os.path.join(stim, "ref.wav")
    with open(WAV, "rb") as src, open(ref, "wb") as dst:
        dst.write(src.read())
    filelist = os.path.join(tmp, "demo.txt")
    with open(filelist, "w") as f:
        f.write("ref\n")
    seeded = os.path.join(tmp, "seeded_vocoder.npz")
    np.savez(seeded, **flatten_tree(seeded_vocoder(load_config(DEFAULT_CONFIG).vocoder_config,
                                                   SEED)))
    return {"stimuli": os.path.dirname(stim), "stim": stim, "ref": ref, "filelist": filelist,
            "seeded": seeded}


def eval_process(tmp: str, name: str, *args: str) -> tuple[subprocess.Popen, str]:
    """``python -m bvsc_tpu_torch.cli.<name>`` on the card, its stderr (and,
    but for the daemon, its stdout) to a log file."""
    log = os.path.join(tmp, f"{name}.log")
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, "-m", f"bvsc_tpu_torch.cli.{name}", *args],
                                cwd=REPO, stdout=subprocess.PIPE if name == "serve_daemon" else f,
                                stderr=f, text=True)
    return proc, log


def serving_line(proc: subprocess.Popen, timeout: float) -> str:
    """The daemon CLI's first stdout line, or "" if it did not come in time."""
    import select

    ready, _, _ = select.select([proc.stdout], [], [], timeout)
    return proc.stdout.readline() if ready else ""


def eval_metrics_vs_cpu(captured: list, rows: list, gates: list) -> dict:
    """Each row's metrics, recomputed on the CPU from the waveforms
    ``evaluate_codec.score`` was given.  STOI and PESQ are host numpy on
    both sides, so their gaps are printed, not gated."""
    cpu = EM.frontend_for(load_config(DEFAULT_CONFIG), "cpu")
    worst = {"mel_l1": 0.0, "mrstft": 0.0, "mcd_db": 0.0, "stoi": 0.0, "pesq_wb": 0.0}
    for (x, y), row in zip(captured, rows):
        got = {"mel_l1": EM.mel_l1(cpu, x[None], y[None]), "mrstft": EM.mrstft(y[None], x[None]),
               "mcd_db": EM.mcd(cpu, x, y), "stoi": EM.stoi(x, y), "pesq_wb": EM.pesq_wb_16k(x, y)}
        for k in ("mel_l1", "mrstft"):
            worst[k] = max(worst[k], abs(row[k] - got[k]) / abs(got[k]))
        for k in ("mcd_db", "stoi", "pesq_wb"):
            worst[k] = max(worst[k], abs(row[k] - got[k]))
    gates += [(f"{k} card vs CPU relative {worst[k]} <= {EVAL_METRIC_RTOL}",
               worst[k] <= EVAL_METRIC_RTOL) for k in ("mel_l1", "mrstft")]
    gates += [(f"mcd_db card vs CPU {worst['mcd_db']} <= {EVAL_MCD_TOL} dB",
               worst["mcd_db"] <= EVAL_MCD_TOL),
              (f"{len(captured)} waveforms scored for {len(rows)} rows", len(captured) == len(rows))]
    return worst


def metric_host_ms(x: np.ndarray, y: np.ndarray) -> dict:
    """Host ms of one clip's STOI, PESQ-WB at 16 kHz and MCD (the card's
    frontend, the DCT on the host)."""
    card = EM.frontend_for(load_config(DEFAULT_CONFIG), DEV)
    out = {}
    for name, fn in (("stoi", lambda: EM.stoi(x, y)), ("pesq_wb_16k", lambda: EM.pesq_wb_16k(x, y)),
                     ("mcd", lambda: EM.mcd(card, x, y))):
        t = time.perf_counter()
        fn()
        out[name] = (time.perf_counter() - t) * 1e3
    return out


def eval_phase(codec: BVRNNCodecModel, wav: np.ndarray, smi: str) -> None:
    """The eval metrics and the synthesis, evaluation and daemon CLIs on the
    card, on the trained pair and the demo utterance; see the module
    docstring.  The numbers are printed before any gate is applied."""
    t0 = time.time()
    gates, report = [], {"nvidia_smi": smi}
    conf = codec.conf
    procs = []
    with tempfile.TemporaryDirectory(prefix="bvsc-eval-") as tmp:
        try:
            lay = eval_layout(tmp)
            daemon, daemon_log = eval_process(
                tmp, "serve_daemon", "--bvrnn", NPZ, "--vocoder", VOC_NPZ, "--port", "0",
                "--max_streams", str(EVAL_DAEMON_SLOTS))
            procs.append(daemon)
            daemon_t0 = time.time()

            # dump_finetune_mels: bitwise the in-process decode of the encode
            before = kernel_launches()
            dump_finetune_mels.main(["--bvrnn_checkpoint", NPZ, "--input_wavs_dir", lay["stim"],
                                     "--input_training_file", lay["filelist"], "--output_dir",
                                     os.path.join(tmp, "mels"), "--bitrate", str(BITRATE)])
            report["dump_launches"] = {k: v - before[k] for k, v in kernel_launches().items()}
            mel = np.load(os.path.join(tmp, "mels", "ref.npy"))
            x_raw = load_wav(WAV, conf.fs)[0]
            want = codec.decode_to_mel(codec.encode(x_raw, BITRATE)).cpu().numpy()
            report["dump_shape"] = list(mel.shape)
            gates.append(("dump_finetune_mels bitwise decode_to_mel(encode(x))",
                          mel.dtype == np.float32 and np.array_equal(mel, want)))

            trainer, trainer_log = eval_process(
                tmp, "train_vocoder", "--config", DEFAULT_CONFIG, "--input_wavs_dir", lay["stim"],
                "--input_training_file", lay["filelist"], "--input_validation_file",
                lay["filelist"], "--input_mels_dir", os.path.join(tmp, "mels"), "--fine_tuning",
                "--evaluate", "--init_generator", VOC_NPZ, "--checkpoint_path",
                os.path.join(tmp, "voc"))
            procs.append(trainer)

            # evaluate_codec in this process, the waveforms of each row kept
            captured, score = [], EVC.score

            def keep(frontend, x, y):
                captured.append((x.copy(), y.cpu().numpy()))
                return score(frontend, x, y)

            EVC.score = keep
            try:
                before = kernel_launches()
                t = time.time()
                ev = EVC.main(["--stimuli_dir", lay["stimuli"], "--bvrnn_checkpoint", NPZ,
                               "--vocoder_checkpoint", VOC_NPZ, "--bitrates", *EVAL_BITRATES,
                               "--loss_rate", EVAL_LOSS_RATE, "--entropy", "--out_json",
                               os.path.join(tmp, "eval.json")])
                report["evaluate_seconds"] = time.time() - t
            finally:
                EVC.score = score
            launched = {k: v - before[k] for k, v in kernel_launches().items()}
            vocodings = 2 * len(ev["rows"])  # a resynthesis and a concealed decode a row
            report["evaluate"] = {"summary": ev["summary"], "launches": launched,
                                  "vocoding_calls": vocodings}
            gates.append((f"evaluate_codec K1 launches {launched} == 12 x {vocodings}",
                          launched == {"f32": 12 * vocodings, "bf16": 0}))
            t = time.time()
            report["evaluate_vs_cpu"] = eval_metrics_vs_cpu(captured, ev["rows"], gates)
            report["evaluate_vs_cpu_seconds"] = time.time() - t
            report["metric_host_ms"] = metric_host_ms(*captured[0])

            # synthesize: wav -> mel -> wav and the dumped .npy -> wav, on K1
            report["synthesize"] = synthesize_checks(codec, lay, tmp, gates)

            # select_vocoder_ckpt: the trained vocoder before a seeded one
            before = kernel_launches()
            ranked = SEL.main(["--bvrnn_checkpoint", NPZ, "--candidates", lay["seeded"], VOC_NPZ,
                               "--stimuli", lay["ref"]])
            launched = {k: v - before[k] for k, v in kernel_launches().items()}
            report["select"] = {"ranked": [(l1, os.path.basename(p)) for l1, p in ranked],
                                "launches": launched}
            gates += [("select_vocoder_ckpt ranks the trained vocoder first",
                       ranked[0][1] == VOC_NPZ),
                      (f"select_vocoder_ckpt K1 launches {launched} == 12 x 2",
                       launched == {"f32": 24, "bf16": 0})]

            report["daemon"] = daemon_checks(codec, daemon, daemon_log, daemon_t0, wav[0], gates)
            report["train_vocoder"] = train_vocoder_eval(trainer, trainer_log, gates)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
                if proc.stdout is not None:
                    proc.stdout.close()
    set_parity_mode()
    failed = [what for what, ok in gates if not ok]
    emit("eval", t0, **report, gates=len(gates), failed=failed)
    if failed:
        raise AssertionError(f"eval: {len(failed)} gates failed: {failed}")


def synthesize_checks(codec: BVRNNCodecModel, lay: dict, tmp: str, gates: list) -> dict:
    """``synthesize.main`` in wav mode and in ``.npy`` mode on the dumped
    mel: 12 K1 launches a file, and each float waveform it writes against
    the plain generator on the same mel on the card."""
    vcfg = codec.conf.vocoder_config
    out = {}
    for mode, src, suffix in (("wavs", lay["stim"], "_generated.wav"),
                              ("mels", os.path.join(tmp, "mels"), "_generated_e2e.wav")):
        written, write = [], SY._write

        def keep(args, path, sfx, w, fs):
            written.append(w)
            return write(args, path, sfx, w, fs)

        SY._write = keep
        try:
            before = kernel_launches()
            paths = SY.main([f"--input_{mode}_dir", src, "--output_dir",
                             os.path.join(tmp, f"synth_{mode}"), "--checkpoint_file", VOC_NPZ,
                             "--config", DEFAULT_CONFIG])
            launched = {k: v - before[k] for k, v in kernel_launches().items()}
        finally:
            SY._write = write
        with torch.no_grad():
            if mode == "wavs":
                x = load_wav(lay["ref"], codec.conf.fs)[0]
                x = torch.as_tensor(peak_normalize(x) * 0.95, device=DEV)
                mel = codec.frontend(x[None] * SCALING)
                plain = voc_mod.generator_apply(codec.vocoder_params, vcfg, mel, x.shape[0])
                plain = plain[0, 0].cpu().numpy() / SCALING
                scale = SCALING
            else:
                mel = torch.as_tensor(np.load(os.path.join(src, "ref.npy"))[None], device=DEV)
                plain, scale = voc_mod.generator_apply(codec.vocoder_params, vcfg, mel)[0, 0], 1.0
                plain = plain.cpu().numpy()
        err = float(np.abs(written[0] - plain).max() * scale)
        out[mode] = {"files": [os.path.basename(p) for p in paths], "launches": launched,
                     "samples": int(written[0].shape[0]), "kernel_vs_plain": err}
        gates += [(f"synthesize {mode}: one file ending {suffix}",
                   len(paths) == 1 and paths[0].endswith(suffix)),
                  (f"synthesize {mode} K1 launches {launched} == 12", launched == {"f32": 12,
                                                                                   "bf16": 0}),
                  (f"synthesize {mode} kernel vs plain generator {err} <= {EVAL_SYNTH_TOL}",
                   err <= EVAL_SYNTH_TOL)]
    return out


def daemon_checks(codec: BVRNNCodecModel, proc: subprocess.Popen, log: str, t0: float,
                  speech: np.ndarray, gates: list) -> dict:
    """The daemon CLI's subprocess: its "serving on" line, one resynthesis
    client on the demo cut to whole hops (a stream's output ends with its
    last whole frame, as the one-shot frame count does), then SIGTERM, its
    exit code and its "served" line: a serving tick a frame, 12 K1-bf16
    launches a tick and no float32 one, counted in the daemon's process
    from its serving line on.  The audio is held against an
    ``EVAL_DAEMON_SLOTS``-slot engine of the fast codec in this process on
    the same input."""
    from bvsc_tpu_torch.serve.client import CodecClient

    hop = codec.conf.hopsize
    speech = speech[: speech.shape[0] // hop * hop]

    line = serving_line(proc, EVAL_PROCESS_TIMEOUT)
    out = {"line": line.strip(), "seconds_to_serving": time.time() - t0}
    if not line.startswith("BVSP/1 serving on "):
        gates.append((f"serve_daemon printed its serving line (log: "
                      f"{open(log).read()[-2000:]})", False))
        return out
    port = int(line.split()[3].rsplit(":", 1)[1])
    t = time.time()
    with CodecClient("127.0.0.1", port, mode="resynth", bitrate=BITRATE, timeout=120) as c:
        c.send_audio(speech)
        c.close_input()
        audio = c.drain()["audio"]
    out["resynth_seconds"] = time.time() - t
    out["resynth_samples"] = int(audio.shape[0])
    proc.send_signal(signal.SIGTERM)
    try:
        out["rc"] = proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        out["rc"] = None
    served = [ln for ln in proc.stdout.read().splitlines() if ln.startswith("BVSP/1 served ")]
    out["served"] = json.loads(served[0][len("BVSP/1 served "):]) if served else None
    frames = speech.shape[0] // hop
    want = {"ticks": {"serve": frames, "decode": 0},
            "k1_launches": {"float32": 0, "bf16": 12 * frames}}
    counts = {k: (out["served"] or {}).get(k) for k in want}

    fast = BVRNNCodecModel(config=codec.conf, bvrnn_params=codec.bvrnn_params,
                           vocoder_params=codec.vocoder_params, precision="default", device=DEV)
    _, ref = solo_serve(fast, speech, BITRATE, EVAL_DAEMON_SLOTS)
    out["tf32_here"] = {"matmul": torch.backends.cuda.matmul.allow_tf32,
                        "cudnn": torch.backends.cudnn.allow_tf32}
    out["unpinned_gaps"] = unpinned_gaps(fast, speech, ref)
    same = audio.shape == ref.shape
    out["gap_vs_engine"] = float(np.abs(audio - ref).max()) if same else None
    out["bitwise_vs_engine"] = same and bool(np.array_equal(audio, ref))
    gates += [(f"serve_daemon {EVAL_DAEMON_SLOTS} slots", f"({EVAL_DAEMON_SLOTS} stream slots"
               in line),
              (f"daemon resynthesis {audio.shape} of {speech.shape}, finite",
               audio.shape == speech.shape and bool(np.isfinite(audio).all())),
              (f"daemon audio bitwise the in-process fast engine's (gap {out['gap_vs_engine']})",
               out["bitwise_vs_engine"]),
              (f"serve_daemon exit code on SIGTERM {out['rc']} == 0", out["rc"] == 0),
              (f"serve_daemon served {counts} == {want}", counts == want)]
    return out


def unpinned_gaps(codec: BVRNNCodecModel, speech: np.ndarray, ref: np.ndarray) -> dict:
    """The daemon's in-process engine run again with ``ops.conv``'s per-call
    TF32 pin taken out and cuDNN's TF32 flag set each way: each run's
    largest gap from ``ref``, the pinned run (where a process's flag moves
    the fast audio, these differ)."""
    from bvsc_tpu_torch.ops import conv as conv_mod

    pin, flag = conv_mod._fp32, torch.backends.cudnn.allow_tf32
    gaps = {}
    try:
        conv_mod._fp32 = lambda x: contextlib.nullcontext()
        for on in (True, False):
            torch.backends.cudnn.allow_tf32 = on
            _, w = solo_serve(codec, speech, BITRATE, EVAL_DAEMON_SLOTS)
            gaps[f"cudnn_allow_tf32_{on}"] = (float(np.abs(w - ref).max())
                                              if w.shape == ref.shape else None)
    finally:
        conv_mod._fp32, torch.backends.cudnn.allow_tf32 = pin, flag
    return gaps


def train_vocoder_eval(proc: subprocess.Popen, log: str, gates: list) -> dict:
    """``cli.train_vocoder --fine_tuning --evaluate``: its validation line
    with finite STOI and PESQ."""
    try:
        rc = proc.wait(timeout=EVAL_PROCESS_TIMEOUT)
    except subprocess.TimeoutExpired:
        rc = None
    text = open(log).read()
    lines = [ln for ln in text.splitlines() if ln.startswith("validation @")]
    values = dict(re.findall(r"(\w+)=(-?[\d.]+|nan|inf)", lines[0])) if lines else {}
    out = {"rc": rc, "line": lines[0] if lines else text[-2000:]}
    gates.append((f"train_vocoder --fine_tuning --evaluate (rc {rc}) printed finite stoi and "
                  f"pesq", rc == 0 and all(k in values and np.isfinite(float(values[k]))
                                           for k in ("stoi", "pesq"))))
    return out


def probes_phase() -> list[dict]:
    """Both probes through their entry points, with the three kernels'
    launch counts read around them; then each kernel against its plain
    version on the probes' inputs, timed beside its bound.  Returns the
    kernels' entries of the kernels line."""
    t0 = time.time()
    tracing.reset()
    gru_ms = probe_gru.run()
    roof = probe_roof.run()
    launches = kernel_launches("persistent_gru", "dot_chain", "gridded_dot")
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
    name, clock_mhz, smi = device_phase()
    snake = build_phase(clock_mhz)
    set_parity_mode()
    torch.matmul(torch.ones(8, 8, device=DEV), torch.ones(8, 8, device=DEV))  # cuBLAS set-up
    wav = load_batch()

    t0 = time.time()
    conf = load_config(DEFAULT_CONFIG)
    codec = BVRNNCodecModel(config=conf, bvrnn_chkpt_path=NPZ, vocoder_chkpt_path=VOC_NPZ,
                            device=DEV)
    fast = BVRNNCodecModel(config=conf, bvrnn_params=codec.bvrnn_params,
                           vocoder_params=codec.vocoder_params, precision="default", device=DEV)
    seeded = BVRNNCodecModel(config=conf, bvrnn_params=codec.bvrnn_params,
                             vocoder_params=seeded_vocoder(conf.vocoder_config, SEED), device=DEV)
    emit("model", t0, h_dim=codec.conf.h_dim, z_dim=codec.conf.z_dim,
         vocoder_channels=codec.conf.vocoder_config.upsample_initial_channel,
         bvrnn=os.path.relpath(NPZ, REPO), vocoder=os.path.relpath(VOC_NPZ, REPO))

    launches, shapes, parity_times, parity_out = main_path_phase(codec, wav)
    upstream_ckpt_phase(codec, fast, wav, parity_out, smi)
    launches_bf16, shapes_bf16 = fast_path_phase(seeded, wav, parity_times, (codec, fast))
    totals = kernel_phase(codec, shapes)
    totals_bf16 = kernel_phase(codec, shapes_bf16, torch.bfloat16, snake)
    for kernel, tot in (("amp_resblock", totals), ("amp_resblock_bf16", totals_bf16)):
        emit("kernel_total", time.time(), kernel=kernel,
             **{key: v for key, v in tot.items() if key != "bound_by"})
    antialias = antialias_phase(smi, codec, wav)
    plc_phase(codec, fast, wav, smi)
    golden_phase(codec, wav[0], smi)
    bf16 = bf16_storage_phase(codec, wav, smi)
    streaming_phase(codec, fast, wav, smi)
    exports = ExportCLIs(conf)  # beside phases serving, direct_path and entropy
    try:
        serving_phase(codec, fast, wav, smi)
        direct_path_phase(codec, fast, wav, smi)
        entropy_phase(codec, wav[0], smi)
        with tempfile.TemporaryDirectory(prefix="bvsc-bundle-") as keep:
            bundle = export_phase(codec, fast, wav, smi, keep, exports)
            par = parallel_phase(codec, wav, smi)
            next(par)  # its ranks and trainer CLI run beside phase train
            try:
                train_phase(wav, smi)
                with contextlib.suppress(StopIteration):
                    par.send(bundle)
            finally:
                par.close()
    finally:
        exports.close()
    eval_phase(codec, wav, smi)
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
        k1_entry("amp_resblock_io_bf16", "bvsc_tpu_torch/csrc/amp_resblock.cu",
                 "bvsc_tpu/ops/pallas_voc.py:240 (bf16 x, out_dtype=x.dtype)",
                 bf16["launches"]["highest"], bf16["entries"]["highest"]),
        k1_entry("amp_resblock_bf16_io_bf16", "bvsc_tpu_torch/csrc/amp_resblock_bf16.cu",
                 "bvsc_tpu/ops/pallas_voc.py:240 (compute_dtype=bfloat16, bf16 x, "
                 "out_dtype=x.dtype)", bf16["launches"]["default"], bf16["entries"]["default"]),
        antialias, *probe_entries]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
