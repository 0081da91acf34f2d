"""Serve the codec over TCP (BVSP/1): the serving daemon's CLI (port of
``scripts/serve_daemon.py``).

Runs :class:`bvsc_tpu_torch.serve.daemon.CodecDaemon`: every connection is
one stream (encode, decode or resynthesis), and all connected streams
advance together in one batched tick per 11.6 ms frame::

    python -m bvsc_tpu_torch.cli.serve_daemon --config configs/varbitrate.toml \\
        --bvrnn chkpts/bvsc_bvrnn_demo_augfull_step1800_f16.npz \\
        --vocoder chkpts_npz/bvsc_vocoder_demo_cl_ft_g_step600_f16.npz \\
        --port 9630 --max_streams 128 [--bundle X.bvscx] [--device cpu]

It serves a live ``BVRNNCodecModel`` (fast serving, K1-bf16, by default;
``--precision highest`` for parity and K1 float32) or a ``.bvscx`` bundle
(``cli.export_cli --engine_batch N``), on the first CUDA card unless
``--device cpu``.  Once the engines are built and have run their first tick
it prints ``BVSP/1 serving on host:port (...)``; SIGTERM closes the daemon,
prints what it served since that line as ``BVSP/1 served {...}`` (one JSON
object, from one ``utils.tracing.snapshot()``: the ticks of each engine that
advanced a stream (or failed), its tick span's count, the K1 kernels' launches, ``float32`` and ``bf16``, which
stay 0 on the CPU and on the direct path, and the process's TF32 flags,
``matmul`` and ``cudnn``, which the codec's convolutions do not depend on:
``ops.conv`` pins cuDNN's TF32 off for each float32 call) and exits 0.  Clients: ``bvsc_tpu_torch.serve.client.CodecClient``.
"""

from __future__ import annotations

import argparse
import json
import signal
import threading

import torch

from bvsc_tpu_torch.cli import BVRNN_HELP, VOCODER_HELP


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m bvsc_tpu_torch.cli.serve_daemon",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default=None,
                   help="codec TOML; configs/varbitrate.toml when omitted")
    p.add_argument("--bvrnn", default=None, help=BVRNN_HELP + " (random weights without)")
    p.add_argument("--vocoder", default=None,
                   help=VOCODER_HELP)
    p.add_argument("--bundle", default=None,
                   help="serve from a .bvscx bundle exported with --engine_batch (no model code "
                        "or checkpoints needed; overrides --config/--bvrnn/--vocoder)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=9630,
                   help="TCP port (0 = ephemeral, printed at startup)")
    p.add_argument("--max_streams", type=int, default=None,
                   help="stream slots per engine (the fixed device batch; default 128, or the "
                        "bundle's exported slot count)")
    p.add_argument("--precision", default="default", choices=["default", "highest"],
                   help="'default' = bf16 fast serving (K1-bf16), 'highest' = reference-parity "
                        "float32")
    p.add_argument("--quantize", default=None, choices=[None, "int8", "int8_mixed"],
                   help="weight-only int8 BVRNN scans")
    p.add_argument("--send_queue_bytes", type=int, default=32 << 20,
                   help="per-connection outbound queue bound; a client reading slower than its "
                        "stream produces is evicted when it overflows")
    p.add_argument("--max_buffered_seconds", type=float, default=600.0,
                   help="per-stream unprocessed-input bound (audio seconds); input beyond it is "
                        "a protocol error")
    p.add_argument("--sndbuf", type=int, default=None,
                   help="optional SO_SNDBUF cap per connection (bounds kernel send-buffer memory)")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default: the first card) or 'cpu'")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    # Service managers stop with SIGTERM.  The handler goes in before the
    # model is built, so a stop during start-up does not fall on the
    # die-at-once disposition: it only sets a flag, which the serve loop
    # reads; a SIGTERM during start-up exits cleanly right after it.
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda signum, frame: stop.set())

    from bvsc_tpu_torch.serve.daemon import CodecDaemon
    from bvsc_tpu_torch.utils import tracing

    if args.bundle:
        from bvsc_tpu_torch.serve.export import ServingBundle

        codec = ServingBundle(args.bundle, device=args.device)
    else:
        from bvsc_tpu_torch.codec import DEFAULT_CONFIG, BVRNNCodecModel

        codec = BVRNNCodecModel(args.config or DEFAULT_CONFIG, bvrnn_chkpt_path=args.bvrnn,
                                vocoder_chkpt_path=args.vocoder, precision=args.precision,
                                quantize=args.quantize, device=args.device)
    daemon = CodecDaemon(codec, host=args.host, port=args.port, max_streams=args.max_streams,
                         send_queue_bytes=args.send_queue_bytes,
                         max_buffered_seconds=args.max_buffered_seconds, sndbuf=args.sndbuf)
    # count from here: the engines' first ticks ran in the constructor
    tracing.reset()
    try:
        daemon.start()
        print(f"BVSP/1 serving on {args.host}:{daemon.port} ({daemon._eng.B} stream slots"
              f"{', AOT bundle' if args.bundle else ''})", flush=True)
        while not stop.wait(1.0):
            pass
    except KeyboardInterrupt:
        pass
    finally:
        daemon.close()
    snap = tracing.snapshot()
    spans, counters = snap["spans"], snap["counters"]
    print("BVSP/1 served " + json.dumps({
        "ticks": {kind: spans.get(f"{kind}.tick", {"count": 0})["count"]
                  for kind in ("serve", "decode")},
        "k1_launches": {"float32": counters["amp_resblock.launches"],
                        "bf16": counters["amp_resblock.launches_bf16"]},
        "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                 "cudnn": torch.backends.cudnn.allow_tf32}}), flush=True)


if __name__ == "__main__":
    main()
