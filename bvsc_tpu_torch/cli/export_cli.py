"""Export a codec to an AOT serving bundle (``.bvscx``).

Port of ``scripts/export_serving.py``::

    python -m bvsc_tpu_torch.cli.export_cli --out demo.bvscx --batch 1 --seconds 1 4 \\
        [--engine_batch 128] [--no_packet] [--quantize int8] [--precision default]

The bundle holds ``torch.export`` programs and the weights; a serving host
reloads it with ``bvsc_tpu_torch.serve.ServingBundle`` and runs no model
code (``bvsc_tpu_torch/serve/export.py``).  By default the codec is the
trained pair shipped in the tree (``chkpts/`` and ``chkpts_npz/``), traced
on the first CUDA card; ``--device cpu`` traces on the CPU (a bundle moves
to the serving device when it loads).  Prints one JSON line: the bundle's
size, buckets, and each program's export seconds and bytes.
"""

from __future__ import annotations

import argparse
import json
import os

from bvsc_tpu_torch.cli import BVRNN_HELP, VOCODER_HELP

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BVRNN_NPZ = os.path.join(_REPO, "chkpts", "bvsc_bvrnn_demo_augfull_step1800_f16.npz")
VOCODER_NPZ = os.path.join(_REPO, "chkpts_npz", "bvsc_vocoder_demo_cl_ft_g_step600_f16.npz")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m bvsc_tpu_torch.cli.export_cli",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default=None, help="codec TOML (default: configs/varbitrate.toml)")
    p.add_argument("--bvrnn", default=BVRNN_NPZ, help=BVRNN_HELP)
    p.add_argument("--vocoder", default=VOCODER_NPZ,
                   help=VOCODER_HELP)
    p.add_argument("--out", required=True, help="output .bvscx path")
    p.add_argument("--batch", default="1",
                   help="request batch size, or 'any' for a symbolic batch (one program per "
                        "bucket serves every batch size; parity only: fast serving picks its "
                        "cell by batch size)")
    p.add_argument("--seconds", type=float, nargs="*", default=[4.0],
                   help="length buckets to export, in seconds of audio (none: no one-shot "
                        "programs)")
    p.add_argument("--no_packet", action="store_true", help="skip the real-time packet programs")
    p.add_argument("--engine_batch", type=int, default=None,
                   help="also export the serving engines' ticks at N stream slots "
                        "(ServingBundle.serving_engine() / decode_engine(), the daemon)")
    p.add_argument("--quantize", default=None, choices=["int8", "int8_mixed"])
    p.add_argument("--precision", default="highest", choices=["highest", "default"],
                   help="'highest' (parity) or 'default' (fast serving)")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default: the first card) or 'cpu': where to trace")
    args = p.parse_args(argv)

    from bvsc_tpu_torch.codec import DEFAULT_CONFIG, BVRNNCodecModel
    from bvsc_tpu_torch.serve.export import export_serving_bundle

    codec = BVRNNCodecModel(args.config or DEFAULT_CONFIG, bvrnn_chkpt_path=args.bvrnn,
                            vocoder_chkpt_path=args.vocoder, quantize=args.quantize,
                            precision=args.precision, device=args.device)
    manifest = export_serving_bundle(
        codec, args.out, batch=None if args.batch == "any" else int(args.batch),
        lengths=tuple(int(s * codec.conf.fs) for s in args.seconds),
        packet=not args.no_packet, engine_batch=args.engine_batch)
    summary = {"out": args.out, "bytes": os.path.getsize(args.out), "batch": manifest["batch"],
               "buckets": [b["length"] for b in manifest["buckets"]],
               "traced_on": manifest["traced_on"], "serving": manifest["serving"],
               "packet": manifest["packet"] is not None,
               "engine_batch": (manifest["engine"] or {}).get("batch"),
               "export_seconds": manifest["export_seconds"],
               "program_bytes": manifest["program_bytes"]}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
