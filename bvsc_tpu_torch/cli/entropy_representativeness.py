"""How much does the BVSP entropy wire compress on codes that are not
collapsed?  (Port of ``scripts/entropy_representativeness.py``.)

The demo checkpoints' masked KL collapsed on their 41-s corpus, so most of
their bit positions are nearly constant and their wire savings are an
optimistic bound.  This measures the wire coder
(``serve/entropy_wire.py:AdaptiveCodesCoder``, the per-message rANS framing
both clients use, ``--block``-frame messages) on the same speech for each
BVRNN checkpoint given (the optimistic bound) and for a random-init model of
the config (healthy code entropy: an untrained encoder emits near-maximum
entropy bits, the conservative bound), checking that every block decodes
back::

    python -m bvsc_tpu_torch.cli.entropy_representativeness --wavs data_local/wavs \\
        [--checkpoints A.npz,B.npz] [--out entropy_wire_stats.json] [--device cpu]

Writes payload bits a frame and the reduction per bitrate per source to
``--out``.  The BVRNN encodes on the first CUDA card unless ``--device
cpu``; the wire coder runs on the host.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

from bvsc_tpu_torch.codec import DEFAULT_CONFIG, BVRNNCodecModel
from bvsc_tpu_torch.config import load_config
from bvsc_tpu_torch.data.audio import load_wav
from bvsc_tpu_torch.serve.entropy_wire import AdaptiveCodesCoder

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BITRATES = (1380.0, 3000.0, 5500.0)  # bps measured: the low, middle and high operating points


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m bvsc_tpu_torch.cli.entropy_representativeness",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default=DEFAULT_CONFIG)
    p.add_argument("--wavs", default=os.path.join(REPO, "data_local/wavs"),
                   help="directory of wavs at the config's rate (cli.prepare_demo_data)")
    p.add_argument("--checkpoints", default=",".join((
        os.path.join(REPO, "chkpts/bvsc_bvrnn_demo_step3000_f16.npz"),
        os.path.join(REPO, "chkpts/bvsc_bvrnn_demo_cl_step1300_f16.npz"))),
        help="comma-separated BVRNN .npz checkpoints to measure (missing ones are skipped)")
    p.add_argument("--stimuli", type=int, default=4,
                   help="number of stimuli to code (entropy stats converge fast; 4 x ~2.5 s)")
    p.add_argument("--block", type=int, default=8,
                   help="frames per entropy message (the daemon's default)")
    p.add_argument("--out", default="entropy_wire_stats.json", help="the report's JSON path")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default: the first card) or 'cpu'")
    return p.parse_args(argv)


def measure_source(codec: BVRNNCodecModel, wavs: list[str], bitrates, block: int) -> dict:
    """Payload bits a frame of the wire coder on ``codec``'s codes, per
    bitrate; the counts persist over the stimuli as in one stream."""
    conf = codec.conf
    out = {}
    for bps in bitrates:
        k = int(codec.bits_per_frame(bps))
        payload_bits = frames = 0
        coder, dec = AdaptiveCodesCoder(conf.z_dim), AdaptiveCodesCoder(conf.z_dim)
        for path in wavs:
            x = np.asarray(load_wav(path, conf.fs)[0], np.float32)[None, :]
            codes = codec.encode(x, bps)[0].cpu().numpy()  # (T, z)
            for t0 in range(0, codes.shape[0] - block + 1, block):
                blk = codes[t0 : t0 + block]
                payload = coder.encode_block(blk, k)
                back = dec.decode_block(payload, block, k)
                if not np.array_equal(back[:, :k], blk[:, :k]):
                    raise AssertionError("wire round trip broke")
                payload_bits += 8 * len(payload)
                frames += block
        got = payload_bits / max(frames, 1)
        out[str(int(bps))] = {"raw_bits_per_frame": float(k),
                              "payload_bits_per_frame": round(got, 3),
                              "reduction_pct": round(100.0 * (1.0 - got / k), 2),
                              "frames": frames}
    return out


def main(argv=None) -> dict:
    args = parse_args(argv)
    conf = load_config(args.config)
    wavs = sorted(glob.glob(os.path.join(args.wavs, "*.wav")))[: args.stimuli]
    if not wavs:
        raise SystemExit(f"no wavs under {args.wavs}")
    report = {"block_frames": args.block, "bitrates_bps": list(BITRATES),
              "stimuli": [os.path.basename(w) for w in wavs], "sources": {}}
    for ck in filter(None, args.checkpoints.split(",")):
        if not os.path.exists(ck):
            continue
        codec = BVRNNCodecModel(config=conf, bvrnn_chkpt_path=ck, device=args.device)
        report["sources"][os.path.splitext(os.path.basename(ck))[0]] = measure_source(
            codec, wavs, BITRATES, args.block)
    codec = BVRNNCodecModel(config=conf, seed=0, device=args.device)
    report["sources"]["random_init_fullsize"] = measure_source(codec, wavs, BITRATES, args.block)

    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
    for src, rows in report["sources"].items():
        for bps, r in sorted(rows.items(), key=lambda kv: float(kv[0])):
            print(f"{src} @{bps} bps: {r['raw_bits_per_frame']:.0f} -> "
                  f"{r['payload_bits_per_frame']:.2f} bits/frame "
                  f"({r['reduction_pct']:.1f}% reduction, n={r['frames']})")
    print("->", args.out)
    return report


if __name__ == "__main__":
    main()
