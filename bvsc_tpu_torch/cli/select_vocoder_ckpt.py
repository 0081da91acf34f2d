"""Vocoder checkpoint selection on held-out end-to-end quality (port of
``scripts/select_vocoder_ckpt.py``).

Runs the full codec chain (wav -> mel -> BVRNN at ``--bitrate`` -> the
candidate vocoder) on held-out speech for each candidate generator and
ranks them by the mel-L1 between input and resynthesised audio, the metric
the fine-tuning lineage optimises (the vocoder must excel on BVRNN-decoded
mels, reference ``meldataset.py:197-214``)::

    python -m bvsc_tpu_torch.cli.select_vocoder_ckpt \\
        --bvrnn_checkpoint chkpts/bvsc_bvrnn_demo_augfull_step1800_f16.npz \\
        --candidates 'exp/voc_ft/g_????????' chkpts_npz/bvsc_vocoder_demo_cl_ft_g_step600_f16.npz \\
        --stimuli held_out.wav [--device cpu]

A candidate is a vocoder ``.npz``, a port trainer's ``g_`` / ``do_``
checkpoint or an upstream BigVGAN ``g_`` file (a glob expands to its
matches); the BVRNN checkpoint is any file the codec reads (a flat ``.npz``,
a port ``bvrnn_`` file, an upstream ``{'vrnn': ...}`` ``.pt``).  The codec runs at parity on
the first CUDA card, its vocoder through the K1 kernels, unless ``--device
cpu``.  ``main`` returns [(mel-L1, path)] best first.
"""

from __future__ import annotations

import argparse
import glob

import numpy as np
import torch

from bvsc_tpu_torch.cli.evaluate_codec import load_22k
from bvsc_tpu_torch.cli.synthesize import load_vocoder
from bvsc_tpu_torch.cli import BVRNN_HELP, VOCODER_HELP
from bvsc_tpu_torch.codec import DEFAULT_CONFIG, BVRNNCodecModel, host_bvrnn_params
from bvsc_tpu_torch.config import load_config
from bvsc_tpu_torch.device import resolve_device
from bvsc_tpu_torch.eval.metrics import frontend_for


def main(argv=None) -> list[tuple[float, str]]:
    p = argparse.ArgumentParser(prog="python -m bvsc_tpu_torch.cli.select_vocoder_ckpt",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default=DEFAULT_CONFIG)
    p.add_argument("--bvrnn_checkpoint", required=True, help=BVRNN_HELP)
    p.add_argument("--candidates", nargs="+", required=True,
                   help="generator checkpoint paths or globs: " + VOCODER_HELP)
    p.add_argument("--stimuli", nargs="+", required=True,
                   help="held-out wavs (the demo's: the MUSHRA dataset's audio/stim_15/ref.wav)")
    p.add_argument("--bitrate", type=float, default=3000.0)
    p.add_argument("--device", default=None,
                   help="'cuda' (the default: the first card) or 'cpu'")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    conf = load_config(args.config)
    bvrnn_params = host_bvrnn_params(conf, args.bvrnn_checkpoint)
    mf = frontend_for(conf, device)
    stims = [load_22k(s) for s in args.stimuli]
    with torch.no_grad():
        mels_in = [mf(torch.as_tensor(s[None, :], device=device)) for s in stims]

    cands = []
    for c in args.candidates:
        hits = sorted(glob.glob(c))
        cands.extend(hits if hits else [c])

    results = []
    for path in cands:
        codec = BVRNNCodecModel(config=conf, bvrnn_params=bvrnn_params,
                                vocoder_params=load_vocoder(path, conf.vocoder_config), device=device)
        l1s = []
        for s, m_in in zip(stims, mels_in):
            out = codec(s[None, :], args.bitrate)
            with torch.no_grad():
                m_out = mf(out[:, : s.shape[0]])
            T = min(m_in.shape[-1], m_out.shape[-1])
            l1s.append(float((m_in[..., :T] - m_out[..., :T]).abs().mean()))
        l1 = float(np.mean(l1s))
        results.append((l1, path))
        print(f"{path:55s} e2e mel-L1 = {l1:.4f}", flush=True)

    results.sort()
    print(f"\nBEST: {results[0][1]}  (e2e mel-L1 {results[0][0]:.4f})")
    return results


if __name__ == "__main__":
    main()
