"""Export a BVRNN checkpoint to the flat ``.npz`` demo format (the port's
``scripts/export_bvrnn_npz.py``).

    python -m bvsc_tpu_torch.cli.export_bvrnn_npz exp/run/best/bvrnn_00001000 out.npz
    python -m bvsc_tpu_torch.cli.export_bvrnn_npz upstream_bvrnn.pt out.npz

The source is any file the codec reads (``codec.load_bvrnn_checkpoint``): a
port trainer's ``bvrnn_`` file, the reference's ``{'vrnn': state_dict}``
``.pt`` file, or a flat ``.npz``.  The ``.npz`` holds every leaf of the
parameter tree in float16 under its flat ``a/0/b`` name, the layout of
``chkpts/*.npz``: ``convert.load_bvrnn_npz`` and
``BVRNNCodecModel(bvrnn_chkpt_path=)`` (this package's and ``bvsc_tpu``'s)
load it.  Runs on the host; no device is needed.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from bvsc_tpu_torch.codec import load_bvrnn_checkpoint
from bvsc_tpu_torch.convert import flatten_tree


def export(src: str, dst: str) -> dict:
    """Write ``dst`` from the checkpoint file ``src``; returns the float16
    arrays by name."""
    params = load_bvrnn_checkpoint(src)
    flat = {k: v.numpy().astype(np.float16) for k, v in flatten_tree(params).items()}
    np.savez_compressed(dst, **flat)
    return flat


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        raise SystemExit(__doc__)
    src, dst = argv
    flat = export(src, dst)
    n = sum(v.size for v in flat.values())
    print(f"{dst}: {len(flat)} arrays, {n / 1e6:.2f} M params, "
          f"{os.path.getsize(dst) / 1e6:.1f} MB (f16)")


if __name__ == "__main__":
    main()
