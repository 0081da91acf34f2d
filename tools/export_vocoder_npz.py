#!/usr/bin/env python3
"""Write a vocoder checkpoint as a flat float16 ``.npz`` that numpy alone
can read.

    python tools/export_vocoder_npz.py [CHECKPOINT_DIR] [OUT.npz]

The shipped vocoder, ``chkpts/bvsc_vocoder_demo_cl_ft_g_step600``, is an
Orbax directory; reading it needs JAX, orbax and tensorstore.  This script
loads it with ``bvsc_tpu.codec._load_vocoder_checkpoint`` (which folds the
weight norm), flattens the tree under ``/``-joined key paths (list indices
as digits, the scheme of the BVRNN ``.npz`` files and of
``bvsc_tpu.codec._unflatten_npz``) and writes the leaves in float16 with
``np.savez_compressed``.  ``bvsc_tpu_torch.convert.load_vocoder_npz`` reads
the result back to float32 tensors, and the JAX package loads it as a tree
with ``_unflatten_npz``.

The output goes to ``chkpts_npz/`` by default, not ``chkpts/``: the JAX
package's ``tests/test_artifacts.py`` loads every ``.npz`` in ``chkpts/``
as a BVRNN checkpoint and every directory there as an Orbax vocoder.  It imports JAX, so it lives outside ``bvsc_tpu_torch`` and
runs where the JAX package runs.  It prints the leaf and parameter counts, the largest
float16 rounding error and the file's size.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CKPT = os.path.join(REPO, "chkpts", "bvsc_vocoder_demo_cl_ft_g_step600")
DEFAULT_CONFIG = os.path.join(REPO, "configs", "varbitrate.toml")
OUT_DIR = os.path.join(REPO, "chkpts_npz")


def flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts and lists -> {``a/0/b``: array}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out: dict[str, np.ndarray] = {}
    for key, value in items:
        out.update(flatten(value, f"{prefix}/{key}" if prefix else str(key)))
    return out


def load_checkpoint(path: str, config_path: str = DEFAULT_CONFIG) -> dict[str, np.ndarray]:
    """The checkpoint's weight-norm-folded generator tree, flattened, as
    float32 numpy arrays."""
    sys.path.insert(0, REPO)
    import jax
    import jax.numpy as jnp

    from bvsc_tpu.codec import _load_vocoder_checkpoint
    from bvsc_tpu.config import load_config

    conf = load_config(config_path)
    tree = _load_vocoder_checkpoint(path, conf.vocoder_config, jnp.float32)
    return {k: np.asarray(v, np.float32) for k, v in flatten(jax.tree.map(np.asarray, tree)).items()}


def export(checkpoint: str, out: str, config_path: str = DEFAULT_CONFIG) -> dict:
    """Write ``checkpoint`` to ``out`` in float16; returns the leaf and
    parameter counts, the largest rounding error and the file's bytes."""
    flat = load_checkpoint(checkpoint, config_path)
    half = {k: v.astype(np.float16) for k, v in flat.items()}
    np.savez_compressed(out, **half)
    return {"leaves": len(flat), "parameters": sum(v.size for v in flat.values()),
            "max_rounding": max(float(np.abs(half[k].astype(np.float32) - v).max())
                                for k, v in flat.items()),
            "bytes": os.path.getsize(out)}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("checkpoint", nargs="?", default=DEFAULT_CKPT)
    parser.add_argument("out", nargs="?", default=None,
                        help="default: chkpts_npz/<checkpoint's name>_f16.npz")
    parser.add_argument("--config", default=DEFAULT_CONFIG)
    args = parser.parse_args()
    out = args.out or os.path.join(
        OUT_DIR, os.path.basename(args.checkpoint.rstrip("/")) + "_f16.npz")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    stats = export(args.checkpoint, out, args.config)
    print(f"{out}: {stats['leaves']} leaves, {stats['parameters']} parameters, "
          f"float16 rounding <= {stats['max_rounding']:.3g}, {stats['bytes']} bytes")


if __name__ == "__main__":
    main()
