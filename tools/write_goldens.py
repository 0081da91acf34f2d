#!/usr/bin/env python3
"""Write golden outputs of the JAX package for the demo utterance.

    python tools/write_goldens.py [OUT.npz]

Runs ``bvsc_tpu`` at reference parity (float32, ``precision='highest'``) on
``docs/artifacts/demo_stim15_3kbps.wav`` at batch 1 and 3 kbps with the
trained pair: the BVRNN ``chkpts/bvsc_bvrnn_demo_augfull_step1800_f16.npz``
and the vocoder ``chkpts_npz/bvsc_vocoder_demo_cl_ft_g_step600_f16.npz``,
the float16 file the port reads too.  It writes, with
``np.savez_compressed``:

* ``codes``: ``encode``'s codes (frames, z_dim) as uint8 2 * code, so
  {0, 1, 2} for {0, 0.5, 1};
* ``mel``: ``decode_to_mel`` of those codes, (num_mels, frames) float32;
* ``wav``: ``decode`` of those codes at the input's length, float32;
* ``bitrate`` (bps) and ``length`` (samples).

By default into ``chkpts_npz/golden_demo_stim15_3kbps.npz``, where
``chip_smoke.py`` (phase ``golden``) reads it with numpy and holds the
port's output on the card against it.  It imports JAX, so it lives outside
``bvsc_tpu_torch`` and runs where the JAX package runs (about a minute on
one CPU core).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "varbitrate.toml")
BVRNN_NPZ = os.path.join(REPO, "chkpts", "bvsc_bvrnn_demo_augfull_step1800_f16.npz")
VOC_NPZ = os.path.join(REPO, "chkpts_npz", "bvsc_vocoder_demo_cl_ft_g_step600_f16.npz")
WAV = os.path.join(REPO, "docs", "artifacts", "demo_stim15_3kbps.wav")
DEFAULT_OUT = os.path.join(REPO, "chkpts_npz", "golden_demo_stim15_3kbps.npz")
BITRATE = 3000.0


def load_wav(path: str = WAV) -> np.ndarray:
    """The demo utterance as float32 in [-1, 1), (samples,)."""
    from scipy.io import wavfile

    fs, data = wavfile.read(path)
    if fs != 22050:
        raise ValueError(f"{path} is {fs} Hz, expected 22050")
    return data.astype(np.float32) / 32768.0


def goldens(bitrate: float = BITRATE) -> dict[str, np.ndarray]:
    """The JAX package's codes, decoded mel and waveform for the demo."""
    sys.path.insert(0, REPO)
    import jax.numpy as jnp

    from bvsc_tpu.codec import BVRNNCodecModel, _unflatten_npz

    with np.load(VOC_NPZ) as z:
        vocoder = _unflatten_npz(z, jnp.float32)
    codec = BVRNNCodecModel(CONFIG, BVRNN_NPZ, vocoder_params=vocoder)
    x = load_wav()[None]
    codes = np.asarray(codec.encode(x, bitrate))[0]
    mel = np.asarray(codec.decode_to_mel(codes[None]))[0]
    wav = np.asarray(codec.decode(codes[None], x.shape[1]))[0]
    return {"codes": np.round(2 * codes).astype(np.uint8), "mel": mel.astype(np.float32),
            "wav": wav.astype(np.float32), "bitrate": np.float64(bitrate),
            "length": np.int64(x.shape[1])}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("out", nargs="?", default=DEFAULT_OUT)
    args = parser.parse_args()
    g = goldens()
    np.savez_compressed(args.out, **g)
    print(f"{args.out}: codes {g['codes'].shape}, mel {g['mel'].shape}, wav {g['wav'].shape}, "
          f"{os.path.getsize(args.out)} bytes")


if __name__ == "__main__":
    main()
