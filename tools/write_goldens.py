#!/usr/bin/env python3
"""Write golden outputs of the JAX package for the demo utterance.

    python tools/write_goldens.py [OUT.npz]
    python tools/write_goldens.py --dtype bf16 [OUT.npz]

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

With ``--dtype bf16`` it runs the same codec with the bf16 storage dtype
(``dtype=jnp.bfloat16``: every weight and the recurrent state in bf16, the
vocoder on its default direct path in bf16) and writes, by default into
``chkpts_npz/golden_demo_stim15_3kbps_bf16.npz``, bf16 values as their 16
bits (uint16):

* ``step_frames`` (n,) int64: frames of the demo, each one BVRNN step;
* ``step_mel`` (n, num_mels) float32: the log-mel input of each;
* ``step_h`` (n, h_dim) bf16 bits: the closed loop's state before it;
* ``step_enc`` (n, z_dim) bf16 bits: the encoder's probabilities from
  that state (before rounding), the function jitted as in the scan;
* ``step_h_next`` (n, h_dim) bf16 bits: the state after it, one
  ``encode_with_state`` step from ``step_h``;
* ``codes`` (uint8, 2 * code), ``mel`` (bf16 bits, ``decode_to_mel`` of
  those codes), ``wav_bf16`` (bf16 bits: ``decode``'s waveform before the
  -10 dB input scaling is undone, the generator's own bf16 output), with
  ``bitrate``, ``length`` and ``scaling``.

A port step is held to ``step_*`` from the same state and input: the
chaos of the bf16 closed loop (ROADMAP.md's watch list) lets no
free-running comparison hold a tolerance; the closed-loop arrays are
compared with no gate.
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
DEFAULT_OUT_BF16 = os.path.join(REPO, "chkpts_npz", "golden_demo_stim15_3kbps_bf16.npz")
BITRATE = 3000.0
STEP_FRAMES = (30, 70, 110, 150, 190)  # the bf16 golden's teacher-forced steps


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


def bf16_bits(a) -> np.ndarray:
    """A bf16 array as its 16 bits (uint16)."""
    import jax.numpy as jnp

    return np.asarray(jnp.asarray(a, jnp.bfloat16)).view(np.uint16)


def goldens_bf16(bitrate: float = BITRATE) -> dict[str, np.ndarray]:
    """The JAX package's bf16-storage codec on the demo: the teacher-forced
    steps and the closed loop (module docstring)."""
    sys.path.insert(0, REPO)
    import jax
    import jax.numpy as jnp

    from bvsc_tpu.codec import SCALING, BVRNNCodecModel, _unflatten_npz
    from bvsc_tpu.models import bvrnn as B

    with np.load(VOC_NPZ) as z:
        vocoder = _unflatten_npz(z, jnp.bfloat16)
    codec = BVRNNCodecModel(CONFIG, BVRNN_NPZ, vocoder_params=vocoder, dtype=jnp.bfloat16)
    x = load_wav()[None]
    codes = codec.encode(x, bitrate)
    mel_dec = codec.decode_to_mel(codes)[0]
    wav = np.asarray(codec.decode(codes, x.shape[1]))[0]

    # the closed loop's states before each frame, from its own input mel
    p, cfg = codec.bvrnn_params, codec.bvrnn_cfg
    mel = jnp.swapaxes(codec.frontend(jnp.asarray(x) * SCALING), 1, 2)[:, : codes.shape[1]]
    bits = jnp.full(mel.shape[:2], codec.bits_per_frame(bitrate), jnp.float32)
    h0 = jnp.zeros((1, cfg.h_dim), cfg.dtype)
    _, h_seq = B.encode(p, cfg, mel, bits, h0)
    prec = cfg.precision

    @jax.jit
    def enc(h, y):
        phi_x = B.phi_x_apply(p, B._normalize(p, y.astype(cfg.dtype)), prec)
        return B.enc_apply(p, jnp.concatenate([phi_x, h], -1), prec)

    frames = np.asarray(STEP_FRAMES, np.int64)
    step = {"h": [], "enc": [], "h_next": []}
    for t in frames:
        h, y = h_seq[:, t], mel[:, t]
        _, h_next = B.encode_with_state(p, cfg, mel[:, t: t + 1], bits[:, t: t + 1], h)
        # the whole-sequence scan hoists phi_x over the frames, which sums
        # in another order: its next state may differ in a few last bits
        moved = int((np.asarray(h_next) != np.asarray(h_seq[:, t + 1])).sum())
        print(f"frame {t}: the one-step state differs from the loop's in {moved} entries")
        step["h"].append(bf16_bits(h[0]))
        step["enc"].append(bf16_bits(enc(h, y)[0]))
        step["h_next"].append(bf16_bits(h_next[0]))
    return {"step_frames": frames, "step_mel": np.asarray(mel[0, frames], np.float32),
            **{f"step_{k}": np.stack(v) for k, v in step.items()},
            "codes": np.round(2 * np.asarray(codes[0], np.float32)).astype(np.uint8),
            "mel": bf16_bits(mel_dec), "wav_bf16": bf16_bits(wav * SCALING),
            "bitrate": np.float64(bitrate), "length": np.int64(x.shape[1]),
            "scaling": np.float64(SCALING)}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("out", nargs="?", default=None)
    parser.add_argument("--dtype", choices=("f32", "bf16"), default="f32",
                        help="the codec's storage dtype (default f32)")
    args = parser.parse_args()
    if args.dtype == "bf16":
        g = goldens_bf16()
        args.out = args.out or DEFAULT_OUT_BF16
        np.savez_compressed(args.out, **g)
        print(f"{args.out}: steps {g['step_frames'].tolist()}, codes {g['codes'].shape}, "
              f"{os.path.getsize(args.out)} bytes")
        return
    args.out = args.out or DEFAULT_OUT
    g = goldens()
    np.savez_compressed(args.out, **g)
    print(f"{args.out}: codes {g['codes'].shape}, mel {g['mel'].shape}, wav {g['wav'].shape}, "
          f"{os.path.getsize(args.out)} bytes")


if __name__ == "__main__":
    main()
