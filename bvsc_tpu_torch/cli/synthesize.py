"""Vocoder-only synthesis CLI (port of ``scripts/synthesize.py``), the
counterpart of the reference's ``third_party/BigVGAN/inference.py`` (wav ->
mel -> wav) and ``inference_e2e.py`` (``.npy`` mel -> wav)::

    python -m bvsc_tpu_torch.cli.synthesize --input_wavs_dir IN --output_dir OUT \\
        --checkpoint_file exp/voc/g_00050000 [--config configs/varbitrate.toml] [--device cpu]
    python -m bvsc_tpu_torch.cli.synthesize --input_mels_dir IN_NPY --output_dir OUT ...

The checkpoint is a vocoder ``.npz`` (``tools/export_vocoder_npz.py``), a
port trainer's ``g_`` / ``do_`` file (``train/checkpoint.py``) or an upstream
BigVGAN ``g_`` file (``{'generator': state_dict}``), weight norm folded
(``codec.load_vocoder_checkpoint``).  Without ``--config``, a ``config.toml`` / ``config.json`` beside
the checkpoint is used (reference ``inference.py:83``), else
``configs/varbitrate.toml``; a JSON is a BigVGAN-style vocoder config.  The
generator runs on the first CUDA card with its residual stacks through the
K1 kernel (12 launches a file), float32 with TF32 off, unless ``--device
cpu``, where it runs the plain stack; a config the kernel does not cover
(a vocoder variant, or a dilation count other than three) runs the direct
path (``models.vocoder.generator_apply``).  wav mode scales the peak-normalised
input by the codec's -10 dB before the mel and divides the output by it;
``.npy`` mels (``cli.dump_finetune_mels``) are in that domain already and
their output is written as it comes.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import scipy.signal
import torch

from bvsc_tpu_torch.codec import DEFAULT_CONFIG, SCALING, load_vocoder_checkpoint
from bvsc_tpu_torch.config import CodecConfig, VocoderConfig
from bvsc_tpu_torch.convert import to_torch
from bvsc_tpu_torch.data.audio import load_wav, peak_normalize, save_wav
from bvsc_tpu_torch.device import resolve_device, set_parity_mode
from bvsc_tpu_torch.eval.metrics import frontend_for
from bvsc_tpu_torch.models import vocoder as voc_mod
from bvsc_tpu_torch.ops.amp_resblock import supported
from bvsc_tpu_torch.ops.mel import MelFrontend


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m bvsc_tpu_torch.cli.synthesize",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--input_wavs_dir", default=None)
    p.add_argument("--input_mels_dir", default=None)
    p.add_argument("--output_dir", default="generated_files")
    p.add_argument("--checkpoint_file", required=True,
                   help="vocoder .npz, a port g_ / do_ checkpoint or an upstream BigVGAN g_ "
                        "file")
    p.add_argument("--config", default=None,
                   help="codec TOML or BigVGAN-style JSON; when omitted, a config.toml / "
                        "config.json beside the checkpoint (reference inference.py:83), else "
                        "configs/varbitrate.toml")
    p.add_argument("--fs_out", type=int, default=None,
                   help="resample outputs to this rate before writing")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default: the first card) or 'cpu'")
    return p.parse_args(argv)


def find_config_near(checkpoint_file: str) -> str | None:
    """A ``config.toml`` / ``config.json`` in the checkpoint's directory
    (reference ``inference.py:83``: config.json next to the checkpoint); a
    checkpoint that is a directory is looked in first."""
    path = os.path.abspath(checkpoint_file)
    dirs = [os.path.dirname(path)]
    if os.path.isdir(path):
        dirs.insert(0, path)
    for d in dirs:
        for name in ("config.toml", "config.json"):
            cand = os.path.join(d, name)
            if os.path.isfile(cand):
                return cand
    return None


def load_vocoder(path: str, vcfg: VocoderConfig) -> dict:
    """The folded generator tree (tensors on the CPU) of a vocoder ``.npz``,
    a port trainer's ``g_`` / ``do_`` checkpoint or an upstream BigVGAN
    ``g_`` file; a directory (an Orbax checkpoint) exits naming the
    exporter."""
    if os.path.isdir(path):
        raise SystemExit(f"{path} is a directory (bvsc_tpu's Orbax checkpoint?): the port reads "
                         "a vocoder .npz (tools/export_vocoder_npz.py), its own g_ files or "
                         "upstream BigVGAN g_ files")
    return load_vocoder_checkpoint(path, vcfg)


def load_vocoder_config(path: str, device) -> tuple[VocoderConfig, int, MelFrontend]:
    """(vocoder config, sampling rate, mel frontend) of a codec TOML or a
    BigVGAN-style JSON (reference ``inference.py:83-89``)."""
    if path.endswith(".json"):
        with open(path) as f:
            raw = json.load(f)
        fs = raw.get("sampling_rate", 22050)
        frontend = MelFrontend(sampling_rate=fs, n_fft=raw.get("n_fft", 1024),
                               num_mels=raw.get("num_mels", 80), hop_size=raw.get("hop_size", 256),
                               fmin=raw.get("fmin", 0), fmax=raw.get("fmax", 8000),
                               padding_left=raw.get("mel_pad_left", 256), device=device)
        return VocoderConfig.from_dict(raw), fs, frontend
    conf = CodecConfig.from_toml(path)
    return conf.vocoder_config, conf.fs, frontend_for(conf, device)


def _resample(wav: np.ndarray, fs: int, fs_out: int | None) -> tuple[np.ndarray, int]:
    """(wav, fs), polyphase-resampled to ``fs_out`` when given."""
    if not fs_out or fs_out == fs:
        return wav, fs
    return scipy.signal.resample_poly(wav.astype(np.float64), fs_out, fs).astype(np.float32), fs_out


def _write(args, src: str, suffix: str, wav: np.ndarray, fs: int) -> str:
    dst = os.path.join(args.output_dir, os.path.splitext(os.path.basename(src))[0] + suffix)
    wav_out, fs_out = _resample(wav, fs, args.fs_out)
    save_wav(wav_out, dst, fs_out)
    print(dst)
    return dst


def main(argv=None) -> list[str]:
    args = parse_args(argv)
    if (args.input_wavs_dir is None) == (args.input_mels_dir is None):
        raise SystemExit("give exactly one of --input_wavs_dir / --input_mels_dir")
    device = resolve_device(args.device)
    set_parity_mode()
    config_path = args.config
    if config_path is None:
        config_path = find_config_near(args.checkpoint_file) or DEFAULT_CONFIG
        print(f"using config {config_path}")
    vcfg, fs, frontend = load_vocoder_config(config_path, device)
    params = to_torch(load_vocoder(args.checkpoint_file, vcfg), device)
    # the kernels where they cover the config (the codec's default), else
    # the direct path
    if supported(vcfg):
        blocks = voc_mod.prepare_kernel_params(params, vcfg)
    else:
        params, blocks = voc_mod.prepare_direct_params(params, vcfg), None
    os.makedirs(args.output_dir, exist_ok=True)

    def vocode(mel: torch.Tensor, length: int | None) -> np.ndarray:
        with torch.no_grad():
            if blocks is None:
                y = voc_mod.generator_apply(params, vcfg, mel, length)
            else:
                y = voc_mod.generator_apply_kernel(params, blocks, vcfg, mel, length)
        return y[0, 0].cpu().numpy()

    written = []
    if args.input_wavs_dir:
        for f in sorted(glob.glob(os.path.join(args.input_wavs_dir, "*.wav"))):
            wav, _ = load_wav(f, fs)
            if wav.ndim > 1:
                wav = wav[:, 0]
            wav = peak_normalize(wav) * 0.95
            mel = frontend(torch.as_tensor(wav[None, :], dtype=torch.float32, device=device)
                           * SCALING)
            out = vocode(mel, wav.shape[0]) / SCALING
            written.append(_write(args, f, "_generated.wav", out, fs))
    else:
        for f in sorted(glob.glob(os.path.join(args.input_mels_dir, "*.npy"))):
            mel = np.load(f)
            if mel.ndim == 2:
                mel = mel[None]
            written.append(_write(args, f, "_generated_e2e.wav",
                                  vocode(torch.as_tensor(mel, dtype=torch.float32, device=device),
                                         None), fs))
    return written


if __name__ == "__main__":
    main()
