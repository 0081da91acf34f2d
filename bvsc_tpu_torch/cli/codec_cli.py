"""Codec file CLI: encode wavs to ``.bvsc`` bitstream files and back.

Port of ``scripts/codec_cli.py``::

    python -m bvsc_tpu_torch.cli.codec_cli encode in.wav out.bvsc --bitrate 3000 [--entropy]
    python -m bvsc_tpu_torch.cli.codec_cli decode out.bvsc roundtrip.wav [--fs_out 16000]

The codec runs on the first CUDA card; ``--device cpu`` runs it on the
CPU (there is no silent fallback).  The container format:

  magic 'BVSC', version u8, z_dim u8, bits/frame u16, fs u32, frames u32,
  a per-frame u8 allocation table when bits/frame is 0xFFFF (variable
  bitrate), then the payload:
    version 1: the first-k priority bits of each frame packed little
               endian (``ops.bitpack``), byte for byte ``bvsc_tpu``'s
               version 1 file on the same codes;
    version 3: the same bits rANS-coded against the BVRNN's own prior,
               computed by the port's deterministic host pass
               (``bvsc_tpu_torch.entropy``); decoding needs the same BVRNN
               checkpoint, since the prior is the entropy model.

**Versions 2 and 3 are not interchangeable.** Version 2 is ``bvsc_tpu``'s
prior-coded file, whose entropy model is its float32 prior; the port's is
float64 in a fixed order, and the two differ by a quantisation step on a
few probabilities, which desyncs rANS.  So the port writes version 3, and
this reader refuses version 2, naming ``bvsc_tpu``'s CLI
(``scripts/codec_cli.py``) to decode it; ``bvsc_tpu``'s reader refuses
version 3 as an unknown version.  Neither package can decode the other's
prior-coded file into wrong codes without notice.
"""

from __future__ import annotations

import argparse
import os
import struct

import numpy as np

from bvsc_tpu_torch.cli import BVRNN_HELP, VOCODER_HELP

MAGIC = b"BVSC"
VERSION_RAW = 1
VERSION_BVSC_TPU_PRIOR = 2  # bvsc_tpu's float32 prior: refused
VERSION_PRIOR = 3
# bits/frame header sentinel: a per-frame u8 allocation table follows the
# header (variable bitrate files; k <= z_dim <= 255, so a real constant
# never collides)
_BITS_VBR = 0xFFFF
# a prior-coded payload's size does not bound frames (a confident prior
# compresses arbitrarily well), so cap the untrusted header instead:
# 2^22 frames ~ 13.5 h of audio ~ 1 GB of decoded codes
_MAX_ENTROPY_FRAMES = 1 << 22


def write_bvsc(path, codes: np.ndarray, bits_per_frame, fs: int, coder=None) -> None:
    """codes: (frames, z_dim) on the host.  bits_per_frame: int (constant)
    or (frames,) array (VBR: a per-frame u8 table is stored; entries are
    clamped to [0, z_dim], the effective allocation).  coder: a
    ``bvsc_tpu_torch.entropy.PriorEntropyCoder`` for version 3; None
    writes version 1 raw packing."""
    from bvsc_tpu_torch.ops.bitpack import pack_codes

    frames, z_dim = codes.shape
    ks = np.asarray(bits_per_frame, np.int64)
    if coder is not None:
        version, payload = VERSION_PRIOR, coder.encode(codes, bits_per_frame)
    else:
        version, payload = VERSION_RAW, pack_codes(codes, bits_per_frame)
    with open(path, "wb") as f:
        f.write(MAGIC)
        if ks.ndim == 0:
            f.write(struct.pack("<BBHII", version, z_dim, int(ks), fs, frames))
        else:
            if ks.shape != (frames,):
                raise ValueError(f"bits_per_frame shape {ks.shape} != ({frames},)")
            f.write(struct.pack("<BBHII", version, z_dim, _BITS_VBR, fs, frames))
            f.write(np.clip(ks, 0, z_dim).astype(np.uint8).tobytes())
        f.write(payload)


def read_bvsc(path, coder_factory=None):
    """coder_factory: zero-argument callable returning a
    ``PriorEntropyCoder``, needed only for version 3 (the prior is the
    entropy model, so the decoder needs the same BVRNN checkpoint).
    Returns (codes, bits_per_frame, fs); bits_per_frame is an int or a
    (frames,) array.  Raises ValueError on anything malformed, and on
    ``bvsc_tpu``'s version 2."""
    from bvsc_tpu_torch.ops.bitpack import payload_nbytes, unpack_codes

    with open(path, "rb") as f:
        if f.read(4) != MAGIC:
            raise ValueError(f"{path}: not a BVSC bitstream")
        header = f.read(12)
        if len(header) != 12:
            raise ValueError(f"{path}: truncated header")
        version, z_dim, bits, fs, frames = struct.unpack("<BBHII", header)
        if version == VERSION_BVSC_TPU_PRIOR:
            raise ValueError(
                f"{path}: version 2 is bvsc_tpu's prior-coded file, coded against its "
                "float32 prior, which this package does not reproduce bit for bit; "
                "decode it with bvsc_tpu's CLI (python scripts/codec_cli.py decode)")
        if version not in (VERSION_RAW, VERSION_PRIOR):
            raise ValueError(f"{path}: unsupported version {version}")
        if bits == _BITS_VBR:
            # the table is frames-proportional: cap the untrusted header
            # before the read
            if frames > _MAX_ENTROPY_FRAMES:
                raise ValueError(f"{path}: frames header {frames} exceeds cap")
            table = f.read(frames)
            if len(table) != frames:
                raise ValueError(f"{path}: truncated VBR allocation table")
            bits = np.frombuffer(table, np.uint8).astype(np.int32)
        payload = f.read()
    if version == VERSION_PRIOR:
        if coder_factory is None:
            raise ValueError(f"{path}: prior-coded stream (version 3) needs the BVRNN "
                             "prior to decode; pass coder_factory")
        if frames > _MAX_ENTROPY_FRAMES:
            raise ValueError(f"{path}: frames header {frames} exceeds cap")
        coder = coder_factory()
        if coder.cfg.z_dim != z_dim:
            raise ValueError(f"{path}: z_dim {z_dim} != model {coder.cfg.z_dim}")
        return coder.decode(payload, bits, frames), bits, fs
    # version 1: check the untrusted frame count against the payload's size
    # before allocating frames * z_dim floats
    need = payload_nbytes(bits, frames, z_dim)
    if len(payload) < need:
        raise ValueError(f"{path}: truncated payload ({len(payload)} B, header implies {need} B)")
    return unpack_codes(payload, bits, frames, z_dim), bits, fs


def _resample(wav: np.ndarray, fs_out: int, fs_in: int) -> np.ndarray:
    import scipy.signal

    return scipy.signal.resample_poly(wav.astype(np.float64), fs_out, fs_in).astype(np.float32)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m bvsc_tpu_torch.cli.codec_cli")
    p.add_argument("mode", choices=["encode", "decode"])
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--bitrate", type=float, default=3000.0)
    p.add_argument("--entropy", action="store_true",
                   help="write version 3: rANS-code the bits against the BVRNN prior "
                        "(smaller payload, bit-identical codes; decode needs the same "
                        "checkpoint)")
    p.add_argument("--fs_out", type=int, default=None,
                   help="decode only: resample the output to this rate (e.g. 16000)")
    p.add_argument("--config", default=None)
    p.add_argument("--bvrnn_checkpoint", default=None,
                   help=BVRNN_HELP + "; random weights from seed 0 without one")
    p.add_argument("--vocoder_checkpoint", default=None,
                   help=VOCODER_HELP)
    p.add_argument("--device", default=None,
                   help="'cuda' (the default: the first card) or 'cpu'")
    args = p.parse_args(argv)

    from bvsc_tpu_torch.codec import DEFAULT_CONFIG, BVRNNCodecModel, host_bvrnn_params
    from bvsc_tpu_torch.config import load_config
    from bvsc_tpu_torch.data.audio import load_wav, save_wav
    from bvsc_tpu_torch.entropy import PriorEntropyCoder

    conf = load_config(args.config or DEFAULT_CONFIG)
    bvrnn_params = host_bvrnn_params(conf, args.bvrnn_checkpoint)
    codec = BVRNNCodecModel(config=conf, bvrnn_params=bvrnn_params,
                            vocoder_chkpt_path=args.vocoder_checkpoint, device=args.device)
    fs = conf.fs

    def coder_factory():
        return PriorEntropyCoder(bvrnn_params, codec.bvrnn_cfg)

    if args.mode == "encode":
        # any input rate: resample to the model's
        wav, fs_in = load_wav(args.input)
        if wav.ndim > 1:
            wav = wav[:, 0]
        if fs_in != fs:
            wav = _resample(wav, fs, fs_in)
        if not conf.var_bit:
            # a fixed-bitrate model emits z_dim informative bits per frame
            # whatever was requested; fewer in the file would corrupt the
            # decode
            full = conf.z_dim * conf.fs / conf.hopsize
            if conf.bits_per_frame(args.bitrate) != conf.z_dim:
                raise SystemExit(f"fixed-bitrate config: only --bitrate {full:.0f} "
                                 f"(= {conf.z_dim} bits/frame) is valid, got {args.bitrate}")
        codes = codec.encode(wav[None, :], args.bitrate)[0].float().cpu().numpy()
        write_bvsc(args.output, codes, conf.bits_per_frame(args.bitrate), fs,
                   coder=coder_factory() if args.entropy else None)
        size = os.path.getsize(args.output)
        print(f"{args.output}: {codes.shape[0]} frames, {size} B "
              f"({size * 8 / (wav.shape[0] / fs):.1f} bps incl. 16 B header"
              f"{', entropy-coded' if args.entropy else ''})")
    else:
        codes, bits, fs_stream = read_bvsc(args.input, coder_factory)
        length = codes.shape[0] * conf.hopsize
        wav = codec.decode(codes[None], length)[0].cpu().numpy()
        if args.fs_out and args.fs_out != fs_stream:
            wav = _resample(wav, args.fs_out, fs_stream)
            fs_stream = args.fs_out
        save_wav(wav, args.output, fs_stream)
        bits_desc = f"VBR, mean {float(np.mean(bits)):.1f}" if np.ndim(bits) else bits
        print(f"{args.output}: {wav.shape[0]} samples @ {fs_stream} Hz "
              f"(payload was {bits_desc} bits/frame)")


if __name__ == "__main__":
    main()
