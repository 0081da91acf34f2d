"""The port's ``.bvsc`` file codec (bvsc_tpu_torch.cli.codec_cli) against
``scripts/codec_cli.py``: version 1 files byte for byte ``bvsc_tpu``'s on
the same codes (constant and variable bitrate) and read by either package;
version 3 (the port's prior) round trips; the port refuses ``bvsc_tpu``'s
version 2 and ``bvsc_tpu``'s reader refuses version 3; garbage, truncated
and oversized headers raise (the pattern of tests/test_entropy.py); and the
CLI end to end at the small config of tests/test_torch_codec.py on
``--device cpu``."""

import os
import struct
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from bvsc_tpu.entropy import PriorEntropyCoder as JaxCoder
from bvsc_tpu.models import bvrnn as jb
from bvsc_tpu_torch import BVRNNCodecModel
from bvsc_tpu_torch.cli import codec_cli as TCLI
from bvsc_tpu_torch.codec import DEFAULT_CONFIG, host_bvrnn_params
from bvsc_tpu_torch.config import load_config
from bvsc_tpu_torch.data.audio import load_wav, save_wav
from bvsc_tpu_torch.entropy import PriorEntropyCoder
from bvsc_tpu_torch.models import bvrnn as bvrnn_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import codec_cli as JCLI  # noqa: E402  (scripts/codec_cli.py)

torch.set_num_threads(1)

FS = 22050


@pytest.fixture(scope="module")
def small():
    cfg = bvrnn_mod.BVRNNConfig(x_dim=12, h_dim=48, z_dim=20)
    params = bvrnn_mod.init_bvrnn_params(5, cfg)
    rng = np.random.default_rng(8)
    frames = 41
    ks = rng.integers(0, cfg.z_dim + 1, frames)
    ks[3] = 0
    codes = np.full((frames, cfg.z_dim), 0.5, np.float32)
    for t, k in enumerate(ks):
        codes[t, :k] = rng.integers(0, 2, k)
    return cfg, params, codes, ks


def _masked(codes, bits):
    """What a file carries: the first k bits hard, 0.5 past them."""
    kk = np.broadcast_to(np.ceil(np.asarray(bits, np.float64)), (codes.shape[0],))
    out = (codes > 0.5).astype(np.float32)
    out[np.arange(codes.shape[1])[None, :] >= kk[:, None]] = 0.5
    return out


@pytest.mark.parametrize("bits", [7, 0, 20, "vbr"])
def test_v1_bytes_equal_jax(small, tmp_path, bits):
    _, _, codes, ks = small
    bits = ks if bits == "vbr" else bits
    ours, theirs = str(tmp_path / "port.bvsc"), str(tmp_path / "jax.bvsc")
    TCLI.write_bvsc(ours, codes, bits, FS)
    JCLI.write_bvsc(theirs, codes, bits, FS)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    for reader in (TCLI.read_bvsc, JCLI.read_bvsc):
        got, got_bits, fs = reader(ours)
        np.testing.assert_array_equal(got, _masked(codes, bits))
        np.testing.assert_array_equal(got_bits, bits)
        assert fs == FS


@pytest.mark.parametrize("bits", [9, "vbr"])
def test_v3_roundtrip(small, tmp_path, bits):
    cfg, params, codes, ks = small
    bits = ks if bits == "vbr" else bits
    coder = PriorEntropyCoder(params, cfg)
    path = str(tmp_path / "v3.bvsc")
    TCLI.write_bvsc(path, codes, bits, FS, coder=coder)
    raw = open(path, "rb").read()
    assert raw[:5] == b"BVSC\x03"
    got, got_bits, fs = TCLI.read_bvsc(path, lambda: coder)
    np.testing.assert_array_equal(got, _masked(codes, bits))
    np.testing.assert_array_equal(got_bits, bits)
    with pytest.raises(ValueError, match="coder_factory"):
        TCLI.read_bvsc(path)
    wrong = PriorEntropyCoder(bvrnn_mod.init_bvrnn_params(5, bvrnn_mod.BVRNNConfig(
        x_dim=12, h_dim=48, z_dim=21)), bvrnn_mod.BVRNNConfig(x_dim=12, h_dim=48, z_dim=21))
    with pytest.raises(ValueError, match="z_dim"):
        TCLI.read_bvsc(path, lambda: wrong)


def test_v2_and_v3_refused_across_packages(small, tmp_path):
    """bvsc_tpu's prior-coded file (version 2) is refused by the port with
    bvsc_tpu's CLI named; the port's (version 3) is refused by bvsc_tpu."""
    cfg, params, codes, ks = small
    jcfg = jb.BVRNNConfig(x_dim=12, h_dim=48, z_dim=20)
    jcoder = JaxCoder(jb.init_bvrnn_params(jax.random.key(3), jcfg), jcfg)
    v2, v3 = str(tmp_path / "v2.bvsc"), str(tmp_path / "v3.bvsc")
    JCLI.write_bvsc(v2, codes, ks, FS, coder=jcoder)
    TCLI.write_bvsc(v3, codes, ks, FS, coder=PriorEntropyCoder(params, cfg))
    assert open(v2, "rb").read()[4] == 2
    with pytest.raises(ValueError, match=r"version 2 is bvsc_tpu's.*scripts/codec_cli.py"):
        TCLI.read_bvsc(v2, lambda: PriorEntropyCoder(params, cfg))
    with pytest.raises(ValueError, match="unsupported version 3"):
        JCLI.read_bvsc(v3, lambda: jcoder)


def test_truncated_vbr_table_rejected(small, tmp_path):
    cfg, params, codes, ks = small
    coder = PriorEntropyCoder(params, cfg)
    path, trunc = str(tmp_path / "vbr.bvsc"), str(tmp_path / "trunc.bvsc")
    TCLI.write_bvsc(path, codes, ks, FS, coder=coder)
    with open(trunc, "wb") as f:
        f.write(open(path, "rb").read()[: 16 + len(ks) // 2])
    with pytest.raises(ValueError, match="truncated VBR"):
        TCLI.read_bvsc(trunc, lambda: coder)
    with pytest.raises(ValueError, match="shape"):
        TCLI.write_bvsc(path, codes, ks[:-1], FS)


def test_reader_rejects_garbage(small, tmp_path):
    """Random blobs, absurd frame counts and truncations or corruptions of
    valid files raise ValueError: never a crash, a hang or a huge
    allocation, for both versions."""
    cfg, params, codes, _ = small
    coder = PriorEntropyCoder(params, cfg)
    v1, v3 = str(tmp_path / "v1.bvsc"), str(tmp_path / "v3.bvsc")
    TCLI.write_bvsc(v1, codes, 7, FS)
    TCLI.write_bvsc(v3, codes, 7, FS, coder=coder)
    rng = np.random.default_rng(0)
    bad = str(tmp_path / "bad.bvsc")

    def rejected(blob: bytes) -> bool:
        with open(bad, "wb") as f:
            f.write(blob)
        try:
            TCLI.read_bvsc(bad, lambda: coder)
        except ValueError:
            return True
        return False

    for n in (0, 3, 16, 64):
        assert rejected(rng.bytes(n))  # wrong magic
    for _ in range(50):
        n = int(rng.integers(1, 40))
        if not rejected(b"BVSC" + rng.bytes(n)):
            assert n >= 12, "short header accepted"
    huge = b"BVSC" + struct.pack("<BBHII", 3, cfg.z_dim, 7, FS, 1 << 31)
    assert rejected(huge + b"\x00" * 8)
    assert rejected(b"BVSC" + struct.pack("<BBHII", 1, cfg.z_dim, 0xFFFF, FS, 1 << 31))
    assert rejected(b"BVSC" + struct.pack("<BBHII", 1, cfg.z_dim, 7, FS, 1 << 31))
    assert rejected(b"BVSC" + struct.pack("<BBHII", 9, cfg.z_dim, 7, FS, 1))
    for path in (v1, v3):
        raw = open(path, "rb").read()
        for _ in range(20):
            cut = int(rng.integers(0, len(raw)))
            rejected(raw[:cut])  # must not crash
        assert rejected(raw[:15])
    raw = bytearray(open(v3, "rb").read())
    truth, _, _ = TCLI.read_bvsc(v3, lambda: coder)
    for _ in range(10):  # a corrupt body never decodes to the original codes silently
        i = int(rng.integers(16, len(raw)))
        raw[i] ^= 0xA5
        with open(bad, "wb") as f:
            f.write(bytes(raw))
        try:
            assert not np.array_equal(TCLI.read_bvsc(bad, lambda: coder)[0], truth)
        except ValueError:
            pass
        raw[i] ^= 0xA5


@pytest.fixture(scope="module")
def small_config(tmp_path_factory):
    """The default config at the small width of tests/test_torch_codec.py."""
    text = open(DEFAULT_CONFIG).read()
    text = text.replace("h_dim = 1024", "h_dim = 48").replace("z_dim = 64 ", "z_dim = 12 ")
    path = tmp_path_factory.mktemp("cfg") / "small.toml"
    path.write_text(text)
    conf = load_config(str(path))
    assert (conf.h_dim, conf.z_dim) == (48, 12)
    return str(path)


def test_cli_end_to_end_on_cpu(small_config, tmp_path):
    """encode --entropy, then decode, as subprocesses on ``--device cpu``:
    the file's codes are the in-process codec's, and the wav is its decode
    written the same way.  encode without --entropy writes bvsc_tpu's
    version 1 bytes."""
    x = (np.random.default_rng(9).standard_normal(4000) * 0.2).astype(np.float32)
    wav_in, v3, v1 = (str(tmp_path / n) for n in ("in.wav", "v3.bvsc", "v1.bvsc"))
    save_wav(x, wav_in, FS)
    x = load_wav(wav_in)[0]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p)}  # one thread, as this process

    def cli(*args):
        proc = subprocess.run([sys.executable, "-m", "bvsc_tpu_torch.cli.codec_cli", *args,
                               "--config", small_config, "--device", "cpu"],
                              capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
        assert proc.returncode == 0, proc.stderr
        return proc.stdout

    assert "entropy-coded" in cli("encode", wav_in, v3, "--bitrate", "600", "--entropy")
    cli("encode", wav_in, v1, "--bitrate", "600")
    out_wav = str(tmp_path / "out.wav")
    cli("decode", v3, out_wav)

    conf = load_config(small_config)
    codec = BVRNNCodecModel(config=conf, device="cpu")
    codes = codec.encode(x[None], 600.0)[0].numpy()
    coder = PriorEntropyCoder(host_bvrnn_params(conf), codec.bvrnn_cfg)
    got, bits, fs = TCLI.read_bvsc(v3, lambda: coder)
    np.testing.assert_array_equal(got, codes)
    assert bits == conf.bits_per_frame(600.0) == 7 and fs == FS
    ref_v1 = str(tmp_path / "ref_v1.bvsc")
    JCLI.write_bvsc(ref_v1, codes, 7, FS)
    assert open(v1, "rb").read() == open(ref_v1, "rb").read()
    ref_wav = str(tmp_path / "ref.wav")
    save_wav(codec.decode(got[None], got.shape[0] * conf.hopsize)[0].numpy(), ref_wav, FS)
    a, b = load_wav(out_wav), load_wav(ref_wav)
    assert a[1] == b[1] == FS and a[0].shape == (got.shape[0] * conf.hopsize,)
    np.testing.assert_array_equal(a[0], b[0])
