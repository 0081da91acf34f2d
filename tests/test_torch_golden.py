"""The golden outputs of the JAX package (``tools/write_goldens.py`` ->
``chkpts_npz/golden_demo_stim15_3kbps.npz``: the trained pair on the demo
utterance at 3 kbps, batch 1, parity) reproduced by the port at
``device='cpu'``: codes bit-exact, decoded mel within 2e-5 (the port's
BVRNN gate), waveform SNR > 40 dB; and the file is what the tool writes.
``chip_smoke.py`` (phase ``golden``) holds the port on the card against the
same file."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from bvsc_tpu.eval.metrics import snr_db
from bvsc_tpu_torch import BVRNNCodecModel

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "chkpts_npz", "golden_demo_stim15_3kbps.npz")
MEL_TOL = 2e-5  # the BVRNN gate of the port (ROADMAP.md)
MAX_BYTES = 400_000


def _tool():
    spec = importlib.util.spec_from_file_location(
        "write_goldens", os.path.join(REPO, "tools", "write_goldens.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def port(golden):
    """The port's codes, decoded mel, decode and resynthesis on the demo."""
    tool = _tool()
    codec = BVRNNCodecModel(tool.CONFIG, tool.BVRNN_NPZ, tool.VOC_NPZ, device="cpu")
    x = tool.load_wav()[None]
    codes = golden["codes"][None].astype(np.float32) / 2
    bitrate = float(golden["bitrate"])
    return {"codes": codec.encode(x, bitrate).numpy()[0],
            "mel": codec.decode_to_mel(codes).numpy()[0],
            "wav": codec.decode(codes, x.shape[1]).numpy()[0],
            "resynthesis": codec(x, bitrate).numpy()[0]}


@pytest.mark.parametrize("case", ["codes", "mel", "wav", "resynthesis"])
def test_port_reproduces_goldens(golden, port, case):
    if case == "codes":
        np.testing.assert_array_equal(np.round(2 * port["codes"]).astype(np.uint8), golden["codes"])
    elif case == "mel":
        np.testing.assert_allclose(port["mel"], golden["mel"], atol=MEL_TOL)
    else:
        assert port[case].shape == golden["wav"].shape == (int(golden["length"]),)
        assert snr_db(golden["wav"], port[case]) > 40.0


def test_file_is_what_the_tool_writes(golden):
    """Under 0.4 MB, and the tool run again gives the same codes (mel and
    waveform to float32 rounding: the JAX CPU backend may order its sums
    otherwise on another host)."""
    assert os.path.getsize(GOLDEN) < MAX_BYTES
    assert set(np.unique(golden["codes"])) <= {0, 1, 2}
    again = _tool().goldens(float(golden["bitrate"]))
    assert sorted(again) == sorted(golden)
    np.testing.assert_array_equal(again["codes"], golden["codes"])
    for key in ("mel", "wav"):
        assert again[key].dtype == golden[key].dtype == np.float32
        np.testing.assert_allclose(again[key], golden[key], atol=1e-6)
    assert again["length"] == golden["length"] == golden["wav"].shape[0]
