"""Port mel frontend (bvsc_tpu_torch.ops.mel) against bvsc_tpu.ops.mel."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bvsc_tpu.ops import mel as jmel
from bvsc_tpu_torch.ops import mel as tmel

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def frontends():
    kw = dict(sampling_rate=22050, n_fft=1024, num_mels=80, hop_size=256,
              fmin=0.0, fmax=8000.0, padding_left=256)
    return jmel.MelFrontend(**kw), tmel.MelFrontend(**kw, device="cpu")


def test_logmel_matches_jax(frontends, rng):
    """Seeded 0.5 s waveform; the JAX package's own gate, 2e-4 on log-mel."""
    jf, tf = frontends
    y = (rng.standard_normal((2, 11025)) * 0.3).astype(np.float32)
    ref = np.asarray(jf(jnp.asarray(y)))
    got = tf(torch.from_numpy(y)).numpy()
    assert got.shape == ref.shape == (2, 80, jf.num_frames(11025))
    np.testing.assert_allclose(got, ref, atol=2e-4)


@pytest.mark.parametrize("length", [1024, 4099, 16384, 22050])
def test_frame_count_matches_jax(frontends, length):
    jf, tf = frontends
    assert tf.num_frames(length) == jf.num_frames(length)
    y = torch.zeros(1, length)
    assert tf(y).shape[-1] == jf.num_frames(length)


def test_constants_match_jax():
    np.testing.assert_array_equal(
        tmel.slaney_mel_filterbank(22050, 1024, 80, 0.0, 8000.0),
        jmel.slaney_mel_filterbank(22050, 1024, 80, 0.0, 8000.0),
    )
    np.testing.assert_array_equal(tmel.hann_window_periodic(1024),
                                  jmel.hann_window_periodic(1024))
    np.testing.assert_allclose(tmel.hann_window_periodic(1024),
                               torch.hann_window(1024).numpy(), atol=1e-6)
    for a, b in zip(tmel.dft_real_bases(1024), jmel.dft_real_bases(1024)):
        np.testing.assert_array_equal(a, b)


def test_default_device_is_cuda():
    """No silent CPU fallback: without a card the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmel.MelFrontend()
    assert tmel.MelFrontend(device="cpu").window.device.type == "cpu"
