"""The mel functional API and the small API of the port against
``bvsc_tpu``'s, on the same seeded inputs and trees.

* ``ops.mel_spectrogram`` (asymmetric and symmetric padding),
  ``stft_magnitude`` and ``MelFrontend.stft_and_mel``: within the
  frontend's 2e-4 of ``bvsc_tpu.ops.mel``'s (``stft_magnitude`` against
  both of its DFTs, the matmul one and ``rfft``).
* ``discriminator_r_apply_mag`` after ``resolution_spectrogram`` is
  ``discriminator_r_apply`` bit for bit.
* ``models.bvrnn.param_count`` and ``models.vocoder.generator_param_count``
  equal the JAX ones; ``ops.conv.tree_has_spectral_norm`` agrees with the
  JAX one on MRD trees with and without spectral norm.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bvsc_tpu.config import VocoderConfig as JVocoderConfig
from bvsc_tpu.models import bvrnn as jb
from bvsc_tpu.models import discriminators as JD
from bvsc_tpu.models import vocoder as jv
from bvsc_tpu.ops import conv as jconv
from bvsc_tpu.ops import mel as jmel
from bvsc_tpu_torch.config import VocoderConfig
from bvsc_tpu_torch.convert import discriminator_params_from_jax, to_torch
from bvsc_tpu_torch.models import bvrnn as tb
from bvsc_tpu_torch.models import discriminators as TD
from bvsc_tpu_torch.models import vocoder as tv
from bvsc_tpu_torch.ops import conv as tconv
from bvsc_tpu_torch.ops import mel as tmel
from bvsc_tpu_torch.ops import mel_spectrogram

torch.set_num_threads(1)

MEL_TOL = 2e-4  # the frontend's gate (ROADMAP.md, North star)
B, L = 2, 8000
N_FFT, HOP, MELS, FS = 1024, 256, 80, 22050


@pytest.fixture(scope="module")
def y():
    return (np.random.default_rng(3).standard_normal((B, L)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("padding_left", [256, -1], ids=["causal", "symmetric"])
def test_mel_spectrogram_matches_jax(y, padding_left):
    ref = np.asarray(jmel.mel_spectrogram(jnp.asarray(y), N_FFT, MELS, FS, HOP, N_FFT, 0.0,
                                          8000.0, padding_left))
    got = mel_spectrogram(torch.from_numpy(y), N_FFT, MELS, FS, HOP, N_FFT, 0.0, 8000.0,
                          padding_left)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=MEL_TOL)


def test_mel_spectrogram_refuses_a_short_window(y):
    with pytest.raises(ValueError, match="win_size"):
        mel_spectrogram(torch.from_numpy(y), N_FFT, MELS, FS, HOP, 512, 0.0, 8000.0, 256)


@pytest.mark.parametrize("use_matmul_dft", [True, False], ids=["matmul_dft", "rfft"])
def test_stft_magnitude_matches_jax(y, use_matmul_dft):
    padded = np.pad(y, ((0, 0), (256, N_FFT - 256 - HOP)), mode="reflect")
    window = tmel.hann_window_periodic(N_FFT)
    ref = np.asarray(jmel.stft_magnitude(jnp.asarray(padded), N_FFT, HOP, jnp.asarray(window),
                                         use_matmul_dft=use_matmul_dft))
    got = tmel.stft_magnitude(torch.from_numpy(padded), N_FFT, HOP, window)
    assert got.shape == ref.shape == (B, N_FFT // 2 + 1, 1 + (padded.shape[1] - N_FFT) // HOP)
    np.testing.assert_allclose(got.numpy(), ref, atol=MEL_TOL)


def test_stft_and_mel_matches_jax(y):
    ref_mel, ref_mag = jmel.MelFrontend().stft_and_mel(jnp.asarray(y))
    front = tmel.MelFrontend(device="cpu")
    mel, mag = front.stft_and_mel(torch.from_numpy(y))
    np.testing.assert_allclose(mel.numpy(), np.asarray(ref_mel), atol=MEL_TOL)
    np.testing.assert_allclose(mag.numpy(), np.asarray(ref_mag), atol=MEL_TOL)
    assert torch.equal(mel, front(torch.from_numpy(y)))


def test_discriminator_r_apply_mag_composes(y):
    vcfg = dataclasses.replace(VocoderConfig(), discriminator_channel_mult=0.125)
    params = to_torch(TD.init_discriminator_r_params(np.random.default_rng(0), vcfg))
    x = torch.from_numpy(y[:, None, :4096])
    for res in vcfg.resolutions:
        logits, fmap = TD.discriminator_r_apply(params, x, res)
        logits2, fmap2 = TD.discriminator_r_apply_mag(params, TD.resolution_spectrogram(x, res))
        assert torch.equal(logits, logits2)
        assert len(fmap) == len(fmap2) and all(torch.equal(a, b) for a, b in zip(fmap, fmap2))


@pytest.mark.parametrize("weight_norm", [False, True])
def test_param_counts_match_jax(weight_norm):
    bcfg = dict(x_dim=80, h_dim=48, z_dim=12)
    assert (tb.param_count(tb.init_bvrnn_params(0, tb.BVRNNConfig(**bcfg)))
            == jb.param_count(jb.init_bvrnn_params(jax.random.key(0), jb.BVRNNConfig(**bcfg))))
    assert (tv.generator_param_count(tv.init_generator_params(0, VocoderConfig(),
                                                              weight_norm=weight_norm))
            == jv.generator_param_count(jv.init_generator_params(
                jax.random.key(0), JVocoderConfig(), weight_norm=weight_norm)))


@pytest.mark.parametrize("spectral", [False, True])
def test_tree_has_spectral_norm_matches_jax(spectral):
    vcfg = dataclasses.replace(JVocoderConfig(), discriminator_channel_mult=0.125,
                               mrd_use_spectral_norm=spectral)
    jtree = JD.init_mrd_params(jax.random.key(0), vcfg)
    ttree = discriminator_params_from_jax(jax.tree.map(np.asarray, jtree))
    assert jconv.tree_has_spectral_norm(jtree) is spectral
    assert tconv.tree_has_spectral_norm(ttree) is spectral
