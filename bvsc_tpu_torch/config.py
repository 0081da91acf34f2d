"""Codec configuration for the PyTorch port.

A copy of ``bvsc_tpu/config.py`` (the port imports nothing of ``bvsc_tpu``):
the same flat-TOML schema, the same dataclasses and defaults, parsed with
stdlib :mod:`tomllib`.  Field names and defaults must stay in step with the
JAX package so that one TOML file configures both.
"""

from __future__ import annotations

import dataclasses
import tomllib
from typing import Any, Sequence


@dataclasses.dataclass(frozen=True)
class VocoderConfig:
    """BigVGAN generator/discriminator config.  The defaults are the
    codec's causal BigVGAN-tiny (4 stages, 128 -> 8 channels); the same
    fields describe the published non-causal BigVGAN
    (``configs/varbitrate_bigvgan.toml``: 6 stages, 1536 -> 24 channels,
    symmetric padding, anti-aliased activations).

    Field names match the keys of the reference's ``vocoder_config.*`` TOML
    table / BigVGAN ``AttrDict`` (reference ``third_party/BigVGAN/env.py:8-11``,
    ``configs/config_varBitRate.toml:39-61``).
    """

    num_mels: int = 80
    resblock: str = "1"
    upsample_rates: tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial_channel: int = 128
    resblock_kernel_sizes: tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: tuple[tuple[int, ...], ...] = (
        (1, 3, 5),
        (1, 3, 5),
        (1, 3, 5),
    )
    # Causality switches: True => symmetric (non-causal) padding.
    pre_sym: bool = False
    post_sym: bool = False
    layers_sym: tuple[bool, ...] = (False, False, False, False)
    # Alias-free (kaiser-sinc 2x up/down around activations).  Disabled in all
    # shipped configs because anti-aliasing would break causality
    # (reference ``configs/config_varBitRate.toml:51-52``).
    layers_antialias: tuple[bool, ...] = (False, False, False, False)
    antialias_post: bool = False
    activation: str = "snakebeta"
    snake_logscale: bool = True
    # Discriminator config (GAN training only).
    resolutions: tuple[tuple[int, int, int], ...] = (
        (1024, 120, 600),
        (2048, 240, 1200),
        (512, 50, 240),
    )
    mpd_reshapes: tuple[int, ...] = (2, 3, 5, 7, 11)
    use_spectral_norm: bool = False
    discriminator_channel_mult: float = 1
    # optional MRD-specific overrides (reference models.py:329-337)
    mrd_use_spectral_norm: bool | None = None
    mrd_channel_mult: float | None = None

    @property
    def causal(self) -> bool:
        """Whether no output sample depends on a later frame: every padding
        left-only and no anti-aliased activation."""
        return not (self.pre_sym or self.post_sym or any(self.layers_sym)
                    or any(self.layers_antialias) or self.antialias_post)

    @property
    def total_upsample(self) -> int:
        r = 1
        for u in self.upsample_rates:
            r *= u
        return r

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "VocoderConfig":
        return cls(**_coerce_fields(cls, d))


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Full codec configuration (BVRNN + DSP frontend + trainer keys).

    Mirrors the flat keys of the reference TOMLs
    (``configs/config_varBitRate.toml:1-38``).  Trainer keys are retained so
    the (unpublished upstream) BVRNN trainer can be re-created from them.
    """

    # --- DSP / frontend ---
    fs: int = 22050
    winsize: int = 1024
    hopsize: int = 256
    num_mels: int = 80
    fmin: float = 0.0
    fmax: float = 8000.0
    mel_pad_left: int = 256

    # --- BVRNN ---
    h_dim: int = 1024
    z_dim: int = 64
    log_sigma_init: float = -1.0
    var_bit: bool = True

    # --- trainer (reference TOML keys; trainer itself unpublished upstream) ---
    train_name: str = "bvsc_tpu"
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    batch_size: int = 32
    learning_rate: float = 2e-4
    lr_decay: float = 0.99999306855
    scheduler_max_steps: int = 200000
    grad_clip: float = 130.0
    max_steps: int = 200000
    val_interval: int = 10000
    distinct_chkpt_interval: int = 10000
    num_workers: int = 8
    teacher_force_step_1perc: int = 30000
    p_bitratechange: float = 0.3
    train_seq_duration: float = 4.0
    validate_only: bool = False
    resume: bool = False
    vocoder_checkpoint: str = ""

    # --- nested vocoder config ---
    vocoder_config: VocoderConfig = dataclasses.field(default_factory=VocoderConfig)

    @property
    def frames_per_second(self) -> float:
        return self.fs / self.hopsize

    def bits_per_frame(self, bitrate_bps: float) -> int:
        """bps -> bits/frame, reference ``bvrnn_codec_model.py:58-59``."""
        import numpy as np

        return int(np.round(bitrate_bps * self.hopsize / self.fs))

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "CodecConfig":
        d = dict(d)
        voc = d.pop("vocoder_config", None)
        fields = _coerce_fields(cls, d)
        if voc is not None:
            fields["vocoder_config"] = VocoderConfig.from_dict(voc)
        return cls(**fields)

    @classmethod
    def from_toml(cls, path: str) -> "CodecConfig":
        with open(path, "rb") as f:
            return cls.from_dict(tomllib.load(f))


def _coerce_fields(cls, d: dict[str, Any]) -> dict[str, Any]:
    """Keep only known fields; coerce lists to (nested) tuples."""
    known = {f.name for f in dataclasses.fields(cls)}
    out = {}
    for k, v in d.items():
        if k not in known:
            continue  # ignore unknown keys so extended configs still load
        out[k] = _to_tuple(v)
    return out


def _to_tuple(v: Any) -> Any:
    if isinstance(v, (list, tuple)):
        return tuple(_to_tuple(x) for x in v)
    return v


def load_config(path: str) -> CodecConfig:
    return CodecConfig.from_toml(path)


def load_vocoder_json(path: str) -> VocoderConfig:
    """Load a standalone vocoder JSON config (reference ``env.py:8-11`` +
    ``train.py:424-425`` style), e.g. ``bigvgan_base_22khz_80band.json``."""
    import json

    with open(path) as f:
        return VocoderConfig.from_dict(json.load(f))
