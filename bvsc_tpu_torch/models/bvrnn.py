"""Bernoulli-valued variational RNN (BVRNN), standard cell, in PyTorch.

Port of the inference half of ``bvsc_tpu/models/bvrnn.py`` (init, the MLP
nets, the GRU step, the bit mask, ``encode``, ``encode_with_state``,
``encode_decode`` and ``decode``).  Parameters are a nested dict of tensors
with the JAX package's keys and layouts: linear weights are stored
(in, out) and applied as ``x @ w``; the GRU gates are packed [r|z|n].

The frame recurrence is a Python loop; each step is a handful of
``torch.matmul`` calls, as the JAX package leaves these GEMMs to XLA.

Closed-loop state sync: encode and decode advance the GRU only with
*generated* features, so both sides' hidden states follow the codes alone.
``decode`` therefore computes phi_z per step, in the same (B, z) shape as
the encoder, never hoisted over the sequence.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

Params = dict


@dataclasses.dataclass(frozen=True)
class BVRNNConfig:
    x_dim: int = 80
    h_dim: int = 1024
    z_dim: int = 64
    var_bit: bool = True


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------


def _dense_init(rng: np.random.Generator, fan_in: int, fan_out: int) -> dict:
    """torch.nn.Linear default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / np.sqrt(fan_in)
    return {
        "w": rng.uniform(-bound, bound, (fan_in, fan_out)).astype(np.float32),
        "b": rng.uniform(-bound, bound, (fan_out,)).astype(np.float32),
    }


def _mlp_init(rng, dims):
    return [_dense_init(rng, dims[i], dims[i + 1]) for i in range(len(dims) - 1)]


def init_bvrnn_params(
    seed: int,
    cfg: BVRNNConfig,
    mean_std_mel: tuple[np.ndarray, np.ndarray] | None = None,
    log_sigma_init: float = -1.0,
) -> Params:
    """Fresh parameters from a numpy seed, as a tree of numpy arrays (the
    layer shapes of ``bvsc_tpu.models.bvrnn.init_bvrnn_params``)."""
    rng = np.random.default_rng(seed)
    x, h, z = cfg.x_dim, cfg.h_dim, cfg.z_dim
    if mean_std_mel is None:
        mean_std_mel = (np.zeros(x), np.ones(x))
    bound = 1.0 / np.sqrt(h)
    return {
        "mean_mel": np.asarray(mean_std_mel[0], np.float32),
        "std_mel": np.asarray(mean_std_mel[1], np.float32),
        "log_sigma": np.asarray([log_sigma_init], np.float32),
        "phi_x": _mlp_init(rng, [x, h, h, h]),
        "phi_z": _mlp_init(rng, [z, h, h, h]),
        "enc": _mlp_init(rng, [2 * h, h, h, z]),
        "prior": _mlp_init(rng, [h, h, h, z]),
        "dec": _mlp_init(rng, [2 * h, h, h, h, x]),
        "gru": {
            "w_ih": rng.uniform(-bound, bound, (2 * h, 3 * h)).astype(np.float32),
            "w_hh": rng.uniform(-bound, bound, (h, 3 * h)).astype(np.float32),
            "b_ih": rng.uniform(-bound, bound, (3 * h,)).astype(np.float32),
            "b_hh": rng.uniform(-bound, bound, (3 * h,)).astype(np.float32),
        },
    }


# ---------------------------------------------------------------------------
# Functional pieces
# ---------------------------------------------------------------------------


def _dense(p, x):
    return torch.matmul(x, p["w"]) + p["b"]


def _mlp_elu(layers, x, final_activation=None):
    """Linear+ELU stack; the last layer gets ``final_activation``."""
    for p in layers[:-1]:
        x = F.elu(_dense(p, x))
    x = _dense(layers[-1], x)
    return x if final_activation is None else final_activation(x)


def phi_x_apply(params, y):
    return _mlp_elu(params["phi_x"], y, F.elu)


def phi_z_apply(params, z):
    return _mlp_elu(params["phi_z"], z, F.elu)


def enc_apply(params, x):
    return _mlp_elu(params["enc"], x, torch.sigmoid)


def dec_apply(params, x):
    return _mlp_elu(params["dec"], x)


def gru_step(gru: Params, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One torch-semantics GRU step, gates packed [r|z|n]:
    n = tanh(W_in x + b_in + r * (W_hn h + b_hn))."""
    gi = torch.matmul(x, gru["w_ih"]) + gru["b_ih"]
    gh = torch.matmul(h, gru["w_hh"]) + gru["b_hh"]
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def bit_mask_from_bitrate(var_bitrate: torch.Tensor, z_dim: int) -> torch.Tensor:
    """First-k bit-priority mask: (B, T) bits/frame -> (B, T, z_dim) float."""
    bit_idx = torch.arange(z_dim, device=var_bitrate.device)
    return (var_bitrate[..., None] > bit_idx).to(torch.float32)


def _apply_bit_mask(z, mask):
    """Masked-out bits take the uninformative midpoint 0.5."""
    return z * mask + 0.5 * (1.0 - mask)


def _normalize(params, y):
    return (y - params["mean_mel"]) / params["std_mel"]


def _advance(params, z_t, h):
    """Decoder half of a step: codes -> (decoded frame, next h)."""
    phi_z_t = phi_z_apply(params, z_t)
    dec_t = dec_apply(params, torch.cat([phi_z_t, h], -1))
    phi_x_gen = phi_x_apply(params, _normalize(params, dec_t))
    h_next = gru_step(params["gru"], torch.cat([phi_x_gen, phi_z_t], -1), h)
    return dec_t, h_next


def _scan(params, cfg, y, var_bitrate, h, frame_valid=None):
    """The greedy encode scan.  Returns per-frame lists of codes, decoded
    frames and the state before each frame, and the final state."""
    phi_x = phi_x_apply(params, _normalize(params, y))  # (B, T, h), hoisted
    if cfg.var_bit:
        if var_bitrate is None:
            raise ValueError("var_bit config needs a bitrate")
        mask = bit_mask_from_bitrate(var_bitrate, cfg.z_dim)
    else:
        mask = torch.ones(y.shape[0], y.shape[1], cfg.z_dim, device=y.device)
    if frame_valid is not None:
        mask = mask * frame_valid.to(mask.dtype)[:, :, None]
    zs, decs, hs = [], [], []
    for t in range(y.shape[1]):
        enc_t = enc_apply(params, torch.cat([phi_x[:, t], h], -1))
        z_t = _apply_bit_mask(torch.round(enc_t), mask[:, t])
        hs.append(h)
        dec_t, h = _advance(params, z_t, h)
        zs.append(z_t)
        decs.append(dec_t)
    return zs, decs, hs, h


def encode(params, cfg, y, var_bitrate, h):
    """Greedy encode.  y: (B, T, x_dim); var_bitrate: (B, T) or None;
    h: (B, h_dim).  Returns (codes (B, T, z), h_seq (B, T, h)) where
    ``h_seq[:, t]`` is the state before frame t."""
    zs, _, hs, _ = _scan(params, cfg, y, var_bitrate, h)
    return torch.stack(zs, 1), torch.stack(hs, 1)


def encode_with_state(params, cfg, y, var_bitrate, h):
    """Like :func:`encode` but returns the final hidden state."""
    zs, _, _, h_final = _scan(params, cfg, y, var_bitrate, h)
    return torch.stack(zs, 1), h_final


def encode_decode(params, cfg, y, var_bitrate, h, frame_valid=None):
    """Encode and decode in one scan: (codes, decoded mel, final h).

    The encoder's closed loop already computes ``decode``'s output for the
    emitted codes.  ``frame_valid`` (B, T) forces the codes of invalid
    frames to 0.5 inside the scan, as ``decode`` sees 0.5-padded codes.
    """
    zs, decs, _, h_final = _scan(params, cfg, y, var_bitrate, h, frame_valid)
    return torch.stack(zs, 1), torch.stack(decs, 1), h_final


def decode(params, cfg, z, h):
    """Codes (B, T, z_dim) -> (mel (B, T, x_dim), final h); phi_z per step."""
    decs = []
    for t in range(z.shape[1]):
        dec_t, h = _advance(params, z[:, t], h)
        decs.append(dec_t)
    return torch.stack(decs, 1), h
