"""Pipeline parallelism: the codec's two stages over a ``pipe`` axis, GPipe
style (port of ``bvsc_tpu/parallel/pp.py``).

  stage 0  mel -> the BVRNN's ``encode_decode`` scan -> (codes, decoded mel)
  stage 1  decoded mel -> the causal generator (K1 / K1-bf16 on a card, or
           the direct path, as ``models.vocoder.resolve_vocoder_path``
           picks)

With microbatches flowing through, stage 0's scan of microbatch t runs
beside stage 1's vocoder pass of microbatch t - 1.  The schedule is the
reference's: ``n_micro + 1`` steps, stage s working on microbatch t - s at
step t; at the start of each step stage 0 hands the decoded mel of the
previous one to stage 1 (a ``broadcast`` over the pipe axis,
``parallel.collectives``).  At the end, stage 0's codes and stage 1's
waveforms go to every rank.

SPMD: every rank passes the same inputs and gets the same outputs.  On a
2-D (data x pipe) mesh each microbatch's streams are also split over
``data`` and each stage is replicated along it.
"""

from __future__ import annotations

import torch

from bvsc_tpu_torch.config import VocoderConfig
from bvsc_tpu_torch.convert import to_torch
from bvsc_tpu_torch.models import bvrnn as B
from bvsc_tpu_torch.models.vocoder import _apply, prepare_vocoder, resolve_vocoder_path
from bvsc_tpu_torch.parallel.collectives import all_gather, broadcast
from bvsc_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, make_2d_mesh, make_mesh, row_blocks

PIPE_AXIS = "pipe"
N_STAGES = 2


def make_pp_mesh(devices=None, axis_name: str = PIPE_AXIS) -> Mesh:
    """A mesh of two devices, one a stage."""
    return make_mesh(N_STAGES, devices, axis_name)


def make_dp_pp_mesh(n_data: int, devices=None, data_axis: str = DATA_AXIS,
                    pipe_axis: str = PIPE_AXIS) -> Mesh:
    """2-D mesh: each stage replicated ``n_data`` ways, every microbatch's
    streams split over ``data``."""
    return make_2d_mesh(n_data, N_STAGES, (data_axis, pipe_axis), devices)


@torch.no_grad()
def pipeline_resynth(bvrnn_params, bcfg: B.BVRNNConfig, voc_params, vcfg: VocoderConfig,
                     mel_mb, bits_mb, mesh: Mesh, *, axis_name: str = PIPE_AXIS,
                     precision: str = "highest",
                     compute_dtype: torch.dtype = torch.float32,
                     approx_snake: bool = False, use_pallas: bool | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Microbatched, pipelined resynthesis.

    mel_mb:  (n_micro, M, T, x_dim) log-mels in the model's domain;
    bits_mb: (n_micro, M, T) bits/frame, or None for ``var_bit=False``;
    mesh:    a mesh with a ``axis_name`` axis of 2 (:func:`make_pp_mesh`).

    Returns (codes (n_micro, M, T, z_dim), wav (n_micro, M, 1, T * up)) on
    every rank: each microbatch's ``encode_decode`` from a zero state and
    ``generator_apply_kernel`` of its decoded mel.  Vocoder params are
    folded inference convs; ``precision`` / ``compute_dtype`` as there.
    ``use_pallas`` and ``approx_snake`` pick stage 1's path as the codec's
    do (``models.vocoder.resolve_vocoder_path``): the direct path
    (``models.vocoder.generator_apply``, ``approx_snake`` the polynomial
    sin^2) where the kernels do not run.  ``bcfg.dtype`` is the storage
    type of both models: under bf16 both run in bf16 (the codes come back
    bf16, the waveform float32)."""
    use_pallas, approx_snake, _ = resolve_vocoder_path(vcfg, False, use_pallas, approx_snake,
                                                       None)
    ax, dax = mesh.axis(axis_name), mesh.axis(DATA_AXIS)
    if ax.size != N_STAGES:
        raise ValueError(f"pipeline mesh axis '{axis_name}' must have size {N_STAGES}, "
                         f"got {ax.size}")
    mel_mb = torch.as_tensor(mel_mb).to(mesh.device, torch.float32)
    n_micro, m_sz, frames, x_dim = mel_mb.shape
    if x_dim != bcfg.x_dim:
        raise ValueError(f"mel feature dim {x_dim} != BVRNNConfig.x_dim {bcfg.x_dim}")
    if bits_mb is None:
        if bcfg.var_bit:
            raise ValueError("bits_mb required for a var_bit BVRNN")
        bits_mb = torch.zeros(n_micro, m_sz, frames)
    if m_sz % dax.size:
        raise ValueError(f"microbatch streams {m_sz} not divisible by data axis {dax.size}")
    rows = row_blocks(m_sz, dax.size)[dax.index]
    mel_mb = mel_mb[:, rows]
    bits_mb = torch.as_tensor(bits_mb).to(mesh.device, torch.float32)[:, rows]
    m_loc, up, dev = mel_mb.shape[1], vcfg.total_upsample, mesh.device
    stage = ax.index
    if stage == 0:
        bparams = B.prepare(to_torch(bvrnn_params, dev), bcfg)
    else:
        voc = prepare_vocoder(to_torch(voc_params, dev, dtype=bcfg.dtype), vcfg, use_pallas,
                              compute_dtype, approx_snake)
    payload = torch.zeros(m_loc, frames, x_dim, device=dev, dtype=bcfg.dtype)
    codes = torch.zeros(n_micro, m_loc, frames, bcfg.z_dim, device=dev, dtype=bcfg.dtype)
    wav = torch.zeros(n_micro, m_loc, 1, frames * up, device=dev)
    for t in range(n_micro + N_STAGES - 1):
        recv = broadcast(payload, ax, 0)  # stage 0's output of step t - 1
        if stage == 0 and t < n_micro:
            codes[t], payload, _ = B.encode_decode(
                bparams, bcfg, mel_mb[t], bits_mb[t] if bcfg.var_bit else None,
                torch.zeros(m_loc, bcfg.h_dim, device=dev, dtype=bcfg.dtype))
        elif stage == 1 and t >= 1:
            wav[t - 1] = _apply(voc, recv.transpose(1, 2).contiguous(), frames * up, precision)
    codes, wav = broadcast(codes, ax, 0), broadcast(wav, ax, 1)
    return all_gather(codes, dax, 1), all_gather(wav, dax, 1)
