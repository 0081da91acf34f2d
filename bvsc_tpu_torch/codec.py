"""The codec's public API in PyTorch: ``BVRNNCodecModel``.

Port of ``bvsc_tpu/codec.py``: mel frontend -> BVRNN encode scan -> BVRNN
decode -> vocoder.  The vocoder runs one of two paths, chosen once, when the
codec is built, from the config and the arguments (``use_pallas``):

* the kernel path (``use_pallas`` resolved True): the residual stacks go
  through ``ops.amp_resblock``, on a CUDA device a hand-written kernel (K1
  at parity, K1-bf16 in fast serving), the counterpart of the reference's
  ``use_pallas=True``.  It covers the causal log-scale SnakeBeta family with
  three dilations a block; a kernel that fails to build or launch raises;
* the direct path (``use_pallas`` resolved False), the reference's default:
  the whole generator as convs (cuDNN on a card) and elementwise torch
  (``models.vocoder.generator_apply``), any vocoder variant of the config,
  with ``approx_snake`` (the polynomial sin^2) and ``voc_dtype='bf16'``
  (vocoder weights and mel cast to bf16, the waveform back to float32
  before the -10 dB scaling is undone).

Knobs, resolved as the reference resolves them:

* ``precision='highest'``: reference parity, float32 with TF32 off;
* ``precision='default'`` (fast serving): every BVRNN product and the
  vocoder's convs take bf16 operands with float32 sums, ``fused_cell``
  defaults to ``'auto'``; on the direct path ``approx_snake`` and
  ``voc_dtype='bf16'`` default on;
* ``quantize='int8'`` / ``'int8_mixed'``: weight-only int8 BVRNN weights;
* ``dtype``: the storage type, float32 or bf16 (every weight and the
  recurrent state in bf16, the BVRNN and the vocoder computing in bf16 on
  either path, the kernels with bf16 activations in and out; the codes in
  bf16, the waveform in float32);
* ``use_pallas``: True is the kernel path, False the direct one; None (the
  default) is the kernel path where it covers the config and neither
  ``approx_snake=True`` nor a ``voc_dtype`` was asked for, and the direct
  path otherwise.  That None is the port's one departure from the
  reference, whose None is always the direct path.

Lengths are padded up to a multiple of ``hop * length_bucket`` as in the JAX
package, so both packages see the same padded input; the padded frames
carry 0.5 codes.  ``decode(lost=)`` conceals lost packets from the BVRNN's
prior (``models.bvrnn.decode_plc``).  Trained weights load from a flat
``.npz`` (the vocoder's from ``tools/export_vocoder_npz.py``), from the
port trainers' files, or from the reference's PyTorch checkpoints (the
upstream ``{'vrnn': ...}`` ``.pt`` and BigVGAN ``g_`` files).

The device work of ``encode``, ``decode`` (without ``lost``) and
``__call__`` is a function of (:class:`CodecWeights`, inputs):
:func:`_encode_impl`, :func:`_decode_impl`, :func:`_forward_impl` and the
vocoder's :func:`_generator_impl`.  The live methods call them on the
codec's own weights, and ``serve.export`` traces the same functions into a
serving bundle's programs; the host keeps the bookkeeping (length buckets,
the per-frame bits, the squeeze of a missing batch axis).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from bvsc_tpu_torch.config import CodecConfig, VocoderConfig, load_config
from bvsc_tpu_torch.convert import (bvrnn_params_from_torch, load_bvrnn_npz, load_torch_checkpoint,
                                    load_vocoder_npz, to_torch, unflatten_tree,
                                    vocoder_params_from_torch)
from bvsc_tpu_torch.device import resolve_device, set_parity_mode
from bvsc_tpu_torch.models import bvrnn as bvrnn_mod
from bvsc_tpu_torch.models import vocoder as voc_mod
from bvsc_tpu_torch.ops import quant
from bvsc_tpu_torch.ops.amp_resblock import supported
from bvsc_tpu_torch.ops.mel import MelFrontend
from bvsc_tpu_torch.ops.precision import resolve as resolve_precision
from bvsc_tpu_torch.train import checkpoint as ckpt
from bvsc_tpu_torch.train.vocoder_train import generator_from_checkpoint
from bvsc_tpu_torch.utils import tracing

# -10 dB input scaling, undone after the vocoder
SCALING = 10 ** (-10 / 20)

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CONFIG = os.path.join(_REPO_ROOT, "configs", "varbitrate.toml")


def storage_dtype(dtype) -> torch.dtype:
    """``torch.float32`` or ``torch.bfloat16`` from any name of one:
    a torch dtype, a string (``"float32"``, ``"bfloat16"``), or a numpy or
    JAX scalar type (``np.float32``, ``jnp.float32``, ``jnp.bfloat16``),
    read by name, so no JAX import is needed.  Any other type raises
    ValueError: the reference documents these two."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).removeprefix("torch.")
    elif isinstance(dtype, str):
        name = dtype
    else:
        try:
            name = np.dtype(dtype).name
        except TypeError:
            name = getattr(dtype, "__name__", repr(dtype))
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype!r}")
    return getattr(torch, name)


def _host_array(x) -> np.ndarray:
    """A tensor or array-like as a float32 numpy array on the host."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x, np.float32)


def _seeds(seed: int):
    """The BVRNN's and the vocoder's init seeds from the codec's ``seed``."""
    return np.random.SeedSequence(seed).generate_state(2)


def _checkpoint_file(path: str, exporter: str) -> dict:
    """A checkpoint file's contents (``torch.load``, weights only); a
    directory, an Orbax checkpoint, raises ValueError naming ``exporter``."""
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory: bvsc_tpu's Orbax checkpoints need JAX to read "
                         f"(ROADMAP.md, \"Not to port\"); export it to a flat .npz with "
                         f"{exporter} on a host with JAX")
    return load_torch_checkpoint(path)


def load_bvrnn_checkpoint(path: str) -> dict:
    """A BVRNN checkpoint -> the port's BVRNN tree of float32 tensors on the
    host, dispatched as ``bvsc_tpu``'s codec dispatches: a flat ``.npz``
    (``chkpts/``); a port trainer's ``bvrnn_`` file, told apart by its
    ``format`` key (``train/checkpoint.py``); any other file the reference's
    ``{'vrnn': state_dict}`` (or a bare ``state_dict``), through
    :func:`convert.bvrnn_params_from_torch`.  A directory raises ValueError."""
    path = os.fspath(path)
    if path.endswith(".npz"):
        return load_bvrnn_npz(path)
    state = _checkpoint_file(path, "scripts/export_bvrnn_npz.py")
    if "format" in state:
        ckpt.check_kind(state, "bvrnn")
        return to_torch(unflatten_tree(state["params"]))
    return bvrnn_params_from_torch(state.get("vrnn", state))


def load_vocoder_checkpoint(path: str, vcfg: VocoderConfig) -> dict:
    """A vocoder checkpoint -> the port's folded generator tree of float32
    tensors on the host: a flat ``.npz`` (``tools/export_vocoder_npz.py``);
    a port trainer's ``g_`` / ``do_`` file, told apart from an upstream
    ``g_`` file by its ``format`` key and folded with
    ``models.vocoder.fold_generator_params``; any other file the reference's
    BigVGAN ``{'generator': state_dict}`` (or a bare ``state_dict``), through
    :func:`convert.vocoder_params_from_torch` (weight norm folded in
    float64).  A directory raises ValueError."""
    path = os.fspath(path)
    if path.endswith(".npz"):
        return load_vocoder_npz(path)
    state = _checkpoint_file(path, "tools/export_vocoder_npz.py")
    if "format" in state:
        tree = generator_from_checkpoint(state)
        return to_torch(voc_mod.fold_generator_params(tree) if voc_mod.is_weight_normed(tree)
                        else tree)
    return vocoder_params_from_torch(state.get("generator", state), vcfg)


def host_bvrnn_params(conf: CodecConfig, bvrnn_chkpt_path: str | None = None,
                      seed: int = 0) -> dict:
    """The BVRNN weights ``BVRNNCodecModel(config=conf, bvrnn_chkpt_path=,
    seed=)`` loads, on the host: the checkpoint (:func:`load_bvrnn_checkpoint`),
    or without one the random init from ``seed``.  ``entropy.PriorEntropyCoder``
    takes these (or a bf16 codec's own ``bvrnn_params``, widened exactly)."""
    if bvrnn_chkpt_path is None:
        cfg = bvrnn_mod.BVRNNConfig(x_dim=conf.num_mels, h_dim=conf.h_dim, z_dim=conf.z_dim)
        return bvrnn_mod.init_bvrnn_params(_seeds(seed)[0], cfg,
                                           log_sigma_init=conf.log_sigma_init)
    return load_bvrnn_checkpoint(bvrnn_chkpt_path)


def bits_per_frame(conf: CodecConfig, bitrate) -> float | np.ndarray:
    """bps -> bits/frame, half-to-even rounding; a scalar or a per-frame
    array (VBR schedules)."""
    bits = np.round(np.asarray(bitrate, np.float64) * conf.hopsize / conf.fs)
    return float(bits) if bits.ndim == 0 else bits.astype(np.float32)


def frame_bits(conf: CodecConfig, bitrate, batch: int, L: int, n_frames: int, frames: int,
               device) -> torch.Tensor:
    """bps (a scalar, or per frame of the ``n_frames`` of ``L`` samples) ->
    (batch, frames) bits/frame; a per-frame schedule gives the frames from
    ``n_frames`` on 0 bits."""
    bits = bits_per_frame(conf, bitrate)
    if np.ndim(bits):
        expected = (n_frames,) if np.ndim(bits) == 1 else (batch, n_frames)
        if np.shape(bits) != expected:
            raise ValueError(
                f"per-frame bitrate shape {np.shape(bits)} != {expected} "
                f"({n_frames} frames for {L} samples)"
            )
        pad = [(0, 0)] * (np.ndim(bits) - 1) + [(0, frames - n_frames)]
        bits = np.pad(bits, pad)
    bits = torch.as_tensor(bits, dtype=torch.float32, device=device)
    return torch.broadcast_to(bits, (batch, frames))


# the vocoder params the kernel path reads (its residual stacks read the
# packed ResblockParams instead of 'resblocks')
VOCODER_KEYS = ("conv_pre", "ups", "act_post", "conv_post")


@dataclasses.dataclass(frozen=True)
class CodecWeights:
    """Every tensor the codec's programs read, prepared as they read it
    (the mel frontend's constants, the scan's cast weights, the vocoder's
    convs, and on the kernel path the residual stacks' packed kernel
    weights), with the static numerics they were prepared for.

    ``blocks`` is None on the direct path, whose ``vocoder`` is the whole
    folded generator (``models.vocoder.prepare_direct_params``) in
    ``voc_dtype``, run with ``approx_snake``."""

    frontend: MelFrontend
    scan: bvrnn_mod.ScanParams
    vocoder: dict
    blocks: list | None  # per vocoder stage, its ResblockParams; None on the direct path
    bvrnn_cfg: bvrnn_mod.BVRNNConfig
    vocoder_cfg: VocoderConfig
    voc_compute_dtype: torch.dtype
    approx_snake: bool = False
    voc_dtype: torch.dtype = torch.float32  # the direct path's vocoder segment

    @property
    def precision(self) -> str:
        return self.bvrnn_cfg.precision

    @property
    def direct(self) -> bool:
        return self.blocks is None

    def tree(self) -> dict:
        """The tensors alone, as a tree of dicts and lists: what a serving
        bundle stores, the residual stacks' in their mode's packing only."""
        scan = {"std": self.scan.std}
        if self.scan.fused is not None:
            scan["fused"] = self.scan.fused
        tree = {"mel": self.frontend.tensors(), "scan": scan}
        if self.direct:
            return {**tree, "vocoder": self.vocoder}
        return {**tree, "vocoder": {k: self.vocoder[k] for k in VOCODER_KEYS},
                "blocks": [[rb.op_tensors(self.voc_compute_dtype) for rb in stage]
                           for stage in self.blocks]}

    def with_tree(self, tree: dict, traced: bool = False) -> "CodecWeights":
        """These weights with the tensors of ``tree`` (:meth:`tree`'s
        layout) in place of their own; ``traced`` runs the scans' frames
        under torch's scan operator (``models.bvrnn.ScanParams``)."""
        mode = self.voc_compute_dtype
        blocks = None if self.direct else [
            [rb.for_mode(mode, t) for rb, t in zip(stage, ts)]
            for stage, ts in zip(self.blocks, tree["blocks"])]
        return dataclasses.replace(
            self, frontend=self.frontend.with_tensors(tree["mel"]),
            scan=bvrnn_mod.ScanParams(tree["scan"]["std"], tree["scan"].get("fused"), traced),
            vocoder=tree["vocoder"], blocks=blocks)


def _h_init(w: CodecWeights, batch, device) -> torch.Tensor:
    return torch.zeros(batch, w.bvrnn_cfg.h_dim, device=device, dtype=w.bvrnn_cfg.dtype)


def _mel_impl(w: CodecWeights, x: torch.Tensor) -> torch.Tensor:
    """Padded waveform (B, Lp) -> log-mel frames (B, T, M)."""
    return w.frontend(x * SCALING).transpose(1, 2)


def _generator_impl(w: CodecWeights, mel: torch.Tensor, length: int) -> torch.Tensor:
    """Mel (B, M, T) -> the vocoder's float32 waveform (B, length),
    unscaled (the standalone vocoder's output): the residual stacks through
    the kernels, or on the direct path the whole generator in
    ``w.voc_dtype``.  A generator that looks ahead (not
    ``VocoderConfig.causal``) vocodes only the ceil(length / hop) frames
    that cover ``length``, so that its last samples do not depend on the
    length bucket's padding frames; a causal one vocodes all T (its first
    ``length`` samples are the same either way)."""
    if not w.vocoder_cfg.causal:
        mel = mel[..., : -(-length // w.vocoder_cfg.total_upsample)]
    if w.direct:
        return voc_mod.generator_apply(
            w.vocoder, w.vocoder_cfg, mel.to(w.voc_dtype), length, precision=w.precision,
            compute_dtype=w.voc_compute_dtype,
            approx_snake=w.approx_snake)[:, 0, :].to(torch.float32)
    return voc_mod.generator_apply_kernel(
        w.vocoder, w.blocks, w.vocoder_cfg, mel.to(w.voc_dtype), length, precision=w.precision,
        compute_dtype=w.voc_compute_dtype)[:, 0, :].to(torch.float32)


def _encode_impl(w: CodecWeights, x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Padded waveform (B, Lp), bits/frame (B, T) -> codes (B, T, z)."""
    codes, _ = bvrnn_mod.encode_with_state(w.scan, w.bvrnn_cfg, _mel_impl(w, x), bits,
                                           _h_init(w, x.shape[0], x.device))
    return codes


def _decode_impl(w: CodecWeights, codes: torch.Tensor, length: int) -> torch.Tensor:
    """0.5-padded codes (B, T, z) -> waveform (B, length) (``length`` at
    most T x hop)."""
    mel, _ = bvrnn_mod.decode(w.scan, w.bvrnn_cfg, codes, _h_init(w, codes.shape[0], codes.device))
    return _generator_impl(w, mel.transpose(1, 2), length) / SCALING


def _forward_impl(w: CodecWeights, x: torch.Tensor, bits: torch.Tensor, n_frames,
                  length: int) -> torch.Tensor:
    """Resynthesis in one scan: padded waveform (B, Lp), bits (B, T) and the
    count of real frames (an int or a 0-d tensor; the codes of later frames
    are 0.5, as ``decode`` pads them) -> waveform (B, length), ``length`` at
    most Lp (the input's own length; a serving bundle's program, traced at
    one bucket, passes Lp)."""
    mel = _mel_impl(w, x)
    B, T, _ = mel.shape
    valid = (torch.arange(T, device=x.device) < n_frames).to(w.bvrnn_cfg.dtype)
    _, dec_mel, _ = bvrnn_mod.encode_decode(w.scan, w.bvrnn_cfg, mel, bits,
                                            _h_init(w, B, x.device), frame_valid=valid.expand(B, T))
    return _generator_impl(w, dec_mel.transpose(1, 2), length) / SCALING


def resolve_vocoder_path(vcfg: VocoderConfig, fast: bool, use_pallas, approx_snake,
                         voc_dtype) -> tuple[bool, bool, str]:
    """(use_pallas, approx_snake, voc_dtype) as they run, from the
    constructor's arguments (``BVRNNCodecModel``); ``fast`` is
    ``precision='default'``.  Raises the reference's ValueErrors."""
    if voc_dtype not in (None, "f32", "bf16"):
        raise ValueError(f"voc_dtype must be 'f32' or 'bf16', got {voc_dtype!r}")
    if use_pallas is None:
        use_pallas = supported(vcfg) and not approx_snake and voc_dtype is None
    if not use_pallas:
        return (False, fast if approx_snake is None else bool(approx_snake),
                voc_dtype or ("bf16" if fast else "f32"))
    if approx_snake:
        raise ValueError("approx_snake=True is not supported with use_pallas (the kernels "
                         "compute exact snake); drop one")
    if voc_dtype is not None:
        raise ValueError("voc_dtype is not supported with use_pallas (the kernel path's "
                         "compute dtype follows `precision`); drop one")
    if not supported(vcfg):
        raise ValueError(voc_mod.KERNEL_CONFIGS)
    return True, False, "f32"


class BVRNNCodecModel:
    """Bitrate-scalable neural speech codec (API of ``bvsc_tpu``'s model)."""

    def __init__(
        self,
        config_path: str = DEFAULT_CONFIG,
        bvrnn_chkpt_path: str | None = None,
        vocoder_chkpt_path: str | None = None,
        *,
        config: CodecConfig | None = None,
        bvrnn_params: dict | None = None,
        vocoder_params: dict | None = None,
        seed: int = 0,
        length_bucket: int = 64,
        precision: str = "highest",
        device: str | torch.device | None = None,
        quantize: str | None = None,
        fused_cell: bool | str | None = None,
        approx_snake: bool | None = None,
        voc_dtype: str | None = None,
        use_pallas: bool | None = None,
        dtype=torch.float32,
        scan_unroll: int = 1,
    ):
        """``bvrnn_params`` / ``vocoder_params`` are port trees (see
        ``convert``); ``bvrnn_chkpt_path`` and ``vocoder_chkpt_path`` are
        checkpoint files: a flat ``.npz`` (the vocoder's from
        ``tools/export_vocoder_npz.py``), a port trainer's ``bvrnn_`` /
        ``g_`` / ``do_`` file, or the reference's PyTorch file
        (``{'vrnn': state_dict}``, BigVGAN's ``{'generator': state_dict}``)
        (:func:`load_bvrnn_checkpoint`, :func:`load_vocoder_checkpoint`);
        an Orbax directory raises ValueError.  With neither the
        weights are random, from ``seed``.  ``device`` defaults to CUDA
        and raises without a card; pass ``device='cpu'`` for the CPU.

        precision: ``'highest'`` (parity) or anything else, which is the
        fast-serving ``'default'``.  quantize: None, ``'int8'`` or
        ``'int8_mixed'``.  fused_cell: True, False or ``'auto'`` (fused
        below ``models.bvrnn.FUSED_AUTO_MAX_B``); None is ``'auto'`` at
        ``'default'`` without ``quantize`` and False otherwise.
        use_pallas: True runs the residual stacks through the kernels
        (raising ValueError outside the config family they cover, and, as
        the reference's does, for an explicit ``approx_snake=True`` or any
        ``voc_dtype``); False runs the direct path; None (the default) is
        True where the kernels cover the config and neither
        ``approx_snake=True`` nor a ``voc_dtype`` was passed, else False.
        approx_snake (direct path): the polynomial sin^2 in every snake;
        None is on at ``'default'``, off at ``'highest'``.
        voc_dtype (direct path): ``'f32'`` or ``'bf16'``, the vocoder
        segment's type; None is ``'bf16'`` at ``'default'``, ``'f32'`` at
        ``'highest'``.  ``use_pallas``, ``approx_snake`` and ``voc_dtype``
        hold what runs once the codec is built.
        dtype: the storage type of the weights and the recurrent state,
        float32 or bf16, by any name (:func:`storage_dtype`: ``torch.bfloat16``,
        ``jnp.bfloat16``, ``"bfloat16"``, ...); any other raises ValueError.
        Under bf16 every parameter is rounded once to bf16, the BVRNN runs in
        bf16 (``models.bvrnn``), ``encode`` returns bf16 codes and the
        vocoder runs in bf16 on either path: the kernels with bf16
        activations in and out (``ops.amp_resblock``), or the direct path's
        convs and snakes on the bf16 weights.  The waveform comes back in
        float32.
        scan_unroll: the reference's ``lax.scan`` unroll factor, an int
        >= 1; it changes only scheduling there, and nothing in the port."""
        self.dtype = storage_dtype(dtype)
        if int(scan_unroll) != scan_unroll or scan_unroll < 1:
            raise ValueError(f"scan_unroll must be an int >= 1, got {scan_unroll!r}")
        self.precision = resolve_precision(precision)
        fast = self.precision == "default"
        if fused_cell not in (None, True, False, "auto"):
            raise ValueError(f"fused_cell must be True/False/'auto', got {fused_cell!r}")
        if fused_cell is None:
            fused_cell = "auto" if fast and quantize is None else False
        if fused_cell and quantize is not None:
            raise ValueError(
                "fused_cell is not supported with quantize= (int8 dict weights "
                "cannot be re-concatenated); drop one")
        self.fused_cell = fused_cell
        self.device = resolve_device(device)
        self.conf = config if config is not None else load_config(config_path)
        conf = self.conf
        self.use_pallas, self.approx_snake, self.voc_dtype = resolve_vocoder_path(
            conf.vocoder_config, fast, use_pallas, approx_snake, voc_dtype)
        bf16 = self.dtype == torch.bfloat16
        if bf16 and not self.use_pallas:
            self.voc_dtype = "bf16"  # the weights are bf16 whatever the segment's cast
        if not fast:
            set_parity_mode()
        self.length_bucket = length_bucket
        self.bvrnn_cfg = bvrnn_mod.BVRNNConfig(
            x_dim=conf.num_mels, h_dim=conf.h_dim, z_dim=conf.z_dim, var_bit=conf.var_bit,
            precision=self.precision, fused_cell=self.fused_cell, dtype=self.dtype,
        )
        self.frontend = MelFrontend(
            sampling_rate=conf.fs,
            n_fft=conf.winsize,
            num_mels=conf.num_mels,
            hop_size=conf.hopsize,
            fmin=conf.fmin,
            fmax=conf.fmax,
            padding_left=conf.mel_pad_left,
            device=self.device,
        )
        if bvrnn_params is None:
            bvrnn_params = host_bvrnn_params(conf, bvrnn_chkpt_path, seed)
        if vocoder_params is None:
            if vocoder_chkpt_path is None:
                vocoder_params = voc_mod.init_generator_params(_seeds(seed)[1],
                                                               conf.vocoder_config)
            else:
                vocoder_params = load_vocoder_checkpoint(vocoder_chkpt_path,
                                                         conf.vocoder_config)
        self.bvrnn_params = to_torch(bvrnn_params, self.device, dtype=self.dtype)
        if quantize == "int8":
            self.bvrnn_params = quant.quantize_bvrnn_params(self.bvrnn_params)
        elif quantize == "int8_mixed":
            self.bvrnn_params = quant.quantize_bvrnn_params_mixed(self.bvrnn_params)
        elif quantize is not None:
            raise ValueError(f"unknown quantize mode {quantize!r}")
        self.quantize = quantize
        self.voc_compute_dtype = torch.bfloat16 if fast else torch.float32
        # weights cast once to the precision's type (and the fused cell's)
        self.scan_params = bvrnn_mod.prepare(self.bvrnn_params, self.bvrnn_cfg)
        self.vocoder_params = to_torch(vocoder_params, self.device, dtype=self.dtype)
        # the vocoder segment's type: bf16 under bf16 storage on either path
        seg = torch.bfloat16 if bf16 or self.voc_dtype == "bf16" else torch.float32
        if self.use_pallas:
            self.kernel_blocks = voc_mod.prepare_kernel_params(self.vocoder_params,
                                                               conf.vocoder_config)
            voc = self.vocoder_params
        else:
            self.kernel_blocks = None
            voc = voc_mod.prepare_direct_params(self.vocoder_params, conf.vocoder_config, seg)
        self.weights = CodecWeights(
            self.frontend, self.scan_params, voc, self.kernel_blocks, self.bvrnn_cfg,
            conf.vocoder_config, self.voc_compute_dtype, self.approx_snake, seg)

    # -- helpers ------------------------------------------------------------

    def _pad_length(self, length: int) -> int:
        """Round up to the length bucket (a multiple of hop)."""
        bucket = self.conf.hopsize * self.length_bucket
        return int(np.ceil(max(length, 1) / bucket) * bucket)

    def bits_per_frame(self, bitrate) -> float | np.ndarray:
        """bps -> bits/frame, half-to-even rounding; a scalar or a per-frame
        array (VBR schedules)."""
        return bits_per_frame(self.conf, bitrate)

    def _frame_bits(self, bitrate, batch: int, L: int, Lp: int, n_frames: int) -> torch.Tensor:
        """bps (scalar or per-frame) -> (batch, frames of Lp) bits/frame
        (:func:`frame_bits`)."""
        return frame_bits(self.conf, bitrate, batch, L, n_frames, self.frontend.num_frames(Lp),
                          self.device)

    def _as_input(self, x, ndim: int, what: str) -> tuple[torch.Tensor, bool]:
        """To a float32 tensor on the device, promoting a missing batch axis."""
        if not isinstance(x, torch.Tensor):
            x = np.array(x, np.float32)  # a copy: the caller's array may be read-only
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        squeeze = x.dim() == ndim - 1
        if squeeze:
            x = x[None]
        if x.dim() != ndim:
            raise ValueError(f"{what} has shape {tuple(x.shape)}")
        return x, squeeze

    def _mel(self, x: torch.Tensor) -> torch.Tensor:
        """Padded waveform (B, Lp) -> log-mel frames (B, T, M)."""
        return _mel_impl(self.weights, x)

    def _vocode(self, mel: torch.Tensor, length: int) -> torch.Tensor:
        """Mel (B, M, T) -> waveform (B, length) on the codec's vocoder path."""
        return _generator_impl(self.weights, mel, length) / SCALING

    def _h0(self, batch: int) -> torch.Tensor:
        return torch.zeros(batch, self.bvrnn_cfg.h_dim, device=self.device, dtype=self.dtype)

    def _pad_codes(self, codes: torch.Tensor, frames: int) -> torch.Tensor:
        return torch.nn.functional.pad(codes, (0, 0, 0, frames - codes.shape[1]), value=0.5)

    # -- public API ----------------------------------------------------------

    @torch.no_grad()
    def encode(self, x, bitrate) -> torch.Tensor:
        """(batch, length) or (length,) waveform -> codes (batch, frames,
        z_dim) in {0, 0.5, 1}, in the storage dtype.  ``bitrate`` in bits/s, a scalar or a
        per-frame schedule of shape (frames,) or (batch, frames).  On the
        card, each batch size a scan of this codec meets keeps a captured
        graph of its chunks, and that graph's memory, until the codec is
        dropped (``models.bvrnn._ChunkGraph``); so do :meth:`decode`,
        :meth:`decode_to_mel` and ``__call__``."""
        with tracing.span("codec.encode", numbered=True):
            x, squeeze = self._as_input(x, 2, "waveform")
            tracing.count("codec.frames", x.shape[0] * self.frontend.num_frames(x.shape[1]))
            codes = self._encode(x, bitrate)
            return codes[0] if squeeze else codes

    def _encode(self, x: torch.Tensor, bitrate) -> torch.Tensor:
        """:meth:`encode` of a (batch, length) waveform on the device."""
        L = x.shape[1]
        Lp = self._pad_length(L)
        x = torch.nn.functional.pad(x, (0, Lp - L))
        n_frames = self.frontend.num_frames(L)
        bits = self._frame_bits(bitrate, x.shape[0], L, Lp, n_frames)
        return _encode_impl(self.weights, x, bits)[:, :n_frames]

    @torch.no_grad()
    def decode(self, codes, length: int, *, lost=None, conceal_bitrate=None,
               conceal_mode: str = "expect") -> torch.Tensor:
        """(batch, frames, z_dim) or (frames, z_dim) codes -> waveform
        (batch, length).

        Packet-loss concealment: ``lost``, (frames,) or (batch, frames) of
        0/1, flags frames whose codes were not received; they are decoded
        from the BVRNN's prior (``models.bvrnn.decode_plc``).
        ``conceal_mode`` is ``'expect'`` (the prior's probabilities) or
        ``'map'`` (rounded).  ``conceal_bitrate``, bps as a scalar or per
        frame like ``encode``'s, masks concealed frames to the stream's
        allocation; None uses all ``z_dim`` bits.  With ``lost=None`` the
        other two are ignored."""
        with tracing.span("codec.decode", numbered=True):
            codes, squeeze = self._as_input(codes, 3, "codes")
            tracing.count("codec.frames", codes.shape[0] * codes.shape[1])
            y = self._decode(codes, length, lost, conceal_bitrate, conceal_mode)
            return y[0] if squeeze else y

    def _decode(self, codes: torch.Tensor, length: int, lost=None, conceal_bitrate=None,
                conceal_mode: str = "expect") -> torch.Tensor:
        """:meth:`decode` of (batch, frames, z_dim) codes on the device."""
        B, T = codes.shape[:2]
        hop = self.conf.hopsize
        padded_len = self._pad_length(max(T * hop, length))
        Tp = padded_len // hop
        codes = self._pad_codes(codes, Tp)
        if lost is None:
            return _decode_impl(self.weights, codes, length)
        lost = _host_array(lost)
        if lost.ndim == 1:
            lost = lost[None, :]
        if lost.shape != (B, T):
            raise ValueError(f"lost mask shape {lost.shape} != ({B}, {T})")
        lost = np.pad(lost, ((0, 0), (0, Tp - T)))  # padding frames: received
        cbits = None
        if conceal_bitrate is not None:
            cb = np.broadcast_to(np.asarray(self.bits_per_frame(conceal_bitrate), np.float32),
                                 (B, T))
            cbits = torch.as_tensor(np.pad(cb, ((0, 0), (0, Tp - T))), device=self.device)
        mel, _ = bvrnn_mod.decode_plc(
            self.scan_params, self.bvrnn_cfg, codes, torch.as_tensor(lost, device=self.device),
            self._h0(B), cbits, mode=conceal_mode,
        )
        return self._vocode(mel.transpose(1, 2), length)

    @torch.no_grad()
    def decode_to_mel(self, codes) -> torch.Tensor:
        """Codes -> decoded log-mel (batch, num_mels, frames), the mel the
        vocoder consumes."""
        codes, squeeze = self._as_input(codes, 3, "codes")
        T = codes.shape[1]
        Tp = self._pad_length(T * self.conf.hopsize) // self.conf.hopsize
        mel, _ = bvrnn_mod.decode(
            self.scan_params, self.bvrnn_cfg, self._pad_codes(codes, Tp),
            self._h0(codes.shape[0]),
        )
        mel = mel.transpose(1, 2)[..., :T]
        return mel[0] if squeeze else mel

    @torch.no_grad()
    def __call__(self, x, bitrate, *, fused: bool = True) -> torch.Tensor:
        """Resynthesis: encode and decode.  ``fused`` runs the one-scan path
        (the encoder's closed loop already yields the decoded mel); with
        ``fused=False`` it is ``decode(encode(x))``.  Each batch size keeps
        a captured graph and its memory on the card, as :meth:`encode`
        says."""
        with tracing.span("codec.call", numbered=True):
            x, squeeze = self._as_input(x, 2, "waveform")
            length = x.shape[1]
            n_frames = self.frontend.num_frames(length)
            tracing.count("codec.frames", x.shape[0] * n_frames)
            if fused:
                Lp = self._pad_length(length)
                x = torch.nn.functional.pad(x, (0, Lp - length))
                bits = self._frame_bits(bitrate, x.shape[0], length, Lp, n_frames)
                y = _forward_impl(self.weights, x, bits, n_frames, length)
            else:
                y = self._decode(self._encode(x, bitrate), length)
            return y[0] if squeeze else y

    forward = __call__
