"""Vocoder GAN trainer (port of ``bvsc_tpu/train/vocoder_train.py``; the
reference's ``third_party/BigVGAN/train.py:253-314`` step).

A step on a batch of ground-truth audio ``y``:

* the input mel of ``y`` (``MelFrontend`` at ``fmax``; in fine-tuning a
  BVRNN-decoded mel instead) and its loss-band mel (``fmax_for_loss``, by
  default sr / 2), both cropped to ``segment // hop`` frames;
* D step: one power iteration of every spectral-norm buffer pair, then the
  LSGAN loss of MPD + MRD on (y, y_hat) with the generator's output taken
  without gradient; clip and AdamW, skipped while ``step < freeze_step``
  (the buffers move all the same);
* G step, against the updated discriminators: 45 x the L1 loss-band mel
  error plus feature matching and the adversarial loss, or the mel loss
  alone while D is frozen; clip and AdamW.

Both optimizers are optax's clip-then-AdamW (``train.optim``, weight decay
0.01) with the spectral-norm buffers outside them; the learning rate is
``learning_rate * lr_decay ** epoch`` (:meth:`VocoderGANTrainer.set_epoch`).
The generator trains on weight-normed ``{g, v, b}`` convs through the plain
PyTorch generator (``models.vocoder.generator_apply``), as the JAX
trainers differentiate the plain JAX one: the residual-block kernel has no
backward there either.  The JAX package's ``split_programs`` form (the same
step cut into a dozen XLA programs for a TPU compile helper's memory cap)
is not ported.

Data parallelism (``mesh=``, an SPMD ``parallel.mesh.Mesh``): each rank
steps on its rows of the global batch; each update's gradients (D's, then
G's) are averaged over the ranks by one flattened all-reduce before the
clip, and the metrics likewise.  The spectral-norm buffers' power
iteration reads no data, so they stay equal on every rank, as the
parameters do.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bvsc_tpu_torch.config import VocoderConfig
from bvsc_tpu_torch.convert import flatten_tree, to_torch, unflatten_tree
from bvsc_tpu_torch.device import set_parity_mode
from bvsc_tpu_torch.models import vocoder as voc_mod
from bvsc_tpu_torch.models.discriminators import (init_mpd_params, init_mrd_params, mpd_apply,
                                                   mrd_apply)
from bvsc_tpu_torch.models.losses import discriminator_loss, feature_loss, generator_loss
from bvsc_tpu_torch.ops.conv import spectral_norm_power_iteration, spectral_norm_trainable_mask
from bvsc_tpu_torch.ops.mel import MelFrontend
from bvsc_tpu_torch.parallel.collectives import all_mean
from bvsc_tpu_torch.train.bvrnn_train import data_axis
from bvsc_tpu_torch.train.checkpoint import FORMAT, check_kind
from bvsc_tpu_torch.train.optim import ClippedAdam


@dataclasses.dataclass(frozen=True)
class GANTrainConfig:
    """Hyperparameters of the reference vocoder trainer
    (``bigvgan_base_22khz_80band.json`` and ``train.py``'s defaults)."""

    learning_rate: float = 1e-4
    adam_b1: float = 0.8
    adam_b2: float = 0.99
    lr_decay: float = 0.999  # per epoch
    grad_clip: float = 1000.0
    mel_loss_weight: float = 45.0
    freeze_step: int = 0
    segment_size: int = 8192
    batch_size: int = 32
    sampling_rate: int = 22050
    n_fft: int = 1024
    hop_size: int = 256
    win_size: int = 1024
    fmin: float = 0.0
    fmax: float = 8000.0
    fmax_for_loss: float | None = None  # None: the full band, sr / 2
    mel_pad_left: int = 256
    # recompute each AMP block in the generator's backward pass (the same
    # values and gradients, less memory held)
    remat: bool = True


def _frontend(tcfg: GANTrainConfig, num_mels: int, fmax: float, device) -> MelFrontend:
    return MelFrontend(sampling_rate=tcfg.sampling_rate, n_fft=tcfg.n_fft, num_mels=num_mels,
                       hop_size=tcfg.hop_size, fmin=tcfg.fmin, fmax=fmax,
                       padding_left=tcfg.mel_pad_left, device=device)


class _Leaves:
    """A tree's leaves by flat name, as tensors that take gradients (the
    spectral-norm buffers do not)."""

    def __init__(self, tree: dict):
        flat = flatten_tree(tree)
        mask = flatten_tree(spectral_norm_trainable_mask(tree))
        self.names = [n for n in flat if mask[n]]
        self.tensors = [flat[n] for n in self.names]
        for t in self.tensors:
            t.requires_grad_(True)


class VocoderGANTrainer:
    """The GAN trainer (``bvsc_tpu``'s ``VocoderGANTrainer``), on one device
    or data-parallel over a mesh (module docstring)."""

    def __init__(self, vcfg: VocoderConfig, tcfg: GANTrainConfig = GANTrainConfig(),
                 seed: int = 0, gen_params: dict | None = None, mpd_params: list | None = None,
                 mrd_params: list | None = None, device: str | torch.device | None = None,
                 mesh=None):
        """``gen_params``: a weight-normed generator tree (folded trees are
        re-parametrised, ``models.vocoder.unfold_generator_params``);
        ``mpd_params`` / ``mrd_params``: discriminator trees.  Whatever is
        not given is initialised from ``seed``.  ``device`` defaults to
        CUDA, or with ``mesh`` to this rank's device of it.  Float32
        products throughout: the trainer turns TF32 off
        (``device.set_parity_mode``, process-wide)."""
        self.device, self.dp = data_axis(mesh, device)
        set_parity_mode()
        self.vcfg, self.tcfg = vcfg, tcfg
        self.epoch = 0
        self.step_count = 0
        s_gen, s_mpd, s_mrd = np.random.SeedSequence(seed).generate_state(3)
        if gen_params is None:
            gen_params = voc_mod.init_generator_params(int(s_gen), vcfg, weight_norm=True)
        gen = to_torch(gen_params, self.device, copy=True)
        self.gen = gen if voc_mod.is_weight_normed(gen) else voc_mod.unfold_generator_params(gen)
        self.mpd = to_torch(mpd_params if mpd_params is not None
                            else init_mpd_params(np.random.default_rng(s_mpd), vcfg),
                            self.device, copy=True)
        self.mrd = to_torch(mrd_params if mrd_params is not None
                            else init_mrd_params(np.random.default_rng(s_mrd), vcfg),
                            self.device, copy=True)
        self._g = _Leaves(self.gen)
        self._d = _Leaves({"mpd": self.mpd, "mrd": self.mrd})
        opt = dict(lr=tcfg.learning_rate, b1=tcfg.adam_b1, b2=tcfg.adam_b2,
                   max_norm=tcfg.grad_clip, weight_decay=0.01)
        self.opt_g = ClippedAdam(self._g.tensors, **opt)
        self.opt_d = ClippedAdam(self._d.tensors, **opt)
        self.input_frontend = _frontend(tcfg, vcfg.num_mels, tcfg.fmax, self.device)
        self.loss_frontend = _frontend(
            tcfg, vcfg.num_mels,
            tcfg.fmax_for_loss if tcfg.fmax_for_loss is not None else tcfg.sampling_rate / 2,
            self.device)

    def set_epoch(self, epoch: int) -> None:
        """The per-epoch learning rate, ``learning_rate * lr_decay ** epoch``."""
        self.epoch = epoch
        lr = self.tcfg.learning_rate * (self.tcfg.lr_decay ** epoch)
        self.opt_g.lr = self.opt_d.lr = lr

    @property
    def frozen(self) -> bool:
        return self.step_count < self.tcfg.freeze_step

    def d_step(self, mel_in: torch.Tensor, y: torch.Tensor) -> dict:
        """Discriminator update on (y, y_hat), y_hat without gradient."""
        with torch.no_grad():
            y_hat = voc_mod.generator_apply(self.gen, self.vcfg, mel_in, y.shape[-1])
            self.mpd = spectral_norm_power_iteration(self.mpd)
            self.mrd = spectral_norm_power_iteration(self.mrd)
        y_df_r, y_df_g, _, _ = mpd_apply(self.mpd, self.vcfg, y, y_hat)
        loss_f, _, _ = discriminator_loss(y_df_r, y_df_g)
        y_ds_r, y_ds_g, _, _ = mrd_apply(self.mrd, self.vcfg, y, y_hat)
        loss_s, _, _ = discriminator_loss(y_ds_r, y_ds_g)
        grads = self._mean(torch.autograd.grad(loss_f + loss_s, self._d.tensors,
                                               allow_unused=True), self._d.tensors)
        metrics = self._mean_metrics({"disc_loss_mpd": loss_f, "disc_loss_mrd": loss_s})
        if self.frozen:
            norm = ClippedAdam.global_norm(grads)
        else:
            norm = self.opt_d.step(grads)
        return {**metrics, "grad_norm_d": norm}

    def _mean(self, grads, params) -> list:
        """The gradients (None as zeros) averaged over the data-parallel
        ranks; as they are on one device."""
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        return grads if self.dp is None else all_mean(grads, self.dp)

    def _mean_metrics(self, metrics: dict) -> dict:
        metrics = {k: v.detach() for k, v in metrics.items()}
        if self.dp is None:
            return metrics
        return dict(zip(metrics, all_mean(list(metrics.values()), self.dp)))

    def g_step(self, mel_in: torch.Tensor, y: torch.Tensor, y_mel: torch.Tensor) -> dict:
        """Generator update against the current discriminators; the mel
        loss alone while D is frozen."""
        frozen = self.frozen
        w = self.tcfg.mel_loss_weight
        y_hat = voc_mod.generator_apply(self.gen, self.vcfg, mel_in, y.shape[-1],
                                        remat=self.tcfg.remat)
        loss_mel = torch.mean(torch.abs(y_mel - self.loss_frontend(y_hat[:, 0]))) * w
        with torch.set_grad_enabled(not frozen):
            _, y_df_g, fmap_f_r, fmap_f_g = mpd_apply(self.mpd, self.vcfg, y, y_hat)
            loss_fm_f = feature_loss(fmap_f_r, fmap_f_g)
            loss_gen_f, _ = generator_loss(y_df_g)
            _, y_ds_g, fmap_s_r, fmap_s_g = mrd_apply(self.mrd, self.vcfg, y, y_hat)
            loss_fm_s = feature_loss(fmap_s_r, fmap_s_g)
            loss_gen_s, _ = generator_loss(y_ds_g)
            adv = loss_gen_s + loss_gen_f + loss_fm_s + loss_fm_f
        loss = loss_mel if frozen else loss_mel + adv
        norm = self.opt_g.step(self._mean(torch.autograd.grad(loss, self._g.tensors,
                                                              allow_unused=True), self._g.tensors))
        self.step_count += 1
        return {**self._mean_metrics({
            "gen_loss_total": loss, "mel_spec_error": loss_mel / w, "fm_loss_mpd": loss_fm_f,
            "gen_loss_mpd": loss_gen_f, "fm_loss_mrd": loss_fm_s, "gen_loss_mrd": loss_gen_s}),
            "grad_norm_g": norm}

    def mels(self, y: torch.Tensor, mel_in: torch.Tensor | None = None):
        """(input mel, loss-band mel) of (B, segment) audio, each cropped to
        ``segment // hop`` frames; ``mel_in`` (B, M, T) replaces the input
        mel (fine-tuning)."""
        T = y.shape[-1] // self.tcfg.hop_size
        with torch.no_grad():
            mel = self.input_frontend(y) if mel_in is None else mel_in
            return mel[..., :T], self.loss_frontend(y)[..., :T]

    def step_on_audio(self, y, mel_in=None) -> dict:
        """One D and one G step on ``y`` (B, segment) ground-truth audio;
        ``mel_in`` (B, num_mels, T) overrides the input mel (fine-tuning on
        BVRNN-decoded mels).  Returns the metrics as 0-d tensors."""
        y = torch.as_tensor(np.asarray(y) if not isinstance(y, torch.Tensor) else y,
                            dtype=torch.float32).to(self.device)
        if mel_in is not None:
            mel_in = torch.as_tensor(mel_in, dtype=torch.float32).to(self.device)
        mel, y_mel = self.mels(y, mel_in)
        d_metrics = self.d_step(mel, y[:, None])
        return {**d_metrics, **self.g_step(mel, y[:, None], y_mel)}

    @property
    def generator_params_folded(self) -> dict:
        """Inference generator params (weight norm folded), detached."""
        with torch.no_grad():
            return voc_mod.fold_generator_params(self.gen)

    # -- checkpoints ----------------------------------------------------------

    def generator_state_dict(self) -> dict:
        """The ``g_`` checkpoint: folded generator params by flat name."""
        return {"format": FORMAT, "kind": "generator", "step": self.step_count,
                "params": flatten_tree(self.generator_params_folded)}

    def state_dict(self) -> dict:
        """The ``do_`` checkpoint: the generator, both discriminators (with
        their spectral-norm buffers) and both optimizers by flat name, the
        step and the epoch."""
        return {"format": FORMAT, "kind": "gan", "step": self.step_count, "epoch": self.epoch,
                "gen": flatten_tree(self.gen),
                "disc": flatten_tree({"mpd": self.mpd, "mrd": self.mrd}),
                "opt_g": self.opt_g.state_dict(self._g.names),
                "opt_d": self.opt_d.state_dict(self._d.names)}

    def load_state_dict(self, state: dict) -> None:
        check_kind(state, "gan")
        gen, disc = flatten_tree(self.gen), flatten_tree({"mpd": self.mpd, "mrd": self.mrd})
        if set(state["gen"]) != set(gen) or set(state["disc"]) != set(disc):
            raise ValueError("checkpoint parameters do not match the model")
        with torch.no_grad():
            for flat, saved in ((gen, state["gen"]), (disc, state["disc"])):
                for n, t in flat.items():
                    t.copy_(saved[n])
        self.opt_g.load_state_dict(state["opt_g"], self._g.names)
        self.opt_d.load_state_dict(state["opt_d"], self._d.names)
        self.step_count, self.epoch = int(state["step"]), int(state["epoch"])


def generator_from_checkpoint(state: dict) -> dict:
    """The generator tree of a ``g_`` or ``do_`` checkpoint of the port."""
    check_kind(state, "generator", "gan")
    return unflatten_tree(state["params"] if state["kind"] == "generator" else state["gen"])
