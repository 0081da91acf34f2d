"""BVRNN VAE trainer (port of ``bvsc_tpu/train/bvrnn_train.py``).

The reference publishes no BVRNN trainer; its TOML carries the
hyperparameters (Adam betas, batch 32, lr 2e-4 decayed by 0.99999306855 a
step, global-norm clip 130, 4-s segments, the scheduled-sampling ramp
``teacher_force_step_1perc`` and the bitrate-switch probability
``p_bitratechange``), and the JAX package rebuilt the trainer from them:

  loss = Gaussian NLL with the learned ``log_sigma`` leaf + Bernoulli KLD,

every leaf of the tree trained (the mel statistics too, as there), with
optax's clip and Adam (``train.optim``).

Random draws.  Each step draws its bitrates, its scheduled-sampling
choices and binarisation noise, and its SpecAugment mask (``mel_mask``)
from three CPU ``torch.Generator``s seeded from ``(seed, step)``, as the
reference splits ``fold_in(rng, step)`` three ways, so that a resumed run
draws what an unbroken one would and the card draws what the CPU draws.
:class:`StepDraws` holds them; a caller (the tests, with the reference's
``jax.random`` draws) may pass its own.

Data parallelism (``mesh=``, an SPMD ``parallel.mesh.Mesh``): every rank
runs this trainer on its own rows of the global batch (contiguous blocks
over the mesh's ``data`` axis), draws the global batch's draws from
``(seed, step)`` and keeps its rows, as the reference's replicated key
draws over its sharded batch.  Each rank's gradient of its rows' loss is
averaged over the ranks by one flattened all-reduce before the optimizer,
so the clip sees the global batch's gradient as optax does there; the
metrics are averaged the same way.  The parameters start equal (the same
seed or tree) and stay equal on every rank.

``compute_dtype='bf16'`` runs the forward on a bf16 cast of the float32
masters (gradients flow back through the cast), with NLL and KLD reduced
in float32; the optimizer state stays float32.  The float32 mode is the
reference's ``Precision.HIGHEST``: the trainer turns TF32 off
(``device.set_parity_mode``, process-wide).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bvsc_tpu_torch.config import CodecConfig
from bvsc_tpu_torch.convert import flatten_tree, to_torch, unflatten_tree
from bvsc_tpu_torch.device import canonical, resolve_device, set_parity_mode
from bvsc_tpu_torch.models import bvrnn as bvrnn_mod
from bvsc_tpu_torch.parallel.collectives import all_mean
from bvsc_tpu_torch.parallel.mesh import DATA_AXIS
from bvsc_tpu_torch.train.checkpoint import FORMAT, check_kind
from bvsc_tpu_torch.train.optim import ClippedAdam


def p_use_gen_schedule(step: int, conf: CodecConfig) -> float:
    """Scheduled-sampling ramp: 0 -> 1 over ``teacher_force_step_1perc``
    steps."""
    return min(1.0, step / max(conf.teacher_force_step_1perc, 1))


def draw_bitrates(generator: torch.Generator, conf: CodecConfig, batch: int,
                  frames: int) -> torch.Tensor:
    """(batch, frames) bits/frame in [1, z_dim]; with probability
    ``p_bitratechange`` a sequence switches to a second bitrate at a
    uniformly drawn frame."""
    b1 = torch.randint(1, conf.z_dim + 1, (batch, 1), generator=generator).float()
    b2 = torch.randint(1, conf.z_dim + 1, (batch, 1), generator=generator).float()
    switch_at = torch.randint(0, frames, (batch, 1), generator=generator)
    do_switch = torch.rand(batch, 1, generator=generator) < conf.p_bitratechange
    second = (torch.arange(frames)[None, :] >= switch_at) & do_switch
    return torch.where(second, b2, b1)


def stripe_mask(generator: torch.Generator, batch: int, length: int, n: int,
                max_width: int) -> torch.Tensor:
    """(batch, length) bool: the union of ``n`` stripes a row, each of a
    width uniform in [0, max_width] (0: no stripe)."""
    start = torch.randint(0, length, (batch, n, 1), generator=generator)
    width = torch.randint(0, max_width + 1, (batch, n, 1), generator=generator)
    idx = torch.arange(length)[None, None, :]
    return ((idx >= start) & (idx < start + width)).any(dim=1)


def draw_spec_mask(generator: torch.Generator, batch: int, frames: int, mels: int, *,
                   n_freq: int = 2, freq_width: int = 10, n_time: int = 2,
                   time_width: int = 24) -> torch.Tensor:
    """(batch, frames, mels) bool: SpecAugment-style frame stripes or
    mel-band stripes (the reference's ``apply_spec_mask`` draws)."""
    t_mask = stripe_mask(generator, batch, frames, n_time, time_width)[:, :, None]
    f_mask = stripe_mask(generator, batch, mels, n_freq, freq_width)[:, None, :]
    return t_mask | f_mask


def apply_spec_mask(mel: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The masked entries of ``mel`` (B, T, M) replaced by the per-sequence
    per-band mean: the encoder's input for denoising training (the NLL
    target stays the clean mel)."""
    return torch.where(mask, mel.mean(dim=1, keepdim=True), mel)


@dataclasses.dataclass
class StepDraws:
    """One step's random draws (see the module docstring)."""

    bits: torch.Tensor | None  # (B, T) bits/frame, None without var_bit
    use_gen: torch.Tensor  # (T,) bool
    bin_noise: torch.Tensor  # (T, B, z) in the compute dtype
    spec_mask: torch.Tensor | None = None  # (B, T, M) bool, or None

    def to(self, device) -> "StepDraws":
        def move(t):
            return None if t is None else t.to(device)

        return StepDraws(move(self.bits), self.use_gen, move(self.bin_noise),
                         move(self.spec_mask))

    def rows(self, rows: slice) -> "StepDraws":
        """The draws of the batch rows ``rows`` (``use_gen`` is per frame,
        shared by every row)."""
        def take(t, lead=0):
            return None if t is None else t[(slice(None),) * lead + (rows,)]

        return StepDraws(take(self.bits), self.use_gen, take(self.bin_noise, 1),
                         take(self.spec_mask))


def step_generators(seed: int, step: int) -> list[torch.Generator]:
    """Three CPU generators (bitrates, model, mask) seeded from (seed, step)."""
    seeds = np.random.SeedSequence([seed, step]).generate_state(3, np.uint64)
    return [torch.Generator().manual_seed(int(s) & (2**63 - 1)) for s in seeds]


def draw_step(seed: int, step: int, conf: CodecConfig, batch: int, frames: int,
              mel_mask: dict | None = None, dtype: torch.dtype = torch.float32) -> StepDraws:
    """The draws of step ``step`` of a run seeded with ``seed``."""
    g_bits, g_model, g_mask = step_generators(seed, step)
    bits = draw_bitrates(g_bits, conf, batch, frames) if conf.var_bit else None
    use_gen, bin_noise = bvrnn_mod.draw_train_noise(
        g_model, p_use_gen_schedule(step, conf), frames, batch, conf.z_dim, dtype)
    mask = (draw_spec_mask(g_mask, batch, frames, conf.num_mels, **mel_mask)
            if mel_mask is not None else None)
    return StepDraws(bits, use_gen, bin_noise, mask)


def loss_fn(params: dict, cfg: bvrnn_mod.BVRNNConfig, mel: torch.Tensor, draws: StepDraws,
            dtype: torch.dtype = torch.float32):
    """(loss, metrics): the Gaussian NLL of ``mel`` (B, T, M) under the
    learned ``log_sigma`` plus the KLD of the sampled (not greedy) forward,
    reduced in float32.  With ``draws.spec_mask`` the encoder reads the
    masked mel."""
    mel_in = mel if draws.spec_mask is None else apply_spec_mask(mel, draws.spec_mask)
    mel_hat, kld = bvrnn_mod.forward_train(params, cfg, mel_in, draws.use_gen, False,
                                           draws.bits, draws.bin_noise, dtype=dtype)
    mel_hat, kld = mel_hat.float(), kld.float()
    log_sigma = params["log_sigma"][0]
    se = (mel_hat - mel) ** 2
    # per element: 0.5 * exp(-2 log_sigma) * err^2 + log_sigma
    nll = torch.mean(0.5 * torch.exp(-2.0 * log_sigma) * se + log_sigma)
    loss = nll + kld
    return loss, {"loss": loss, "nll": nll, "kld": kld, "mse": torch.mean(se),
                  "log_sigma": log_sigma}


def data_axis(mesh, device):
    """(this rank's device, the mesh's data axis or None): a trainer's
    ``mesh`` and ``device`` arguments resolved."""
    if mesh is None:
        return resolve_device(device), None
    if device is not None and canonical(device) != canonical(mesh.device):
        raise ValueError(f"device {device} is not this rank's device of the mesh, {mesh.device}")
    return mesh.device, mesh.axis(DATA_AXIS)


class BVRNNTrainer:
    """The BVRNN trainer (``bvsc_tpu``'s ``BVRNNTrainer``), on one device or
    data-parallel over a mesh (module docstring)."""

    def __init__(self, conf: CodecConfig, params: dict | None = None, seed: int = 0,
                 mean_std_mel=None, mel_mask: dict | None = None, fused_cell: bool = False,
                 compute_dtype: str | None = None, device: str | torch.device | None = None,
                 mesh=None):
        """``params``: a float32 BVRNN tree (numpy or tensors; fresh from
        ``seed`` when None, with ``mean_std_mel`` frozen in).  ``mel_mask``:
        keyword arguments of :func:`draw_spec_mask` (an empty dict for its
        defaults) to train on masked encoder inputs.  ``fused_cell`` and
        ``compute_dtype`` (None / ``'f32'`` or ``'bf16'``) are the
        reference's throughput knobs.  ``device`` defaults to CUDA, or with
        ``mesh`` to this rank's device of it."""
        if compute_dtype not in (None, "f32", "bf16"):
            raise ValueError(f"compute_dtype must be 'f32'/'bf16', got {compute_dtype!r}")
        self.device, self.dp = data_axis(mesh, device)
        self.conf = conf
        self.seed = seed
        self.mel_mask = mel_mask
        self.dtype = torch.bfloat16 if compute_dtype == "bf16" else torch.float32
        if self.dtype == torch.float32:
            set_parity_mode()
        self.cfg = bvrnn_mod.BVRNNConfig(x_dim=conf.num_mels, h_dim=conf.h_dim,
                                         z_dim=conf.z_dim, var_bit=conf.var_bit,
                                         fused_cell=bool(fused_cell))
        if params is None:
            params = bvrnn_mod.init_bvrnn_params(seed, self.cfg, mean_std_mel=mean_std_mel,
                                                 log_sigma_init=conf.log_sigma_init)
        self.params = to_torch(params, self.device, copy=True)
        self.names = list(flatten_tree(self.params))
        self.leaves = list(flatten_tree(self.params).values())
        for p in self.leaves:
            p.requires_grad_(True)
        self.opt = ClippedAdam(self.leaves, lr=conf.learning_rate, b1=conf.adam_b1,
                               b2=conf.adam_b2, max_norm=conf.grad_clip,
                               lr_decay=conf.lr_decay)
        self.step_count = 0

    def draws(self, batch: int, frames: int) -> StepDraws:
        """This step's draws, from (seed, step)."""
        return draw_step(self.seed, self.step_count, self.conf, batch, frames, self.mel_mask,
                         self.dtype)

    def step(self, mel: torch.Tensor, draws: StepDraws | None = None) -> dict:
        """One optimizer step on a (B, T, num_mels) mel batch, this rank's
        rows of the global batch under a mesh; ``draws`` (default this
        step's) are the global batch's.  Returns the metrics (0-d tensors,
        global-batch means): loss, nll, kld, mse, log_sigma, grad_norm."""
        mel = mel.to(self.device, torch.float32)
        B, T = mel.shape[:2]
        n, i = (1, 0) if self.dp is None else (self.dp.size, self.dp.index)
        if draws is None:
            draws = self.draws(B * n, T)
        loss, metrics = loss_fn(self.params, self.cfg, mel,
                                draws.rows(slice(i * B, (i + 1) * B)).to(self.device), self.dtype)
        grads = list(torch.autograd.grad(loss, self.leaves))
        # copies: log_sigma is a view of a parameter the update moves
        metrics = {k: v.detach().clone() for k, v in metrics.items()}
        if self.dp is not None:
            grads = all_mean(grads, self.dp)
            metrics = dict(zip(metrics, all_mean(list(metrics.values()), self.dp)))
        metrics["grad_norm"] = self.opt.step(grads)
        self.step_count += 1
        return metrics

    # -- checkpoints ----------------------------------------------------------

    def state_dict(self) -> dict:
        """Parameters and optimizer state by flat name, the step and the
        draw seed (``train.checkpoint`` writes it)."""
        return {
            "format": FORMAT,
            "kind": "bvrnn",
            "step": self.step_count,
            "seed": self.seed,
            "params": {n: p.detach() for n, p in zip(self.names, self.leaves)},
            "opt": self.opt.state_dict(self.names),
        }

    def load_state_dict(self, state: dict) -> None:
        check_kind(state, "bvrnn")
        if set(state["params"]) != set(self.names):
            raise ValueError("checkpoint parameters do not match the model")
        with torch.no_grad():
            for n, p in zip(self.names, self.leaves):
                p.copy_(state["params"][n])
        self.opt.load_state_dict(state["opt"], self.names)
        self.step_count = int(state["step"])
        self.seed = int(state["seed"])

    def host_params(self) -> dict:
        """A copy of the parameter tree as float32 numpy arrays."""
        return unflatten_tree({n: p.detach().to("cpu", copy=True).numpy() for n, p in
                               zip(self.names, self.leaves)})
