"""GAN losses, LSGAN and feature matching (port of
``bvsc_tpu/models/losses.py``, reference BigVGAN ``models.py:411-442``)."""

from __future__ import annotations

import torch


def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    """Twice the sum, over every feature map, of the mean |real - generated|."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl - gl))
    return loss * 2


def discriminator_loss(disc_real_outputs, disc_generated_outputs):
    """LSGAN D loss, sum over discriminators of mean (1 - D(y))^2 + mean
    D(y_hat)^2; returns (loss, real losses, generated losses)."""
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(disc_real_outputs, disc_generated_outputs):
        r_loss = torch.mean((1.0 - dr) ** 2)
        g_loss = torch.mean(dg ** 2)
        loss = loss + (r_loss + g_loss)
        r_losses.append(r_loss)
        g_losses.append(g_loss)
    return loss, r_losses, g_losses


def generator_loss(disc_outputs):
    """LSGAN G loss, sum over discriminators of mean (1 - D(y_hat))^2;
    returns (loss, per-discriminator losses)."""
    loss = 0.0
    gen_losses = []
    for dg in disc_outputs:
        g_loss = torch.mean((1.0 - dg) ** 2)
        gen_losses.append(g_loss)
        loss = loss + g_loss
    return loss, gen_losses
