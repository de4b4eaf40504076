"""ELBO with the reference's reductions (lesionvae_tpu/models/elbo.py).

- reconstruction: MSE averaged over every element;
- KL: -1/2 * mean(1 + logv - mu^2 - e^logv) over ALL elements (batch x
  latent), not a per-sample sum;
- beta anneals linearly 0.1 -> 2.0 over the epochs.

With a mask the means run over the valid rows only, so a padded partial
batch gives the loss of the short batch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def beta_schedule(epoch, total):
    """KLD weight annealing; epoch is 0-based."""
    if isinstance(total, int) and total <= 1:
        return 1.0
    return 0.1 + 1.9 * (epoch / (total - 1))


def elbo(xh: torch.Tensor, x: torch.Tensor, mu: torch.Tensor,
         logv: torch.Tensor, beta=1.0, mask: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (loss, recon, kld), all scalars; ``mask`` (N,), 1 = real row."""
    if mask is None:
        recon = torch.mean((xh - x) ** 2)
        kld = -0.5 * torch.mean(1 + logv - mu ** 2 - torch.exp(logv))
    else:
        m = mask.to(xh.dtype)
        per_elem = x[0].numel()  # L*C per row
        denom_x = torch.clamp(m.sum() * per_elem, min=1.0)
        recon = torch.sum(((xh - x) ** 2) * m[:, None, None]) / denom_x
        denom_z = torch.clamp(m.sum() * mu.shape[1], min=1.0)
        kld = -0.5 * torch.sum(
            (1 + logv - mu ** 2 - torch.exp(logv)) * m[:, None]) / denom_z
    return recon + beta * kld, recon, kld


def elbo_fleet(xh: torch.Tensor, x: torch.Tensor, mu: torch.Tensor,
               logv: torch.Tensor, beta, mask: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``elbo`` for T members at once: xh, x (T, N, L, C); mu, logv
    (T, N, latent); mask (T, N).  Returns (loss, recon, kld), each (T,):
    every member's means run over its own valid rows."""
    m = mask.to(xh.dtype)
    n_valid = m.sum(dim=1)
    denom_x = torch.clamp(n_valid * x[0, 0].numel(), min=1.0)
    recon = torch.sum(((xh - x) ** 2) * m[:, :, None, None], dim=(1, 2, 3)) / denom_x
    denom_z = torch.clamp(n_valid * mu.shape[2], min=1.0)
    kld = -0.5 * torch.sum((1 + logv - mu ** 2 - torch.exp(logv)) * m[:, :, None],
                           dim=(1, 2)) / denom_z
    return recon + beta * kld, recon, kld
