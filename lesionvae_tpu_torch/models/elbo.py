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
         logv: torch.Tensor, beta=1.0, mask: Optional[torch.Tensor] = None,
         axis=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (loss, recon, kld), all scalars; ``mask`` (N,), 1 = real row.

    ``axis`` (a ``parallel.mesh.Axis``, needs ``mask``): the other rows of
    the batch lie on that axis's ranks; the squared error, the KL sum and
    both counts are summed over it before the means, as
    lesionvae_tpu/parallel/sharded.py:123-131 does, so every rank holds the
    whole batch's loss."""
    if mask is None:
        if axis is not None:
            raise ValueError("a loss summed over a mesh axis needs the row mask")
        recon = torch.mean((xh - x) ** 2)
        kld = -0.5 * torch.mean(1 + logv - mu ** 2 - torch.exp(logv))
    else:
        m = mask.to(xh.dtype)
        per_elem = x[0].numel()  # L*C per row
        sse = torch.sum(((xh - x) ** 2) * m[:, None, None])
        n_x = m.sum() * per_elem
        kl = torch.sum((1 + logv - mu ** 2 - torch.exp(logv)) * m[:, None])
        n_z = m.sum() * mu.shape[1]
        if axis is not None:
            sse, n_x, kl, n_z = (axis.psum(t) for t in (sse, n_x, kl, n_z))
        recon = sse / torch.clamp(n_x, min=1.0)
        kld = -0.5 * kl / torch.clamp(n_z, min=1.0)
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
