"""Normative modelling: Sham reconstruction statistics and z-score residuals
(the port of lesionvae_tpu/train/normative.py:21-100,210-222).

Reference semantics (src/vae/vae_model.py:229-334): draw A of the
reparameterisation noise feeds the Sham reconstruction mean/std (std
floored at 1e-6), draw B the residuals; z = (observed - reconstructed -
mean) / std with nan -> 0 and ±inf -> ±10; the magnitude is the RMS of z
over (position, feature).  Draws come from CPU generators seeded with
``seed`` and ``seed + 1`` (``reparam_noise``), so the card and the CPU see
the same numbers; ``noise=`` / ``eps=`` inject others (the tests pass the
JAX package's draws).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .trainer import TrainedVAE


def reparam_noise(n: int, latent: int, seed: int) -> torch.Tensor:
    """(n, latent) standard normal draws on the CPU from ``seed``."""
    return torch.randn((n, latent), generator=torch.Generator().manual_seed(seed))


def _input(model: TrainedVAE, X) -> torch.Tensor:
    """float32 values (as the JAX package casts them), nan -> 0, on the
    model's device in its dtype."""
    t = X if isinstance(X, torch.Tensor) else torch.from_numpy(np.array(X))
    return torch.nan_to_num(t.to(torch.float32).to(model.device, model.dtype),
                            nan=0.0)


def _eps(model: TrainedVAE, n: int, seed: int, eps) -> torch.Tensor:
    if eps is None:
        eps = reparam_noise(n, model.module.latent, seed)
    return model.as_tensor(eps)


def _reconstruct(model: TrainedVAE, Xm: torch.Tensor, Xl: torch.Tensor,
                 eps: torch.Tensor) -> torch.Tensor:
    xh, _, _ = model.apply(Xm, Xl, eps=eps)
    return torch.nan_to_num(xh, nan=0.0)


def z_residual(X: torch.Tensor, xh: torch.Tensor, mean_r: torch.Tensor,
               std_r: torch.Tensor) -> torch.Tensor:
    """z = (observed - reconstructed - normative mean) / normative std, with
    nan -> 0 and ±inf -> ±10 (vae_model.py:318-326)."""
    z = (X - torch.nan_to_num(xh, nan=0.0) - mean_r[None]) / std_r[None]
    return torch.nan_to_num(z, nan=0.0, posinf=10.0, neginf=-10.0)


def normative_core(model: TrainedVAE, Xm: torch.Tensor, Xl: torch.Tensor,
                   sham: torch.Tensor, eps_a: torch.Tensor,
                   eps_b: torch.Tensor):
    """Sham statistics from draw A, z-scores of every row from draw B.
    Returns (mean_r, std_r, z, mag) on the device."""
    xh_a = _reconstruct(model, Xm, Xl, eps_a)
    n_sham = torch.clamp(sham.sum(), min=1.0)
    w = sham[:, None, None]
    mean_r = (xh_a * w).sum(dim=0) / n_sham
    var_r = (((xh_a - mean_r) ** 2) * w).sum(dim=0) / n_sham
    std_r = torch.clamp(torch.sqrt(var_r), min=1e-6)
    z = z_residual(Xm, _reconstruct(model, Xm, Xl, eps_b), mean_r, std_r)
    mag = torch.sqrt(torch.mean(z ** 2, dim=(1, 2)))
    return mean_r, std_r, z, mag


def normative_zscores_fused(model: TrainedVAE, X_micro, X_lesion,
                            sham_mask: np.ndarray, seed: int = 0,
                            noise: Optional[Tuple] = None
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                       np.ndarray]:
    """Normative stats on the Sham rows + z-scores of every row, in one
    pass on the model's device.  ``noise`` = (draw A, draw B), each
    (n, latent); default: ``reparam_noise`` from seed and seed + 1.

    Returns (mean_recon, std_recon, Z, magnitude) as numpy arrays."""
    Xm, Xl = _input(model, X_micro), _input(model, X_lesion)
    n = Xm.shape[0]
    eps_a, eps_b = noise if noise is not None else (None, None)
    sham = model.as_tensor(np.asarray(sham_mask, np.float32))
    out = normative_core(model, Xm, Xl, sham, _eps(model, n, seed, eps_a),
                         _eps(model, n, seed + 1, eps_b))
    return tuple(t.cpu().numpy() for t in out)


def compute_normative_statistics(model: TrainedVAE, X_micro_sham,
                                 X_lesion_sham, seed: int = 0, eps=None
                                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Mean/std of Sham reconstructions per (position, feature); std
    floored at 1e-6 (vae_model.py:267-269)."""
    Xm, Xl = _input(model, X_micro_sham), _input(model, X_lesion_sham)
    recon = _reconstruct(model, Xm, Xl, _eps(model, Xm.shape[0], seed, eps))
    mean_r = recon.mean(dim=0)
    std_r = torch.clamp(recon.std(dim=0, unbiased=False), min=1e-6)
    return mean_r.cpu().numpy(), std_r.cpu().numpy()


def compute_zscore_residuals(model: TrainedVAE, X_micro, X_lesion,
                             mean_recon, std_recon, seed: int = 1, eps=None
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """z-scores of every row against given normative statistics, and their
    RMS magnitude over (position, feature)."""
    Xm, Xl = _input(model, X_micro), _input(model, X_lesion)
    recon = _reconstruct(model, Xm, Xl, _eps(model, Xm.shape[0], seed, eps))
    z = z_residual(Xm, recon, model.as_tensor(mean_recon),
                   model.as_tensor(std_recon))
    mag = torch.sqrt(torch.mean(z ** 2, dim=(1, 2)))
    return z.cpu().numpy(), mag.cpu().numpy()
