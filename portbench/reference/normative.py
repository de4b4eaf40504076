"""The normative pass of a trained VAE (the published ``vae_model.py``
z-scores): eval-mode reconstructions with draw A give the Sham rows' mean
and standard deviation (floored at 1e-6) per (position, feature); with
draw B every row's z = (x - reconstruction - mean) / std, NaN -> 0 and
+-inf -> +-10, and its magnitude, the root mean square of z over
(position, feature).  The cohort's summary then reduces |z| to each
subject's mean profile along the tract."""

from __future__ import annotations

import torch

from .model import encode, forward

ROWS = 256      # rows of every member an eval forward takes at once (memory only)


def reconstruct(p, stats, Xm, Xl, eps) -> torch.Tensor:
    out = []
    with torch.no_grad():
        for r in range(0, Xm.shape[1], ROWS):
            sl = slice(r, r + ROWS)
            xh, _mu, _lv, _ = forward(p, stats, Xm[:, sl], Xl[:, sl], None, eps[..., sl, :],
                                      False)
            out.append(torch.nan_to_num(xh, nan=0.0))
    return torch.cat(out, dim=1)


def zscores(p, stats, Xm, Xl, sham, eps_a, eps_b):
    """-> (mean (S, L, C), std, z (S, n, L, C), magnitude (S, n))."""
    xh = reconstruct(p, stats, Xm, Xl, eps_a)
    w = sham[:, :, None, None]
    n_sham = torch.clamp(sham.sum(dim=1), min=1.0)[:, None, None]
    mean = (xh * w).sum(dim=1) / n_sham
    std = torch.clamp(torch.sqrt((((xh - mean[:, None]) ** 2) * w).sum(dim=1) / n_sham),
                      min=1e-6)
    xh = reconstruct(p, stats, Xm, Xl, eps_b)
    z = torch.nan_to_num((Xm - xh - mean[:, None]) / std[:, None], nan=0.0,
                         posinf=10.0, neginf=-10.0)
    return mean, std, z, torch.sqrt((z ** 2).mean(dim=(2, 3)))


def subject_profiles(z: torch.Tensor, subject: torch.Tensor, n_subjects: int) -> torch.Tensor:
    """Each subject's mean over its rows of |z| averaged over features:
    (S, n_subjects, L)."""
    absz = z.abs().mean(dim=3)
    prof = z.new_zeros((z.shape[0], n_subjects, z.shape[2]))
    for k in range(n_subjects):
        rows = (subject == k).to(z.dtype)
        prof[:, k] = (absz * rows[:, :, None]).sum(dim=1) / torch.clamp(
            rows.sum(dim=1), min=1.0)[:, None]
    return prof


def latents(p, stats, Xm, Xl) -> torch.Tensor:
    """The eval-mode posterior means."""
    with torch.no_grad():
        return encode(p, stats, Xm, Xl, None, False, {})[0]
