"""Normative modelling: Sham reconstruction statistics and z-score residuals
(the port of lesionvae_tpu/train/normative.py).

Reference semantics (src/vae/vae_model.py:229-334): draw A of the
reparameterisation noise feeds the Sham reconstruction mean/std (std
floored at 1e-6), draw B the residuals; z = (observed - reconstructed -
mean) / std with nan -> 0 and ±inf -> ±10; the magnitude is the RMS of z
over (position, feature).  Draws come from CPU generators seeded with
``seed`` and ``seed + 1`` (``reparam_noise``), so the card and the CPU see
the same numbers; ``noise=`` / ``eps=`` inject others (the tests pass the
JAX package's draws).

The ``*_fleet`` functions and ``member_summary`` do the same for every
member of a stacked fleet (``models.fleet.FleetState``) at once, on padded
(T, n_pad, L, C) blocks, with draws A and B shared by the members as the
JAX package shares its two keys; ``member_summary`` reduces the z block on
the device to per-subject mean-|z| profiles, so only summaries leave it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..models.fleet import FleetState, fleet_forward
from ..models.lesion_vae import TrainedVAE

# rows of every member that one eval forward of the fleet takes: eval-mode
# BatchNorm couples no rows, so chunks give the same values and bound the
# activations (T x rows x 64 channels x L floats a layer)
EVAL_ROWS = 256


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


# ------------------------------------------------------------------ fleet
def fleet_reconstruct(state: FleetState, Xm: torch.Tensor, Xl: torch.Tensor,
                      eps: torch.Tensor,
                      compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Eval-mode reconstruction of every member's rows: Xm (T, n, L, Cm), Xl
    (T, n, L, Cl), eps (n, latent) shared by the members or (T, n, latent).
    Returns xh (T, n, L, Cm) in the dtype of Xm, nan -> 0."""
    out = []
    with torch.no_grad():
        for r in range(0, Xm.shape[1], EVAL_ROWS):
            sl = slice(r, r + EVAL_ROWS)
            xh, _mu, _logv, _ = fleet_forward(
                state.layout, state.leaves, state.stats, Xm[:, sl], Xl[:, sl],
                None, eps[..., sl, :], False, compute_dtype)
            out.append(torch.nan_to_num(xh, nan=0.0).to(Xm.dtype))
    return torch.cat(out, dim=1)


def fleet_noise(state: FleetState, n: int, seed: int, noise, like: torch.Tensor):
    """The fleet's normative draws A and B, (n, latent) each: ``noise`` or
    those of ``seed`` and ``seed + 1``, on ``like``'s device in its dtype."""
    latent = state.layout.hyper["latent"]
    a, b = noise if noise is not None else (reparam_noise(n, latent, seed),
                                            reparam_noise(n, latent, seed + 1))
    put = lambda x: (x if isinstance(x, torch.Tensor)  # noqa: E731
                     else torch.from_numpy(np.array(x))).to(like.device, like.dtype)
    return put(a), put(b)


def normative_core_fleet(state: FleetState, Xm: torch.Tensor, Xl: torch.Tensor,
                         sham: torch.Tensor, eps_a: torch.Tensor,
                         eps_b: torch.Tensor,
                         compute_dtype: Optional[torch.dtype] = None):
    """``normative_core`` per member: sham (T, n) row mask.  Returns
    (mean_r (T, L, C), std_r, z (T, n, L, C), mag (T, n)) on the device."""
    xh_a = fleet_reconstruct(state, Xm, Xl, eps_a, compute_dtype)
    n_sham = torch.clamp(sham.sum(dim=1), min=1.0)[:, None, None]
    w = sham[:, :, None, None]
    mean_r = (xh_a * w).sum(dim=1) / n_sham
    var_r = (((xh_a - mean_r[:, None]) ** 2) * w).sum(dim=1) / n_sham
    std_r = torch.clamp(torch.sqrt(var_r), min=1e-6)
    xh_b = fleet_reconstruct(state, Xm, Xl, eps_b, compute_dtype)
    z = torch.nan_to_num((Xm - xh_b - mean_r[:, None]) / std_r[:, None],
                         nan=0.0, posinf=10.0, neginf=-10.0)
    mag = torch.sqrt(torch.mean(z ** 2, dim=(2, 3)))
    return mean_r, std_r, z, mag


def _fleet_input(X, like: torch.Tensor) -> torch.Tensor:
    t = X if isinstance(X, torch.Tensor) else torch.from_numpy(np.array(X))
    return torch.nan_to_num(t.to(like.device).to(torch.float32).to(like.dtype),
                            nan=0.0)


def normative_zscores_fleet(state: FleetState, Xm_T, Xl_T, sham_T, seed: int = 0,
                            noise: Optional[Tuple] = None):
    """Normative statistics and z-scores of a whole fleet in one pass: what
    ``normative_zscores_fused`` gives per member on the padded blocks (pad
    rows are outside the Sham mask; callers slice ``Z[i, :n_real[i]]``).
    Returns (mean_T, std_T, Z_T, mag_T) as numpy arrays."""
    like = state.affine
    Xm, Xl = _fleet_input(Xm_T, like), _fleet_input(Xl_T, like)
    sham = _fleet_input(sham_T, like)
    eps_a, eps_b = fleet_noise(state, Xm.shape[1], seed, noise, like)
    out = normative_core_fleet(state, Xm, Xl, sham, eps_a, eps_b)
    return tuple(t.cpu().numpy() for t in out)


def member_summary(state: FleetState, Xm: torch.Tensor, Xl: torch.Tensor,
                   sham: torch.Tensor, subj_idx: torch.Tensor, n_seg: int,
                   seed: int = 0, noise: Optional[Tuple] = None,
                   compute_dtype: Optional[torch.dtype] = None):
    """The normative summary of every member, on the device: the z block
    reduces to per-subject mean-|z| profiles by a one-hot matrix product
    (the mean over a subject's rows, then over features).  ``subj_idx``
    (T, n) maps each row to a segment in [0, n_seg); pad rows point at an
    unused one.  Returns (mean_r, std_r, mag (T, n), prof (T, n_seg, L),
    counts (T, n_seg))."""
    eps_a, eps_b = fleet_noise(state, Xm.shape[1], seed, noise, Xm)
    mean_r, std_r, z, mag = normative_core_fleet(state, Xm, Xl, sham, eps_a,
                                                 eps_b, compute_dtype)
    absz = z.abs().mean(dim=3)                                    # (T, n, L)
    onehot = torch.nn.functional.one_hot(subj_idx, n_seg).to(absz.dtype)
    counts = onehot.sum(dim=1)                                    # (T, n_seg)
    prof = (torch.bmm(onehot.transpose(1, 2), absz)
            / torch.clamp(counts, min=1.0)[:, :, None])
    return mean_r, std_r, mag, prof, counts


def normative_fleet_summary(state: FleetState, Xm_T, Xl_T, sham_T, subj_idx_T,
                            n_seg: int, seed: int = 0,
                            noise: Optional[Tuple] = None):
    """``member_summary`` from host arrays; returns numpy arrays."""
    like = state.affine
    idx = torch.as_tensor(np.asarray(subj_idx_T)).to(like.device, torch.int64)
    out = member_summary(
        state, _fleet_input(Xm_T, like), _fleet_input(Xl_T, like),
        _fleet_input(sham_T, like), idx, int(n_seg), seed, noise)
    return tuple(t.cpu().numpy() for t in out)
