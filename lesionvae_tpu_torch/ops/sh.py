"""Spherical-harmonic lesion shape descriptors — PyTorch on a given device.

The reference builds a (2000, 49) SH design matrix via 49 scipy
``sph_harm`` evaluations and solves with ``lsq_linear`` per lesion
(src/lesion/lesion_sh_heme_comprehensive.py:159-223).  Here:

- the real SH basis is computed scipy-free via associated-Legendre
  recurrences, matching ``scipy.special.sph_harm`` + the reference's Re/Im×√2
  real conversion (:159-168);
- the least-squares fit uses normal equations with one Cholesky factor of
  the (K, K) Gram matrix shared by every lesion, so the whole cohort solves
  in one batched call.

Radius sampling, the step between surface points and the fit, lives in
ops/radius.py (the CUDA kernel and its plain version).

Float32 products on the card stay full float32: TF32 is switched off before
any product runs on a CUDA device (``utils.precision.full_fp32``).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch

from ..utils.precision import full_fp32


def fibonacci_sphere(num_samples: int = 2000, dtype=torch.float64,
                     device="cuda"
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Golden-ratio spiral directions — exact reference formulas
    (lesion_sh_heme_comprehensive.py:98-114)."""
    golden_ratio = (1 + 5 ** 0.5) / 2
    i = torch.arange(num_samples, dtype=dtype, device=device)
    theta = torch.arccos(1 - 2 * (i + 0.5) / num_samples)   # polar
    phi = 2 * math.pi * i / golden_ratio                    # azimuth
    st, ct = torch.sin(theta), torch.cos(theta)
    directions = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=1)
    return directions, theta, phi


def sh_index_list(max_l: int):
    """(l, m) order of the design-matrix columns: l ascending, m from -l to l
    (lesion_sh_heme_comprehensive.py:176-180)."""
    return [(l, m) for l in range(max_l + 1) for m in range(-l, l + 1)]


def _legendre_all(ct: torch.Tensor, max_l: int) -> Dict[Tuple[int, int], torch.Tensor]:
    """Associated Legendre P_l^m(ct) for 0<=m<=l<=max_l, with the
    Condon-Shortley phase (matching scipy's lpmv, hence sph_harm)."""
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    P: Dict[Tuple[int, int], torch.Tensor] = {}
    P[(0, 0)] = torch.ones_like(ct)
    for m in range(1, max_l + 1):
        # P_m^m = (-1)^m (2m-1)!! (1-x^2)^{m/2}
        P[(m, m)] = -(2 * m - 1) * st * P[(m - 1, m - 1)]
    for m in range(0, max_l):
        P[(m + 1, m)] = (2 * m + 1) * ct * P[(m, m)]
    for m in range(0, max_l + 1):
        for l in range(m + 2, max_l + 1):
            P[(l, m)] = ((2 * l - 1) * ct * P[(l - 1, m)]
                         - (l + m - 1) * P[(l - 2, m)]) / (l - m)
    return P


def real_sh_basis(theta: torch.Tensor, phi: torch.Tensor,
                  max_l: int = 6) -> torch.Tensor:
    """Real SH design matrix, shape (len(theta), (max_l+1)^2).

    Column (l, m) equals the reference's ``compute_spherical_harmonic``
    (lesion_sh_heme_comprehensive.py:159-168):
      m = 0 : Re(Y_l^0)            = N_l0 P_l(cos θ)
      m > 0 : Re(Y_l^m)  · sqrt(2) = sqrt(2) N_lm P_l^m(cos θ) cos(mφ)
      m < 0 : Im(Y_l^m)  · sqrt(2) = (-1)^{k+1} sqrt(2) N_lk P_l^k(cos θ) sin(kφ),
              k = |m|.
    """
    ct = torch.cos(theta)
    P = _legendre_all(ct, max_l)
    cols = []
    for l, m in sh_index_list(max_l):
        k = abs(m)
        # N_lk = sqrt((2l+1)/(4π) (l-k)!/(l+k)!)
        norm = float(np.sqrt((2 * l + 1) / (4 * np.pi)
                             * float(math.factorial(l - k))
                             / float(math.factorial(l + k))))
        base = norm * P[(l, k)]
        if m == 0:
            cols.append(base)
        elif m > 0:
            cols.append(math.sqrt(2.0) * base * torch.cos(k * phi))
        else:
            cols.append(((-1.0) ** (k + 1)) * math.sqrt(2.0) * base
                        * torch.sin(k * phi))
    return torch.stack(cols, dim=1)


@functools.lru_cache(maxsize=8)
def _cached_basis(max_l: int, num_samples: int, dtype: torch.dtype,
                  device: torch.device):
    full_fp32(device)
    directions, theta, phi = fibonacci_sphere(num_samples, dtype=dtype,
                                              device=device)
    A = real_sh_basis(theta, phi, max_l).to(dtype)
    AtA = A.T @ A
    chol_c = torch.linalg.cholesky(AtA, upper=True)
    return directions, theta, phi, A, chol_c


def cached_basis(max_l: int, num_samples: int, dtype=torch.float64,
                 device="cuda"):
    """Cached (directions, theta, phi, basis, upper Cholesky factor of
    basisᵀ basis), per (max_l, num_samples, dtype, device)."""
    return _cached_basis(max_l, num_samples, dtype, torch.device(device))


def state_from_numpy(directions: np.ndarray, basis: np.ndarray,
                     chol_c: np.ndarray, dtype=torch.float64, device="cuda"
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The SH state (directions, design matrix, upper Cholesky factor) as
    tensors, from the numpy arrays of the JAX package's ``cached_basis``."""
    return tuple(torch.tensor(np.asarray(a), dtype=dtype, device=device)
                 for a in (directions, basis, chol_c))


def _pearson(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Row-wise Pearson r; NaN where a row is constant (den == 0)."""
    xm = x - x.mean(dim=1, keepdim=True)
    ym = y - y.mean(dim=1, keepdim=True)
    num = (xm * ym).sum(dim=1)
    den = torch.sqrt((xm ** 2).sum(dim=1) * (ym ** 2).sum(dim=1))
    return num / den


def sh_fit_batch(radii: torch.Tensor, basis: torch.Tensor, chol_c: torch.Tensor,
                 max_l: int = 6) -> Dict[str, torch.Tensor]:
    """Batched SH fit + spectra + reconstruction quality.

    radii: (B, D) scale-normalized radius functions; basis: (D, K);
    chol_c: upper Cholesky factor of basisᵀ basis (shared across the batch).
    Returns coeffs (B, K), raw powers (B, L+1), normalized powers,
    reconstruction (B, D) and its Pearson r vs the input (reference
    computes these at :190-223, :433-434).
    """
    full_fp32(radii.device)
    Atb = basis.T @ radii.T                                          # (K, B)
    coeffs = torch.cholesky_solve(Atb, chol_c, upper=True).T         # (B, K)

    powers = []
    idx = 0
    for l in range(max_l + 1):
        width = 2 * l + 1
        powers.append((coeffs[:, idx:idx + width] ** 2).sum(dim=1))
        idx += width
    P_raw = torch.stack(powers, dim=1)                  # (B, L+1)
    total = P_raw.sum(dim=1, keepdim=True)
    P_norm = torch.where(total > 0, P_raw / total, P_raw)  # normalize_powers(:204-210)

    recon = coeffs @ basis.T                            # (B, D)
    r = _pearson(radii, recon)                          # :433-434

    # axisymmetric coefficients c_l^0 (column index l^2 + l) (:427-430)
    c_l0 = torch.stack([coeffs[:, l * l + l] for l in range(max_l + 1)], dim=1)

    return {"coeffs": coeffs, "P_raw": P_raw, "P_norm": P_norm,
            "recon": recon, "reconstruction_r": r, "c_l0": c_l0}


def sh_fit_batch_packed(radii: torch.Tensor, basis: torch.Tensor,
                        chol_c: torch.Tensor, max_l: int = 6) -> torch.Tensor:
    """sh_fit_batch packed into ONE (B, K + 3·(L+1) + 1) tensor for a single
    device→host copy.  Column layout: [coeffs | P_raw | P_norm | c_l0 |
    reconstruction_r]."""
    out = sh_fit_batch(radii, basis, chol_c, max_l=max_l)
    return torch.cat([out["coeffs"], out["P_raw"], out["P_norm"], out["c_l0"],
                      out["reconstruction_r"][:, None]], dim=1)


def unpack_sh_fit(packed: np.ndarray, max_l: int) -> Dict[str, np.ndarray]:
    K = (max_l + 1) ** 2
    L1 = max_l + 1
    i0, i1, i2, i3 = K, K + L1, K + 2 * L1, K + 3 * L1
    return {"coeffs": packed[:, :K], "P_raw": packed[:, i0:i1],
            "P_norm": packed[:, i1:i2], "c_l0": packed[:, i2:i3],
            "reconstruction_r": packed[:, i3]}


def reconstruct_surface(coeffs: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """Radius reconstruction from coefficients (reference :213-223)."""
    return coeffs @ basis.T
