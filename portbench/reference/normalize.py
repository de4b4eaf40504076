"""The published data normalization, per member and feature over the finite
values of its real rows: median (the mean of the two middle values), mean
and standard deviation (population, floored at 1e-6), worked out in float64
and held as float32; a feature with no finite value gets median = mean = 0,
std = 1.  Applied: non-finite values take the median, then z-score, then
clamp to +-1e6; the lesion channels take 0 for NaN."""

from __future__ import annotations

from typing import Dict

import numpy as np


def fit(Xm: np.ndarray, n_real: np.ndarray) -> Dict[str, np.ndarray]:
    """Xm (T, n_pad, L, C) raw -> {"median", "mean", "std"}, each (T, C)."""
    T, _n, _L, C = Xm.shape
    out = {k: np.zeros((T, C), np.float32) for k in ("median", "mean", "std")}
    for t in range(T):
        X = Xm[t, :n_real[t]].reshape(-1, C).astype(np.float64)
        for c in range(C):
            x = X[:, c][np.isfinite(X[:, c])]
            if x.size:
                out["median"][t, c] = np.median(x)
                out["mean"][t, c] = x.mean()
                out["std"][t, c] = max(x.std(), 1e-6)
            else:
                out["std"][t, c] = 1.0
    return out


def apply(Xm: np.ndarray, Xl: np.ndarray, stats: Dict[str, np.ndarray]):
    """The normalized blocks (float32), every row of Xm (T, n, L, C)."""
    b = lambda k: stats[k][:, None, None, :]  # noqa: E731
    X = np.where(np.isfinite(Xm), Xm, b("median")).astype(np.float32)
    Xz = np.clip((X - b("mean")) / b("std"), -1e6, 1e6).astype(np.float32)
    return Xz, np.nan_to_num(Xl, nan=0.0).astype(np.float32)
