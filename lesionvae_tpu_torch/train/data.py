"""VAE tensor building and normalization (PyTorch port).

The host builders are copies of lesionvae_tpu/train/data.py:
- ``csv_path`` / ``build_tensor_with_lesion_context``
  (src/vae/data_loader.py:10-148): pivot per-subject long CSVs into
  (n_streamlines, 100, n_feats) tensors, with the reference's quirks kept —
  missing lesion features imputed identically for Sham and non-Sham
  (in_lesion/in_cavity=False, lesion_distance=15.0, :77-88), lesion_distance
  hard-coded as column 2 clipped to [0,15]/15 (:116-117), exactly 100 nodes
  required (:98-100).
- ``fit_normalization_stats`` / ``apply_normalization``
  (src/vae/normalization.py:8-69): per-feature median/mean/std over finite
  values (std floor 1e-6), median-impute, z-score, clamp ±1e6.

``apply_normalization_device`` applies given statistics to tensors on the
device (the serving path), with the same float32 arithmetic as the host
version.  ``normalize_on_device`` fits and applies them for every member of
a padded fleet block at once (lesionvae_tpu/train/data.py:188-232), so the
raw tensors are uploaded once and the data never returns to the host.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import torch

from ..utils.logging import get_logger

log = get_logger("data")


def csv_path(base_path, subject_id, tp) -> Path:
    return (Path(base_path) / "results" / str(subject_id)
            / f"timepoint_analysis_{subject_id}_{tp}"
            / f"comprehensive_tract_data_{subject_id}_{tp}.csv")


def _complete_grid(df: pd.DataFrame, stream_ids, nodes) -> bool:
    """Whether ``df``, sorted by (streamline_id, point_id), holds every
    (streamline, node) pair exactly once."""
    S, P = len(stream_ids), len(nodes)
    if len(df) != S * P:
        return False
    return bool(
        (df["point_id"].to_numpy().reshape(S, P) == np.asarray(nodes)[None, :]).all()
        and (df["streamline_id"].to_numpy().reshape(S, P)
             == np.asarray(stream_ids)[:, None]).all())


def build_tensor_with_lesion_context(
        base_path, tract: str, tp: str, subjects: Sequence,
        micro_feats: Sequence[str], lesion_feats: Sequence[str],
        groups_dict: Dict[str, List],
        csv_cache: Optional[dict] = None) -> Tuple[np.ndarray, np.ndarray,
                                                   np.ndarray, np.ndarray,
                                                   np.ndarray]:
    """Returns (X_micro, X_lesion, subj_ids, group_labels, s).

    ``csv_cache``: optional dict keyed by (subject, tp) holding the full
    profile dataframes.  Cohort-scale callers (pipeline/infer.score_cohort:
    16 tracts share each subject CSV) pass one dict across members so every
    CSV is read once instead of once per tract."""
    X_micro_list, X_lesion_list = [], []
    subj_stream_ids, group_stream_labels = [], []

    subj_to_group = {str(sid): g for g, subs in groups_dict.items()
                     for sid in subs}

    df = None
    for sid in subjects:
        fp = csv_path(base_path, sid, tp)
        ckey = (str(sid), str(tp))
        if csv_cache is not None and ckey in csv_cache:
            df_full = csv_cache[ckey]
            if df_full is None:  # negative cache: file known missing
                log.warning("missing %s", fp)
                continue
        elif not fp.exists():
            if csv_cache is not None:
                csv_cache[ckey] = None
            log.warning("missing %s", fp)
            continue
        else:
            df_full = pd.read_csv(fp)
            if csv_cache is not None:
                csv_cache[ckey] = df_full
        df = df_full[df_full["tract_id"] == tract].copy()
        if df.empty:
            continue

        missing_micro = [c for c in micro_feats if c not in df.columns]
        if missing_micro:
            log.warning("missing microstructure features in %s: %s",
                        fp, missing_micro)
            continue

        subject_group = subj_to_group[str(sid)]
        for lf in lesion_feats:
            if lf not in df.columns:
                # imputation is identical for Sham and lesioned groups
                # (data_loader.py:79-88)
                if lf in ("in_lesion", "in_cavity"):
                    df[lf] = False
                elif lf == "lesion_distance":
                    df[lf] = 15.0
                if subject_group != "Sham" and tp in ("2d", "9d"):
                    log.info("%s (%s) @ %s: lesion data may be minimal "
                             "(acute phase)", sid, subject_group, tp)

        df.sort_values(["streamline_id", "point_id"], inplace=True)
        stream_ids = sorted(df["streamline_id"].unique())
        nodes = sorted(df["point_id"].unique())
        if len(nodes) != 100:
            log.warning("%s has %d nodes, expected 100", fp, len(nodes))
            continue

        if _complete_grid(df, stream_ids, nodes):
            # every streamline holds every node once: the sorted rows are
            # the tensor already (what the pivot below gives, without ~50
            # pandas selections a subject)
            shape = (len(stream_ids), len(nodes), -1)
            micro = df[list(micro_feats)].to_numpy().astype(np.float32).reshape(shape)
            lesion = df[list(lesion_feats)].to_numpy().astype(np.float32).reshape(shape)
        else:
            wide_micro = df.pivot(index="point_id", columns="streamline_id",
                                  values=list(micro_feats))
            wide_lesion = df.pivot(index="point_id", columns="streamline_id",
                                   values=list(lesion_feats))
            micro = np.stack([wide_micro.xs(s_id, axis=1, level=1).reindex(nodes)
                              .values.astype(np.float32) for s_id in stream_ids])
            lesion = np.stack([wide_lesion.xs(s_id, axis=1, level=1).reindex(nodes)
                               .values.astype(np.float32) for s_id in stream_ids])
        lesion[:, :, 2] = np.clip(lesion[:, :, 2], 0, 15) / 15.0
        X_micro_list.extend(micro)
        X_lesion_list.extend(lesion)
        subj_stream_ids.extend([sid] * len(stream_ids))
        group_stream_labels.extend([subject_group] * len(stream_ids))

    if not X_micro_list:
        raise ValueError(f"No data for {tract} @ {tp}")

    X_micro = np.stack(X_micro_list, axis=0)
    X_lesion = np.stack(X_lesion_list, axis=0)
    subj_ids = np.array(subj_stream_ids)
    group_labels = np.array(group_stream_labels)

    s_vals = df["position_along_tract"].unique()
    s = (np.linspace(0, 1, 100) if len(s_vals) != 100
         else np.sort(s_vals.astype(float)))

    log.info("%s@%s: X_micro=%s, X_lesion=%s", tract, tp, X_micro.shape,
             X_lesion.shape)
    return X_micro, X_lesion, subj_ids, group_labels, s


def fit_normalization_stats(X_micro: np.ndarray, X_lesion: np.ndarray,
                            feat_names: Sequence[str]) -> Dict[str, np.ndarray]:
    """Per-feature median/mean/std over finite values (normalization.py:8-40)."""
    X = X_micro.reshape(-1, X_micro.shape[-1])
    finite = np.isfinite(X)
    if finite.all():
        # fast path (typical: upstream tensor builders already impute):
        # columnwise stats without per-feature boolean gathers.  Accumulate
        # in float32 like the slow path's np.nanmean/np.nanstd-on-float32 so
        # a single NaN flipping which path runs cannot shift the stats by an
        # accumulation-dtype ulp (ADVICE r2)
        meds = np.median(X, axis=0).astype(np.float32)
        mus = X.mean(axis=0).astype(np.float32)
        stds = np.maximum(X.std(axis=0), 1e-6).astype(np.float32)
        return {"median": meds, "mean": mus, "std": stds}
    meds = np.zeros(X.shape[1], np.float32)
    mus = np.zeros(X.shape[1], np.float32)
    stds = np.ones(X.shape[1], np.float32)
    for j in range(X.shape[1]):
        xj = X[finite[:, j], j]
        if xj.size:
            meds[j] = np.nanmedian(xj)
            mus[j] = np.nanmean(xj)
            stds[j] = max(float(np.nanstd(xj)), 1e-6)
        else:
            meds[j] = mus[j] = 0.0
            stds[j] = 1.0
    return {"median": meds, "mean": mus, "std": stds}


def apply_normalization(X_micro: np.ndarray, X_lesion: np.ndarray,
                        stats: Dict[str, np.ndarray]
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Median-impute non-finite, z-score, clamp ±1e6 (normalization.py:43-69).

    Pass-efficient: one output allocation and in-place arithmetic (the
    reference chains 4 full-array temporaries; on the 1-core bench host this
    stage is in the timed window)."""
    Xz = np.array(X_micro, np.float32, copy=True)
    med = stats["median"][None, None, :]
    bad = ~np.isfinite(Xz)
    if bad.any():
        Xz[bad] = np.broadcast_to(med, Xz.shape)[bad]
    Xz -= stats["mean"][None, None, :]
    Xz /= stats["std"][None, None, :]
    # post-imputation entries are finite, so the reference's
    # nan_to_num(nan=0, ±1e6) reduces to the ±1e6 clamp
    np.clip(Xz, -1e6, 1e6, out=Xz)
    if np.isfinite(X_lesion).all():
        X_lesion = np.asarray(X_lesion, np.float32)
    else:
        X_lesion = np.nan_to_num(X_lesion, nan=0.0).astype(np.float32)
    return Xz, X_lesion


def apply_normalization_device(Xm: torch.Tensor, Xl: torch.Tensor,
                               stats: Dict[str, torch.Tensor]
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply-only twin of :func:`apply_normalization` on tensors with given
    stats (median-impute non-finite, z-score, clamp ±1e6); the result has
    the dtype of ``Xm``.  One member, (n, L, C) with (C,) stats, or a fleet,
    (T, n, L, C) with (T, C) stats."""
    med, mean, std = (stats[k][..., None, None, :]
                      for k in ("median", "mean", "std"))
    Xc = torch.where(torch.isfinite(Xm), Xm, med)
    Xz = torch.clamp((Xc - mean) / std, -1e6, 1e6)
    return Xz, torch.nan_to_num(Xl, nan=0.0)


def normalize_on_device(Xm: torch.Tensor, Xl: torch.Tensor,
                        n_real: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor,
                                   Dict[str, torch.Tensor]]:
    """Fit and apply the normalization for every member of a padded fleet
    block: Xm (T, n_pad, L, C) raw, Xl (T, n_pad, L, Cl), n_real (T,).

    Per member and feature, over the finite values of the real rows
    (< n_real): median (mean of the two middle order statistics, by a sort
    that sends every other entry to the tail), mean and std (floor 1e-6); a
    feature with no finite value gets median = mean = 0, std = 1, so its
    imputed entries z-score to exactly 0.  Then median-impute, z-score,
    clamp ±1e6.  Returns (Xz, Xl, {"median", "mean", "std"} of (T, C))."""
    T, n_pad, L, C = Xm.shape
    X = Xm.reshape(T, n_pad * L, C)
    row_real = torch.arange(n_pad, device=Xm.device)[None, :] < n_real[:, None]
    valid = row_real.repeat_interleave(L, dim=1)[:, :, None] & torch.isfinite(X)
    count = valid.sum(dim=1)                                    # (T, C)
    cnt = torch.clamp(count, min=1)

    zero = X.new_zeros(())
    mean = torch.where(valid, X, zero).sum(dim=1) / cnt
    var = torch.where(valid, (X - mean[:, None, :]) ** 2, zero).sum(dim=1) / cnt
    std = torch.clamp(torch.sqrt(var), min=1e-6)

    Xs = torch.sort(torch.where(valid, X, X.new_full((), float("inf"))),
                    dim=1).values
    m1 = torch.gather(Xs, 1, ((cnt - 1) // 2)[:, None, :])[:, 0]
    m2 = torch.gather(Xs, 1, (cnt // 2)[:, None, :])[:, 0]
    med = 0.5 * (m1 + m2)

    any_valid = count > 0
    stats = {"median": torch.where(any_valid, med, zero),
             "mean": torch.where(any_valid, mean, zero),
             "std": torch.where(any_valid, std, torch.ones_like(std))}
    Xz, Xl = apply_normalization_device(Xm, Xl, stats)
    return Xz, Xl, stats
