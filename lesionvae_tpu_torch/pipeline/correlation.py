"""Lesion-SH <-> tract-geometry Pearson correlation stage (scipy, host-side).

A copy of lesionvae_tpu/pipeline/correlation.py; it reads the two CSVs the
port's ``lesion`` and ``geometry`` stages write (the device work is done by
then) and behaves as src/analysis/correlation.py does:
- TBI/PTE filter (:49-50); merge per subject x timepoint of the lesion row
  with subject-mean tract metrics at 9d/1mo/5mo (:86-138)
- 9 SH features x 11 tract features Pearson r per group x timepoint, keep
  p < 0.05 uncorrected (:141-183, :280-291)
- scatter plots per significant pair, RdBu heatmaps, console summary
  (:186-268, :366-473)

The figure module (matplotlib, seaborn) is imported only when figures are
asked for.
"""

from __future__ import annotations

from pathlib import Path
from typing import List

import numpy as np
import pandas as pd

from ..utils.logging import get_logger
from ..utils.profiling import stage

log = get_logger("correlate")

SH_FEATURES = ["P0", "P1", "P2", "P3", "P4", "P5", "P6",
               "lesion_volume", "lesion_brain_ratio"]
TRACT_FEATURES = [
    "n_streamlines", "length_mean", "tortuosity_mean", "curv_mean_avg",
    "curv_energy_mean", "torsion_mean_avg", "bend_angle_mean_avg",
    "elongation_ratio_mean", "planarity_ratio_mean", "anisotropy_ratio_mean",
    "ang_dispersion_mean"]
TIMEPOINTS = ["9d", "1mo", "5mo"]
GROUPS = ["TBI", "PTE"]
P_CUT = 0.05


def load_data(lesion_path: str | Path, tract_path: str | Path):
    df_lesion = pd.read_csv(lesion_path)
    df_tract = pd.read_csv(tract_path)
    df_lesion = df_lesion[df_lesion["group"].isin(GROUPS)].copy()
    df_tract = df_tract[df_tract["group"].isin(GROUPS)].copy()
    return df_lesion, df_tract


def merge_lesion_tract_data(df_lesion: pd.DataFrame,
                            df_tract: pd.DataFrame) -> pd.DataFrame:
    rows = []
    for tp in TIMEPOINTS:
        for _, lrow in df_lesion[df_lesion["timepoint"] == tp].iterrows():
            subj = df_tract[(df_tract["timepoint"] == tp)
                            & (df_tract["subject_id"].astype(str)
                               == str(lrow["subject_id"]))]
            if len(subj) == 0:
                continue
            merged = {
                "subject_id": lrow["subject_id"], "timepoint": tp,
                "group": lrow["group"],
                **{f"P{l}": lrow[f"P{l}"] for l in range(7)},
                "lesion_volume": lrow["original_volume_mm3"],
                "lesion_brain_ratio": lrow["lesion_brain_ratio"],
                "brain_volume": lrow["brain_volume_mm3"],
            }
            for col in TRACT_FEATURES:
                if col in subj.columns:
                    merged[col] = subj[col].mean()
            rows.append(merged)
    df = pd.DataFrame(rows)
    log.info("merged dataset: %s", df.shape)
    return df


def pair_values(df: pd.DataFrame, group: str, timepoint: str, sh_feat: str,
                tract_feat: str):
    """The finite (x, y) pairs of one feature pair in one group and
    timepoint, or None where fewer than 3 remain or either is constant (no
    correlation is computed there)."""
    sub = df[(df["group"] == group) & (df["timepoint"] == timepoint)]
    if len(sub) < 3 or sh_feat not in sub.columns or tract_feat not in sub.columns:
        return None
    x = sub[sh_feat].values.astype(float)
    y = sub[tract_feat].values.astype(float)
    ok = ~(np.isnan(x) | np.isnan(y))
    if ok.sum() < 3:
        return None
    xv, yv = x[ok], y[ok]
    if np.std(xv) == 0 or np.std(yv) == 0:
        return None
    return xv, yv


def compute_correlations(df: pd.DataFrame, group: str, timepoint: str,
                         sh_features: List[str],
                         tract_features: List[str]) -> List[dict]:
    from scipy.stats import pearsonr

    out = []
    for sh_feat in sh_features:
        for tract_feat in tract_features:
            xy = pair_values(df, group, timepoint, sh_feat, tract_feat)
            if xy is None:
                continue
            r, p = pearsonr(*xy)
            if p < P_CUT:
                out.append({"group": group, "timepoint": timepoint,
                            "sh_feature": sh_feat, "tract_feature": tract_feat,
                            "r": r, "p": p, "n": len(xy[0])})
    return out


def analyze_correlations(df_merged: pd.DataFrame, output_dir: Path,
                         make_plots: bool = True) -> pd.DataFrame:
    all_sig = []
    for tp in TIMEPOINTS:
        for group in GROUPS:
            sig = compute_correlations(df_merged, group, tp, SH_FEATURES,
                                       TRACT_FEATURES)
            all_sig.extend(sig)
            log.info("%s @ %s: %d significant correlations (p<0.05)",
                     group, tp, len(sig))
    df_sig = pd.DataFrame(all_sig)
    output_dir.mkdir(parents=True, exist_ok=True)
    if len(df_sig) == 0:
        log.warning("no significant correlations found")
        return df_sig
    df_sig.to_csv(output_dir / "significant_correlations.csv", index=False)

    if make_plots:
        from ..viz.correlation_viz import plot_correlation_scatter
        plots_dir = output_dir / "correlation_plots"
        plots_dir.mkdir(exist_ok=True)
        combos = df_sig[["sh_feature", "tract_feature",
                         "timepoint"]].drop_duplicates()
        for _, row in combos.iterrows():
            try:
                plot_correlation_scatter(df_merged, row["sh_feature"],
                                         row["tract_feature"],
                                         row["timepoint"], plots_dir)
            except Exception as e:
                log.error("failed scatter %s vs %s @ %s: %s",
                          row["sh_feature"], row["tract_feature"],
                          row["timepoint"], e)
    return df_sig


def create_summary_report(df_sig: pd.DataFrame) -> str:
    """Console summary of the strongest / most frequent correlations
    (reference :431-473), returned as a string and logged."""
    if len(df_sig) == 0:
        return "no significant correlations"
    lines = [f"total significant correlations: {len(df_sig)}", "top 10:"]
    for _, row in df_sig.nlargest(10, "r").iterrows():
        lines.append(
            f"  {row['group']} @ {row['timepoint']}: {row['sh_feature']} <-> "
            f"{row['tract_feature']} r={row['r']:.3f} p={row['p']:.4f} "
            f"n={row['n']}")
    lines.append("most frequent SH features: "
                 + ", ".join(f"{k}({v})" for k, v in
                             df_sig["sh_feature"].value_counts().head(5).items()))
    lines.append("most frequent tract features: "
                 + ", ".join(f"{k}({v})" for k, v in
                             df_sig["tract_feature"].value_counts().head(5).items()))
    report = "\n".join(lines)
    log.info("%s", report)
    return report


def run_correlation(lesion_csv: str | Path, tract_csv: str | Path,
                    output_dir: str | Path,
                    make_plots: bool = True) -> pd.DataFrame:
    """Full correlation stage (reference main(): 476-507)."""
    output_dir = Path(output_dir)
    with stage("correlate"):
        df_lesion, df_tract = load_data(lesion_csv, tract_csv)
        df_merged = merge_lesion_tract_data(df_lesion, df_tract)
        if df_merged.empty:
            log.warning("empty merged dataset — nothing to correlate")
            return pd.DataFrame()
        df_sig = analyze_correlations(df_merged, output_dir,
                                      make_plots=make_plots)
        if len(df_sig) and make_plots:
            from ..viz.correlation_viz import create_summary_heatmap
            create_summary_heatmap(df_sig, output_dir)
        create_summary_report(df_sig)
    return df_sig
