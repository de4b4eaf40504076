"""Classification-stage figures (host-side matplotlib).

A copy of lesionvae_tpu/viz/classify_viz.py (reference
src/analysis/classification.py:211-460, :543-608): ROC/AUC/sens-spec/confusion
grid, top-predictor bars, boxplots with jitter, temporal trends, centroid
displacement panels.  ``pipeline.classification`` imports this module only
when figures are asked for."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import numpy as np
import pandas as pd

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import seaborn as sns  # noqa: E402

from ..utils.logging import get_logger  # noqa: E402
from .style import DPI, apply_style  # noqa: E402

log = get_logger("classify_viz")
apply_style()
TP_ORDER = {"2d": 0, "9d": 1, "1mo": 2, "5mo": 3}
GROUP_COLOR = {"TBI": "coral", "PTE": "steelblue"}


def plot_classification_results(results: Dict, timepoint: str,
                                output_dir: Path) -> None:
    fig, axes = plt.subplots(2, 3, figsize=(16, 10))
    fig.suptitle(f"TBI vs PTE Classification Results - {timepoint}",
                 fontweight="bold")
    models = list(results)

    ax = axes[0, 0]
    for name in models:
        r = results[name]
        ax.plot(r["fpr"], r["tpr"], linewidth=2,
                label=f"{name} (AUC={r['auc']:.3f})")
    ax.plot([0, 1], [0, 1], "k--", linewidth=1, label="Chance")
    ax.set_xlabel("False Positive Rate")
    ax.set_ylabel("True Positive Rate")
    ax.set_title("ROC Curves")
    ax.legend()
    ax.grid(alpha=0.3)

    ax = axes[0, 1]
    aucs = [results[m]["auc"] for m in models]
    bars = ax.bar(models, aucs,
                  color=["steelblue", "coral", "mediumseagreen"],
                  edgecolor="black", alpha=0.7)
    for bar, a in zip(bars, aucs):
        ax.text(bar.get_x() + bar.get_width() / 2, bar.get_height(),
                f"{a:.3f}", ha="center", va="bottom")
    ax.axhline(0.5, color="red", linestyle="--", label="Chance")
    ax.set_ylim(0, 1)
    ax.set_ylabel("AUC")
    ax.set_title("AUC Comparison")
    ax.legend()
    ax.tick_params(axis="x", rotation=45)

    ax = axes[0, 2]
    xs = np.arange(len(models))
    ax.bar(xs - 0.18, [results[m]["sensitivity"] for m in models], 0.36,
           label="Sensitivity", color="steelblue", edgecolor="black",
           alpha=0.7)
    ax.bar(xs + 0.18, [results[m]["specificity"] for m in models], 0.36,
           label="Specificity", color="coral", edgecolor="black", alpha=0.7)
    ax.set_xticks(xs, models, rotation=45, ha="right")
    ax.set_ylim(0, 1)
    ax.set_title("Sensitivity and Specificity")
    ax.legend()

    for idx, name in enumerate(models):
        ax = axes[1, idx]
        cm = results[name]["confusion_matrix"].astype(float)
        cm_norm = cm / np.maximum(cm.sum(axis=1, keepdims=True), 1)
        sns.heatmap(cm_norm, annot=True, fmt=".2f", cmap="Blues",
                    xticklabels=["TBI", "PTE"], yticklabels=["TBI", "PTE"],
                    ax=ax, cbar_kws={"label": "Proportion"})
        ax.set_xlabel("Predicted Label")
        ax.set_ylabel("True Label")
        ax.set_title(f"{name}\nConfusion Matrix")

    fig.tight_layout()
    fig.savefig(output_dir / f"classification_results_{timepoint}.png",
                dpi=DPI, bbox_inches="tight")
    plt.close(fig)


def plot_top_predictors(importance: np.ndarray, feature_names: List[str],
                        timepoint: str, output_dir: Path,
                        top_n: int = 10) -> List[str]:
    order = np.argsort(importance)[-top_n:][::-1]
    names = [feature_names[i] for i in order]
    vals = importance[order]

    fig, ax = plt.subplots(figsize=(9, 5))
    ax.barh(range(len(names)), vals, color="steelblue", edgecolor="black",
            alpha=0.7)
    for i, v in enumerate(vals):
        ax.text(v, i, f"{v:.4f}", va="center")
    ax.set_yticks(range(len(names)), names)
    ax.invert_yaxis()
    ax.set_xlabel("Feature Importance")
    ax.set_title(f"Top {top_n} Predictors - {timepoint}")
    ax.grid(alpha=0.3, axis="x")
    fig.tight_layout()
    fig.savefig(output_dir / f"top_predictors_{timepoint}.png", dpi=DPI,
                bbox_inches="tight")
    plt.close(fig)
    return names


def plot_top_predictor_boxplots(df: pd.DataFrame, timepoint: str,
                                top_features: List[str],
                                output_dir: Path) -> None:
    df_tp = df[df["timepoint"] == timepoint]
    agg = {f: "mean" for f in top_features}
    agg["group"] = "first"
    subj = df_tp.groupby("subject_id").agg(agg).reset_index()

    n = len(top_features)
    ncols, nrows = 3, int(np.ceil(n / 3))
    fig, axes = plt.subplots(nrows, ncols, figsize=(13, 4 * nrows),
                             squeeze=False)
    for i, feat in enumerate(top_features):
        ax = axes[i // ncols][i % ncols]
        sns.boxplot(data=subj, x="group", y=feat, hue="group",
                    palette=GROUP_COLOR, width=0.5, ax=ax, legend=False)
        sns.stripplot(data=subj, x="group", y=feat, color="black", alpha=0.4,
                      size=4, jitter=True, ax=ax)
        tbi_n = (subj["group"] == "TBI").sum()
        pte_n = (subj["group"] == "PTE").sum()
        ax.text(0.02, 0.98, f"TBI n={tbi_n}\nPTE n={pte_n}",
                transform=ax.transAxes, va="top", fontsize=8,
                bbox=dict(boxstyle="round", facecolor="wheat", alpha=0.3))
        ax.set_title(f"{feat} - {timepoint}")
        ax.grid(alpha=0.3, axis="y")
    for i in range(n, nrows * ncols):
        axes[i // ncols][i % ncols].set_visible(False)
    fig.suptitle(f"Top Predictors: TBI vs PTE - {timepoint}")
    fig.tight_layout()
    fig.savefig(output_dir / f"top_predictors_boxplots_{timepoint}.png",
                dpi=DPI, bbox_inches="tight")
    plt.close(fig)


def plot_temporal_trends(df: pd.DataFrame, feature_cols: List[str],
                         timepoints: List[str], output_dir: Path) -> None:
    frames = []
    for tp in timepoints:
        df_tp = df[df["timepoint"] == tp]
        agg = {f: "mean" for f in feature_cols}
        agg["group"] = "first"
        s = df_tp.groupby("subject_id").agg(agg).reset_index()
        s["timepoint"] = tp
        frames.append(s)
    temporal = pd.concat(frames, ignore_index=True)

    key_metrics = [m for m in ["length_mean", "tortuosity_mean",
                               "curv_mean_avg", "elongation_ratio_mean",
                               "planarity_ratio_mean"] if m in feature_cols]
    ncols, nrows = 3, int(np.ceil(len(key_metrics) / 3))
    fig, axes = plt.subplots(nrows, ncols, figsize=(13, 4 * nrows),
                             squeeze=False)
    for i, metric in enumerate(key_metrics):
        ax = axes[i // ncols][i % ncols]
        grouped = temporal.groupby(["timepoint", "group"])[metric].agg(
            ["mean", "sem"]).reset_index()
        for group in ("TBI", "PTE"):
            g = grouped[grouped["group"] == group]
            xs = [TP_ORDER[t] for t in g["timepoint"]]
            ax.plot(xs, g["mean"], marker="o", linewidth=2, label=group,
                    color=GROUP_COLOR[group])
            ax.fill_between(xs, g["mean"] - g["sem"], g["mean"] + g["sem"],
                            alpha=0.2, color=GROUP_COLOR[group])
        ax.set_xticks(range(4), timepoints)
        ax.set_title(f"{metric} Over Time")
        ax.legend()
        ax.grid(alpha=0.3)
    for i in range(len(key_metrics), nrows * ncols):
        axes[i // ncols][i % ncols].set_visible(False)
    fig.suptitle("Temporal Trends: TBI vs PTE")
    fig.tight_layout()
    fig.savefig(output_dir / "temporal_trends_tbi_vs_pte.png", dpi=DPI,
                bbox_inches="tight")
    plt.close(fig)


def plot_centroid_displacement(disp: pd.DataFrame, timepoints: List[str],
                               output_dir: Path) -> None:
    fig, axes = plt.subplots(1, 2, figsize=(14, 5))

    ax = axes[0]
    grouped = disp.groupby(["timepoint", "group"])["displacement_mm"].agg(
        ["mean", "sem"]).reset_index()
    for group in ("TBI", "PTE"):
        g = grouped[grouped["group"] == group]
        xs = [TP_ORDER[t] for t in g["timepoint"]]
        ax.plot(xs, g["mean"], marker="o", linewidth=2, label=group,
                color=GROUP_COLOR[group])
        ax.fill_between(xs, g["mean"] - g["sem"], g["mean"] + g["sem"],
                        alpha=0.2, color=GROUP_COLOR[group])
    ax.set_xticks(range(4), timepoints)
    ax.set_xlabel("Timepoint")
    ax.set_ylabel("Displacement from 2d Baseline (mm)")
    ax.set_title("Mean Centroid Displacement Over Time")
    ax.legend()
    ax.grid(alpha=0.3)

    ax = axes[1]
    d5 = disp[disp["timepoint"] == "5mo"]
    dirs, labels = ["dx", "dy", "dz"], ["X (L-R)", "Y (P-A)", "Z (I-S)"]
    xs = np.arange(3)
    for group in ("TBI", "PTE"):
        g = d5[d5["group"] == group]
        means = [g[d].mean() for d in dirs]
        sems = [g[d].sem() for d in dirs]
        off = 0.18 if group == "PTE" else -0.18
        ax.bar(xs + off, means, 0.36, yerr=sems, label=group,
               color=GROUP_COLOR[group], edgecolor="black", alpha=0.7,
               capsize=4)
    ax.set_xticks(xs, labels)
    ax.axhline(0, color="black", linestyle="--", linewidth=1)
    ax.set_ylabel("Displacement from Baseline (mm)")
    ax.set_title("Directional Displacement at 5mo")
    ax.legend()
    ax.grid(alpha=0.3, axis="y")

    fig.suptitle("Within-Subject Centroid Displacement Analysis")
    fig.tight_layout()
    fig.savefig(output_dir / "centroid_displacement_analysis.png", dpi=DPI,
                bbox_inches="tight")
    plt.close(fig)
    log.info("centroid displacement figure written")
