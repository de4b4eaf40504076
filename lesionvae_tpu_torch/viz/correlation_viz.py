"""Correlation-stage figures (host-side matplotlib).

A copy of lesionvae_tpu/viz/correlation_viz.py (reference
src/analysis/correlation.py:186-268, :366-428): per-pair scatter with group
fit lines + stats box, RdBu heatmaps.  ``pipeline.correlation`` imports
this module only when figures are asked for."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pandas as pd

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import seaborn as sns  # noqa: E402

from ..utils.logging import get_logger  # noqa: E402
from .style import DPI, apply_style  # noqa: E402

log = get_logger("correlation_viz")
apply_style()


def plot_correlation_scatter(df: pd.DataFrame, sh_feat: str, tract_feat: str,
                             timepoint: str, output_dir: Path):
    from scipy.stats import pearsonr

    d = df[df["timepoint"] == timepoint].dropna(subset=[sh_feat, tract_feat])
    if len(d) < 3:
        return None
    fig, ax = plt.subplots(figsize=(8, 6))
    palette = sns.color_palette("muted")
    colors = {"TBI": palette[3], "PTE": palette[0]}

    stats_lines = []
    for group in ("TBI", "PTE"):
        g = d[d["group"] == group]
        if len(g) == 0:
            continue
        x = g[sh_feat].values.astype(float)
        y = g[tract_feat].values.astype(float)
        ax.scatter(x, y, s=80, alpha=0.7, color=colors[group], label=group,
                   edgecolors="black")
        if len(g) >= 3 and np.std(x) > 0:
            coef = np.polyfit(x, y, 1)
            xs = np.linspace(x.min(), x.max(), 100)
            ax.plot(xs, np.polyval(coef, xs), color=colors[group],
                    linewidth=2, alpha=0.8)
            r, p = pearsonr(x, y)
            stats_lines.append(f"{group}: r={r:.3f}, p={p:.4f}, n={len(x)}")

    if stats_lines:
        ax.text(0.05, 0.95, "\n".join(stats_lines), transform=ax.transAxes,
                va="top", fontsize=10,
                bbox=dict(boxstyle="round", facecolor="wheat", alpha=0.5))
    ax.set_xlabel(sh_feat)
    ax.set_ylabel(tract_feat)
    ax.set_title(f"{sh_feat} vs {tract_feat}\nTimepoint: {timepoint}")
    ax.legend(loc="upper right")
    fig.tight_layout()
    path = output_dir / f"corr_{sh_feat}_vs_{tract_feat}_{timepoint}.png"
    fig.savefig(path, dpi=DPI, bbox_inches="tight")
    plt.close(fig)
    return path


def create_summary_heatmap(df_sig: pd.DataFrame, output_dir: Path) -> None:
    if len(df_sig) == 0:
        return
    for tp in sorted(df_sig["timepoint"].unique()):
        for group in ("TBI", "PTE"):
            g = df_sig[(df_sig["timepoint"] == tp)
                       & (df_sig["group"] == group)]
            if len(g) == 0:
                continue
            pivot = g.pivot_table(values="r", index="sh_feature",
                                  columns="tract_feature", aggfunc="first")
            if pivot.empty:
                continue
            fig, ax = plt.subplots(figsize=(12, 6))
            sns.heatmap(pivot, annot=True, fmt=".2f", cmap="RdBu_r",
                        center=0, vmin=-1, vmax=1, linewidths=0.5,
                        linecolor="gray", cbar_kws={"label": "Pearson r"},
                        ax=ax)
            ax.set_xlabel("Tract Geometry Features")
            ax.set_ylabel("Lesion SH Descriptors")
            ax.set_title(f"Significant Correlations: {group} at {tp}\n"
                         "(p < 0.05 uncorrected)")
            fig.tight_layout()
            fig.savefig(output_dir / f"correlation_heatmap_{group}_{tp}.png",
                        dpi=DPI, bbox_inches="tight")
            plt.close(fig)
            log.info("heatmap saved for %s @ %s", group, tp)
