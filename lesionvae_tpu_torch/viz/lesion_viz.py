"""Group-level lesion SH visualizations (host-side, matplotlib).

Functional ports of the reference's strict-variant outputs
(src/lesion/lesion_sh_shape_descriptors.py:646-1016): same artifact names and
content, re-written for clarity.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pandas as pd

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from ..utils.logging import get_logger  # noqa: E402
from .style import DPI, apply_style  # noqa: E402

log = get_logger("lesion_viz")
apply_style()


def plot_3d_surface_comparison(surface_coords: np.ndarray,
                               reconstructed_coords: np.ndarray,
                               subject_id: str, timepoint: str,
                               output_dir: Path) -> None:
    """Side-by-side 3-D scatter of observed vs SH-reconstructed surface
    (strict-variant per-lesion artifact, lesion_sh_shape_descriptors.py:529)."""
    fig = plt.figure(figsize=(11, 5))
    for i, (pts, title) in enumerate(((surface_coords, "Observed surface"),
                                      (reconstructed_coords,
                                       "SH reconstruction"))):
        ax = fig.add_subplot(1, 2, i + 1, projection="3d")
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=2, alpha=0.5)
        ax.set_title(title)
    fig.suptitle(f"{subject_id} @ {timepoint}")
    output_dir.mkdir(parents=True, exist_ok=True)
    fig.savefig(output_dir / f"surface_comparison_{subject_id}_{timepoint}.png",
                dpi=DPI, bbox_inches="tight")
    plt.close(fig)


def plot_power_spectrum(powers_normalized: dict, subject_id: str,
                        timepoint: str, output_dir: Path) -> None:
    """Per-lesion normalized power-spectrum bar chart (strict-variant
    artifact, lesion_sh_shape_descriptors.py:532)."""
    degrees = sorted(powers_normalized)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.bar(degrees, [powers_normalized[l] for l in degrees],
           color="steelblue", edgecolor="black", alpha=0.8)
    ax.set_xlabel("Spherical Harmonic Degree (l)")
    ax.set_ylabel("Normalized Power (P_l)")
    ax.set_title(f"SH Power Spectrum: {subject_id} @ {timepoint}")
    ax.set_xticks(degrees)
    ax.grid(alpha=0.3, axis="y")
    output_dir.mkdir(parents=True, exist_ok=True)
    fig.savefig(output_dir / f"power_spectrum_{subject_id}_{timepoint}.png",
                dpi=DPI, bbox_inches="tight")
    plt.close(fig)


def compute_group_statistics(results_df: pd.DataFrame,
                             output_dir: Path) -> pd.DataFrame:
    """Mean ± SD of normalized powers per (group, timepoint) →
    group_statistics.csv (reference :646-698)."""
    power_cols = [c for c in results_df.columns
                  if c.startswith("P") and not c.endswith("_raw")]
    rows = []
    for (group, tp), g in results_df.groupby(["group", "timepoint"]):
        row = {"group": group, "timepoint": tp, "n": len(g)}
        for col in power_cols:
            row[f"{col}_mean"] = g[col].mean()
            row[f"{col}_std"] = g[col].std()
        row["reconstruction_r_mean"] = g["reconstruction_r"].mean()
        row["reconstruction_r_std"] = g["reconstruction_r"].std()
        rows.append(row)
    stats_df = pd.DataFrame(rows)
    output_dir.mkdir(parents=True, exist_ok=True)
    stats_df.to_csv(output_dir / "group_statistics.csv", index=False)
    return stats_df


def visualize_group_spectra(results_df: pd.DataFrame, stats_df: pd.DataFrame,
                            output_dir: Path) -> None:
    """Spectra-by-group errorbars, key-power heatmaps, P2/P4 temporal curves
    (reference :701-845)."""
    power_cols = [f"P{l}" for l in range(7)]
    timepoints = sorted(results_df["timepoint"].unique())
    groups = sorted(results_df["group"].unique())

    # 1) per-group spectra, one curve per timepoint
    fig, axes = plt.subplots(1, max(len(groups), 1), figsize=(7 * len(groups), 5),
                             squeeze=False)
    for ax, group in zip(axes[0], groups):
        gd = results_df[results_df["group"] == group]
        for tp in timepoints:
            td = gd[gd["timepoint"] == tp]
            if len(td) == 0:
                continue
            means = [td[c].mean() for c in power_cols]
            stds = [td[c].std() for c in power_cols]
            ax.errorbar(np.arange(7), means, yerr=stds, marker="o", label=tp,
                        capsize=4, alpha=0.75)
        ax.set_xlabel("Spherical Harmonic Degree (l)")
        ax.set_ylabel("Normalized Power (P_l)")
        ax.set_title(f"{group} (n={len(gd)})")
        ax.set_xticks(range(7))
        ax.legend()
        ax.grid(alpha=0.3)
    fig.suptitle("SH Power Spectra by Group and Timepoint")
    fig.tight_layout()
    fig.savefig(output_dir / "group_spectra_comparison.png", dpi=DPI,
                bbox_inches="tight")
    plt.close(fig)

    # 2) heatmap of key even powers
    key_powers = ["P2", "P4", "P6"]
    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    for ax, power in zip(axes, key_powers):
        pivot = results_df.pivot_table(values=power, index="timepoint",
                                       columns="group", aggfunc="mean")
        im = ax.imshow(pivot.values, cmap="viridis", aspect="auto")
        ax.set_xticks(range(len(pivot.columns)), pivot.columns)
        ax.set_yticks(range(len(pivot.index)), pivot.index)
        ax.set_title(f"{power} Power")
        fig.colorbar(im, ax=ax, label="Mean Power")
    fig.suptitle("Key SH Powers by Group and Timepoint")
    fig.tight_layout()
    fig.savefig(output_dir / "heatmap_key_powers.png", dpi=DPI,
                bbox_inches="tight")
    plt.close(fig)

    # 3) temporal evolution of P2 / P4
    fig, axes = plt.subplots(1, 2, figsize=(13, 5))
    for ax, power, label in zip(axes, ["P2", "P4"],
                                ["P2 (Ellipsoidal Deformation)",
                                 "P4 (Complex Shape Features)"]):
        for group in groups:
            means, stds, xs = [], [], []
            for i, tp in enumerate(timepoints):
                d = results_df[(results_df["group"] == group)
                               & (results_df["timepoint"] == tp)]
                if len(d):
                    means.append(d[power].mean())
                    stds.append(d[power].std())
                    xs.append(i)
            if means:
                ax.errorbar(xs, means, yerr=stds, marker="o", label=group,
                            capsize=4, linewidth=2)
        ax.set_xticks(range(len(timepoints)), timepoints)
        ax.set_xlabel("Timepoint")
        ax.set_ylabel(f"{power} Power")
        ax.set_title(f"Temporal Evolution of {label}")
        ax.legend()
        ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(output_dir / "temporal_evolution.png", dpi=DPI,
                bbox_inches="tight")
    plt.close(fig)
    log.info("group spectra figures written to %s", output_dir)


def visualize_brain_volume_analysis(results_df: pd.DataFrame,
                                    output_dir: Path) -> None:
    """Brain-volume-normalized 6-panel figure (reference :848-1016)."""
    data = results_df[results_df["brain_volume_mm3"].notna()].copy()
    if len(data) == 0:
        log.warning("no brain volume data available")
        return
    timepoints = sorted(data["timepoint"].unique())
    groups = sorted(data["group"].unique())
    colors = {"TBI": "coral", "PTE": "steelblue"}

    fig, axes = plt.subplots(2, 3, figsize=(18, 9))

    def _errorbar_panel(ax, col, scale, ylabel, title):
        for group in groups:
            means, stds = [], []
            for tp in timepoints:
                d = data[(data["group"] == group) & (data["timepoint"] == tp)]
                means.append(d[col].mean() * scale if len(d) else np.nan)
                stds.append(d[col].std() * scale if len(d) else np.nan)
            ax.errorbar(range(len(timepoints)), means, yerr=stds, marker="o",
                        label=group, capsize=4, linewidth=2)
        ax.set_xticks(range(len(timepoints)), timepoints)
        ax.set_xlabel("Timepoint")
        ax.set_ylabel(ylabel)
        ax.set_title(title)
        ax.legend()
        ax.grid(alpha=0.3)

    _errorbar_panel(axes[0, 0], "lesion_brain_ratio", 100,
                    "Lesion / Brain Volume (%)", "Lesion-to-Brain Volume Ratio")
    _errorbar_panel(axes[0, 1], "original_volume_mm3", 1,
                    "Lesion Volume (mm³)", "Absolute Lesion Volume")
    _errorbar_panel(axes[0, 2], "brain_volume_mm3", 1,
                    "Brain Volume (mm³)", "Total Brain Volume")

    ax = axes[1, 0]
    for group in groups:
        d = data[data["group"] == group]
        ax.scatter(d["brain_volume_mm3"], d["original_volume_mm3"], alpha=0.6,
                   s=60, label=group, c=colors.get(group, "gray"),
                   edgecolors="black")
    ax.set_xlabel("Brain Volume (mm³)")
    ax.set_ylabel("Lesion Volume (mm³)")
    ax.set_title("Lesion vs Brain Volume")
    ax.legend()
    ax.grid(alpha=0.3)

    ax = axes[1, 1]
    for group in groups:
        ratios = data[data["group"] == group]["lesion_brain_ratio"].dropna() * 100
        if len(ratios):
            ax.hist(ratios, bins=15, alpha=0.6, label=group,
                    color=colors.get(group, "gray"), edgecolor="black")
    ax.set_xlabel("Lesion / Brain Volume (%)")
    ax.set_ylabel("Frequency")
    ax.set_title("Distribution of Lesion-Brain Ratio")
    ax.legend()
    ax.grid(alpha=0.3, axis="y")

    ax = axes[1, 2]
    ax.axis("off")
    lines = ["BRAIN VOLUME SUMMARY", ""]
    for group in groups:
        d = data[data["group"] == group]
        lines += [
            f"{group} (n={len(d)}):",
            f"  brain:  {d['brain_volume_mm3'].mean():.0f} "
            f"± {d['brain_volume_mm3'].std():.0f} mm³",
            f"  lesion: {d['original_volume_mm3'].mean():.1f} "
            f"± {d['original_volume_mm3'].std():.1f} mm³",
            f"  ratio:  {d['lesion_brain_ratio'].mean() * 100:.2f} "
            f"± {d['lesion_brain_ratio'].std() * 100:.2f} %",
            "",
        ]
    ax.text(0.02, 0.98, "\n".join(lines), transform=ax.transAxes,
            va="top", family="monospace", fontsize=9)

    fig.suptitle("Brain-Volume-Normalized Lesion Analysis (Cleaned Lesions)")
    fig.tight_layout()
    fig.savefig(output_dir / "brain_volume_analysis.png", dpi=DPI,
                bbox_inches="tight")
    plt.close(fig)
    log.info("brain volume analysis figure written to %s", output_dir)
